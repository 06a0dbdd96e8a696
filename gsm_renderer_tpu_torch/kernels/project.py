"""Fused projection: project + cull + quantize + pack in one pass, mono and
dual-eye (side-by-side stereo).

Port of ``gsm_renderer_tpu/kernels/project.py`` (``project_and_cull_packed``
with the Pallas ``_project_kernel``, and ``stereo_project_and_cull_packed``
with ``_stereo_project_kernel``).  The kernels are ``csrc/project.cu``; they
also fold in the JAX versions' XLA theta epilogues (atan2 and the u16
packing), so one launch yields the finished record words.

Both projections take tiles of 1 to 4096 pixels a side
(``expand.check_tile``; the renderers use 16x16 and the Global renderer's
32x16).  The tile rect multiplies by the float32 reciprocal of each side
(:func:`mathlib.compute_tile_bounds_c`), as the jitted JAX reference
rounds its division by the static side.  The mono projection with ``depth_key16`` emits the 16-bit
half-depth key of the Global, Local and 16-bit-key DepthFirst frames in
place of the 32-bit depth word: :func:`mathlib.half_key16` of the record's
quantized f16 depth bits, and 0xFFFFFFFF where culled (a KeyPlan, if
given, is then not applied, as in JAX).

:func:`project_plain` and :func:`stereo_project_plain` are the same
functions in plain PyTorch, operation for operation.  The dispatchers run
them for CPU tensors and the CUDA kernels for CUDA tensors; there is no
fallback between the two.

The camera reaches the kernels by value, as a pose block (``ProjParams``,
and for two eyes both eyes' and ``StereoExtra``, in ``csrc/project.cu``):
the view and projection matrices, the centre and the frame constants,
packed on the host by :func:`pose_block` / :func:`stereo_pose_block`.  A
frame captured into a CUDA graph (``pipelines/replay.py``) replays with the
pose block that :func:`set_pose` writes into the graph's projection node
(:func:`find_pose_node`) before each launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time

import numpy as np
import torch

from .. import _native
from .. import mathlib as M
from .. import profiling
from ..ops.binning import pack_rect_word
from .expand import CULLED_BIT, check_tile

PROJECT = _native.Kernel("project", "project", "gsm_project", [
    _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.P])
STEREO_PROJECT = _native.Kernel("stereo_project", "project",
                                "gsm_stereo_project", [
                                    _native.P, _native.P, _native.P, _native.P,
                                    _native.P, _native.P, _native.P, _native.P])

#: mean of an eye's record where that eye does not see the gaussian: the
#: largest finite off-screen offset, so its alpha underflows to exactly 0
INVISIBLE_MEAN = -6e4

_PARAM_NAMES = ("near_plane", "far_plane", "half_w", "half_h",
                "alpha_threshold", "lim_x", "lim_y", "focal_x", "focal_y",
                "max_eig", "width", "height", "wm1", "hm1", "ink_threshold",
                "ink_af", "ink_den", "tau", "theta_scale", "pi", "inv255")


@dataclasses.dataclass
class PackedProjection:
    """Per-gaussian packed projection outputs (int32 tensors holding u32
    bits): ``rect_word`` (min_tx | min_ty << 10 | rect_w << 20, CULLED_BIT
    for invisible gaussians), ``rect_h``, ``dsw`` (KeyPlan-normalized depth
    word), ``words`` (the 4 record words, theta merged into w1), and
    ``visible`` (bool)."""

    rect_word: torch.Tensor
    rect_h: torch.Tensor
    dsw: torch.Tensor
    words: list
    visible: torch.Tensor


@dataclasses.dataclass
class StereoPackedProjection:
    """Dual-eye packed projection outputs: the union rect word (CULLED_BIT
    for gaussians neither eye sees), ``rect_h``, the KeyPlan-normalized
    depth word of the eyes' mean depth, 8 record words (left w0..w3, right
    w0..w3; w3 shared), ``visible`` (bool, either eye), and the union pixel
    bounds ``px_min``, ``px_max``, ``py_min``, ``py_max`` (float32, 0 where
    invisible)."""

    rect_word: torch.Tensor
    rect_h: torch.Tensor
    dsw: torch.Tensor
    words: list
    visible: torch.Tensor
    px_min: torch.Tensor
    px_max: torch.Tensor
    py_min: torch.Tensor
    py_max: torch.Tensor


def prepare_projection_inputs(gi, sh_degree: int):
    """(comp (11, N) f32, harm (3 * n_coeffs, N) f32): the component planes
    and the SH coefficient planes of the used degree, contiguous."""
    comp = torch.stack([
        gi.positions[:, 0], gi.positions[:, 1], gi.positions[:, 2],
        gi.scales[:, 0], gi.scales[:, 1], gi.scales[:, 2],
        gi.rotations[:, 0], gi.rotations[:, 1], gi.rotations[:, 2],
        gi.rotations[:, 3], gi.opacities]).to(torch.float32).contiguous()
    n_coeffs = (sh_degree + 1) ** 2
    harm = gi.harmonics[:, :n_coeffs, :].to(torch.float32)
    harm = harm.reshape(3 * n_coeffs, gi.count).contiguous()
    return comp, harm


def cached_projection_inputs(gi, sh_degree: int):
    """Per-input cache of :func:`prepare_projection_inputs`, stored on the
    GaussianInput (the inputs do not change between frames).  A miss waits
    for its device work and adds its seconds to the set-up timer
    ``projection_cache_s`` of ``profiling.counters()``."""
    cache = gi.__dict__.setdefault("_proj_prep", {})
    got = cache.get(sh_degree)
    if got is None:
        t0 = time.perf_counter()
        got = prepare_projection_inputs(gi, sh_degree)
        if gi.device.type == "cuda":
            torch.cuda.synchronize(gi.device)
        profiling.add_setup("projection_cache_s", time.perf_counter() - t0)
        cache[sh_degree] = got
    return got


def frame_constants(proj, *, width, height, near_plane,
                    far_plane, alpha_threshold, total_ink_threshold):
    """Float32 frame constants shared by the kernel and the plain version,
    each rounded to float32 the way JAX folds it."""
    lim_x, lim_y, focal_x, focal_y = M.covariance_2d_consts(
        M.mat(proj), width, height)
    af, den = M.depth_factor_consts(near_plane, far_plane)
    c = dict(
        near_plane=M.f32(near_plane), far_plane=M.f32(far_plane),
        half_w=M.f32(0.5 * width), half_h=M.f32(0.5 * height),
        alpha_threshold=M.f32(alpha_threshold), lim_x=lim_x, lim_y=lim_y,
        focal_x=focal_x, focal_y=focal_y,
        max_eig=M.max_eigenvalue(width, height),
        width=M.f32(width), height=M.f32(height),
        wm1=M.f32(width - 1.0), hm1=M.f32(height - 1.0),
        ink_threshold=M.f32(total_ink_threshold), ink_af=af, ink_den=den,
        tau=M.f32(max(alpha_threshold, 1e-12)),
        theta_scale=M.f32(65535.0 / M.PI), pi=M.f32(M.PI),
        inv255=M.f32(1.0 / 255.0))
    return c


@functools.lru_cache(maxsize=16)
def _constants_row(proj: bytes, width, height, near_plane, far_plane,
                   alpha_threshold, total_ink_threshold):
    """:func:`frame_constants` of the (4, 4) float32 projection ``proj``
    (its bytes) as a float32 row in ``_PARAM_NAMES`` order; read-only.
    Cached: a viewer's projection and size rarely change between frames,
    its view every frame."""
    k = frame_constants(np.frombuffer(proj, np.float32).reshape(4, 4),
                        width=width, height=height, near_plane=near_plane,
                        far_plane=far_plane, alpha_threshold=alpha_threshold,
                        total_ink_threshold=total_ink_threshold)
    row = np.asarray([k[name] for name in _PARAM_NAMES], np.float32)
    row.flags.writeable = False
    return row


def pose_block(view, proj, center, *, width, height, near_plane, far_plane,
               alpha_threshold, total_ink_threshold):
    """The mono projection's pose block (``csrc/project.cu``'s ProjParams),
    float32: the (4, 4) view and projection matrices row-major, the (3,)
    centre, then :func:`frame_constants` in the struct's order."""
    proj = np.ascontiguousarray(proj, np.float32)
    return np.concatenate([
        np.asarray(view, np.float32).reshape(-1), proj.reshape(-1),
        np.asarray(center, np.float32).reshape(-1),
        _constants_row(proj.tobytes(), width, height, near_plane, far_plane,
                       alpha_threshold, total_ink_threshold)])


def stereo_pose_block(views, projs, centers, scene_transform, *, width,
                      height, near_plane, far_plane, alpha_threshold,
                      total_ink_threshold):
    """The dual-eye projection's pose block, float32: each eye's
    :func:`pose_block`, left first, then ``csrc/project.cu``'s StereoExtra:
    the (4, 4) scene transform row-major, the scene scale and the mid
    camera centre (:func:`stereo_constants`)."""
    consts = dict(width=width, height=height, near_plane=near_plane,
                  far_plane=far_plane, alpha_threshold=alpha_threshold,
                  total_ink_threshold=total_ink_threshold)
    scene_scale, mid = stereo_constants(centers, scene_transform)
    return np.concatenate([
        *(pose_block(views[e], projs[e], centers[e], **consts)
          for e in range(2)),
        np.asarray(scene_transform, np.float32).reshape(-1),
        np.asarray([scene_scale], np.float32), mid.reshape(-1)])


def find_pose_node(graph: int, stereo: bool):
    """The projection kernel node of a captured frame's CUDA graph
    (``graph``: its ``cudaGraph_t``, which the node reads and must outlive):
    an opaque buffer for :func:`set_pose`.  Raises RuntimeError unless the
    graph holds exactly one launch of the mono (``stereo`` False) or the
    dual-eye projection."""
    size = _native.c_entry("project", "gsm_pose_node_bytes", ctypes.c_size_t,
                           ())
    node = ctypes.create_string_buffer(size())
    err = _native.c_entry("project", "gsm_pose_node", argtypes=(
        _native.P, _native.I, _native.P))(graph, int(stereo), node)
    if err != 0:
        raise RuntimeError(f"gsm_pose_node: CUDA error {err}: the graph has "
                           "no single projection launch")
    return node


def set_pose(graph_exec: int, node, pose) -> None:
    """Write the host pose block ``pose`` (:func:`pose_block`, or
    :func:`stereo_pose_block` for a dual-eye node) into the projection node
    ``node`` of the instantiated graph ``graph_exec`` (its
    ``cudaGraphExec_t``) for its next launches; launches already queued
    keep theirs.  Waits for nothing on the device."""
    pose = np.ascontiguousarray(pose, np.float32)
    err = _native.c_entry("project", "gsm_set_pose")(graph_exec, node,
                                                     pose.ctypes.data)
    if err != 0:
        raise RuntimeError(f"gsm_set_pose: CUDA error {err}")


def f32_to_f16_bits(v):
    """Manual f32 -> f16 bit conversion with IEEE round-to-nearest-even
    (subnormals via the float-add trick, overflow -> inf, NaN -> 0x7E00);
    returns int64 holding the 16 bits."""
    bits = M.u32(v.contiguous().view(torch.int32))
    sign = (bits >> 16) & 0x8000
    f = bits & 0x7FFFFFFF
    is_nan = f > 0x7F800000
    is_big = f >= 0x47800000
    big = torch.where(is_nan, 0x7E00, 0x7C00)
    is_small = f < (113 << 23)
    fv = M.to_i32(f).view(torch.float32)
    sub = (M.u32((fv + 0.5).view(torch.int32)) - 0x3F000000) & M.U32
    mant_odd = (f >> 13) & 1
    fn = (f + ((((15 - 127) << 23) + 0xFFF) & M.U32) + mant_odd) & M.U32
    h = torch.where(is_small, sub, fn >> 13)
    h = torch.where(is_big, big, h)
    return (sign | h) & 0xFFFF


def _sh_color(harm, px, py, pz, cen, sh_degree: int, input_is_srgb: bool):
    """SH colour seen from the centre ``cen`` (3 floats), + 0.5, clamped at
    0, optionally sRGB-decoded: 3 (N,) tensors."""
    n_coeffs = (sh_degree + 1) ** 2
    if sh_degree == 0:
        color = [harm[ch * n_coeffs] * M.SH_C0 for ch in range(3)]
    else:
        dx = cen[0] - px
        dy = cen[1] - py
        dz = cen[2] - pz
        inv = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
        basis = M.sh_basis_c(dx * inv, dy * inv, dz * inv, sh_degree)
        color = []
        for ch in range(3):
            acc = harm[ch * n_coeffs] * basis[0]
            for c in range(1, n_coeffs):
                acc = acc + harm[ch * n_coeffs + c] * basis[c]
            color.append(acc)
    color = [torch.clamp(c + 0.5, min=0.0) for c in color]
    if input_is_srgb:
        color = [torch.where(c <= 0.04045, M.div(c, 12.92),
                             torch.pow(M.div(torch.clamp(c, 0.0, 1.0) + 0.055,
                                             1.055), 2.4))
                 for c in (torch.clamp(c, 0.0, 1.0) for c in color)]
    return color


def _theta_u16(evx, evy, k, visible=None):
    """The JAX theta epilogue: atan2, mod pi, (zero where not ``visible``),
    mod pi, packed to u16 (int64)."""
    theta = torch.atan2(evy, evx)
    theta = M.jmod(theta, k["pi"])
    theta = torch.where(theta >= k["pi"], theta - k["pi"], theta)
    if visible is not None:
        theta = torch.where(visible, theta, 0.0)
    t = M.jmod(theta, k["pi"])
    t = torch.where(t < 0.0, t + k["pi"], t)
    return torch.clamp(t * k["theta_scale"] + 0.5, 0.0, 65535.0).to(
        torch.int32).to(torch.int64)


def _u8(c):
    return torch.clamp(c * 255.0, 0.0, 255.0).to(torch.int32).to(torch.int64)


def _depth_word(depth, alive, key_plan):
    """Sortable depth word, KeyPlan-normalized (culled at the span)."""
    dkey = torch.where(alive, M.float_to_sortable_uint(depth), M.U32)
    if key_plan is None:
        return dkey
    return torch.where(alive, key_plan.normalize(dkey), key_plan.span)


def project_plain(comp, harm, view, proj, center, *, width: int, height: int,
                  tile_w: int, tile_h: int, sh_degree: int, near_plane: float,
                  far_plane: float, alpha_threshold: float,
                  total_ink_threshold: float, input_is_srgb: bool,
                  key_plan=None, depth_key16: bool = False) -> PackedProjection:
    """Plain PyTorch version of the projection kernel, on any device."""
    check_tile(tile_w, tile_h, "projection")
    view_m, proj_m, cen = M.mat(view), M.mat(proj), M.mat(center)
    k = frame_constants(proj, width=width, height=height,
                        near_plane=near_plane, far_plane=far_plane,
                        alpha_threshold=alpha_threshold,
                        total_ink_threshold=total_ink_threshold)
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    px, py, pz, sx, sy, sz = (comp[j] for j in range(6))
    opacity = comp[10]

    alive = ~M.cull_by_scale_c(sx, sy, sz)
    vx, vy, vz, nx, ny, depth, in_front = M.project_points_c(
        px, py, pz, view_m, proj_m, k["near_plane"])
    alive &= in_front
    alive &= ~M.cull_by_far_plane(depth, k["far_plane"])
    screen_x = (nx + 1.0) * k["half_w"]
    screen_y = (ny + 1.0) * k["half_h"]
    alive &= opacity >= k["alpha_threshold"]

    c3d = M.build_covariance_3d_c(sx, sy, sz, comp[6], comp[7], comp[8],
                                  comp[9])
    ca, cb, cd = M.project_covariance_2d_c(c3d, vx, vy, vz, view_m, proj_m,
                                           float(width), float(height))
    ca, cb, cd = M.stabilize_covariance_2d_c(ca, cb, cd, float(width),
                                             float(height))
    evx, evy, sigma1, sigma2, eig_ok = M.major_axis_sigmas_c(ca, cb, cd)
    alive &= eig_ok

    radius = 3.0 * torch.maximum(sigma1, sigma2)
    alive &= ~M.cull_by_radius(radius)
    det2d = ca * cd - cb * cb
    alive &= ~M.cull_by_total_ink(opacity, det2d, depth, near_plane,
                                  far_plane, total_ink_threshold)
    obb_x, obb_y = M.compute_obb_extents_c(ca, cb, cd, 3.0)
    alive &= ~M.cull_by_screen_bounds_c(screen_x, screen_y, obb_x, obb_y,
                                        k["width"], k["height"])

    color = _sh_color(harm, px, py, pz, cen, sh_degree, input_is_srgb)
    w0 = f32_to_f16_bits(screen_x) | (f32_to_f16_bits(screen_y) << 16)
    w1 = _theta_u16(evx, evy, k) | (f32_to_f16_bits(sigma1) << 16)
    w2 = f32_to_f16_bits(sigma2) | (f32_to_f16_bits(depth) << 16)
    op_u8 = _u8(opacity)
    w3 = (_u8(color[0]) | (_u8(color[1]) << 8) | (_u8(color[2]) << 16)
          | (op_u8 << 24))

    min_tx, max_tx, min_ty, max_ty = M.compute_tile_bounds_c(
        screen_x, screen_y, obb_x, obb_y, k["width"], k["height"], tile_w,
        tile_h, tiles_x, tiles_y)
    alive &= (min_tx <= max_tx) & (min_ty <= max_ty)
    opacity_q = op_u8.to(torch.int32).to(torch.float32) * k["inv255"]
    alive &= M.compute_d2_cutoff(opacity_q, k["tau"]) >= 0.0

    min_tx = torch.where(alive, min_tx, 0)
    min_ty = torch.where(alive, min_ty, 0)
    rect_w = torch.where(alive, max_tx - min_tx + 1, 1)
    rect_h = torch.where(alive, max_ty - min_ty + 1, 1).to(torch.int32)

    rw = M.u32(pack_rect_word(min_tx, min_ty, rect_w))
    rw = torch.where(alive, rw, rw | CULLED_BIT)
    if depth_key16:
        dsw = torch.where(alive, M.half_key16(w2 >> 16), M.U32)
    else:
        dsw = _depth_word(depth, alive, key_plan)
    return PackedProjection(
        rect_word=M.to_i32(rw), rect_h=rect_h, dsw=M.to_i32(dsw),
        words=[M.to_i32(w) for w in (w0, w1, w2, w3)], visible=alive)


def project_cuda(comp, harm, view, proj, center, *, width: int, height: int,
                 tile_w: int, tile_h: int, sh_degree: int, near_plane: float,
                 far_plane: float, alpha_threshold: float,
                 total_ink_threshold: float, input_is_srgb: bool,
                 key_plan=None, depth_key16: bool = False) -> PackedProjection:
    """Launch ``csrc/project.cu`` on CUDA tensors."""
    check_tile(tile_w, tile_h, "projection")
    dev = comp.device
    n = comp.shape[1]
    n_coeffs = (sh_degree + 1) ** 2
    _native.check(comp, "comp", torch.float32, (11, n), dev)
    _native.check(harm, "harm", torch.float32, (3 * n_coeffs, n), dev)
    params = pose_block(view, proj, center, width=width, height=height,
                        near_plane=near_plane, far_plane=far_plane,
                        alpha_threshold=alpha_threshold,
                        total_ink_threshold=total_ink_threshold)
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    ints = np.asarray([n, tiles_x, tiles_y, sh_degree, int(input_is_srgb),
                       int(key_plan is not None), tile_w, int(depth_key16),
                       tile_h], np.int32)
    plan = np.asarray([key_plan.near_key, key_plan.span] if key_plan else [0, 0],
                      np.uint32)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(7)]
    visible = torch.empty(n, dtype=torch.bool, device=dev)
    PROJECT.launch(
        _native.ptr(comp), _native.ptr(harm),
        params.ctypes.data_as(ctypes.c_void_p),
        ints.ctypes.data_as(ctypes.c_void_p),
        plan.ctypes.data_as(ctypes.c_void_p),
        *[_native.ptr(o) for o in outs], _native.ptr(visible))
    rect_word, rect_h, dsw, w0, w1, w2, w3 = outs
    return PackedProjection(rect_word=rect_word, rect_h=rect_h, dsw=dsw,
                            words=[w0, w1, w2, w3], visible=visible)


def project_and_cull_packed(gi, view, proj, center, *, prepared=None,
                            **kw) -> PackedProjection:
    """Fused projection of a GaussianInput: the CUDA kernel for inputs on
    the card, the plain version for inputs on the CPU.  ``view``/``proj``
    (4, 4) and ``center`` (3,) are host arrays; ``prepared`` is an optional
    (comp, harm) from :func:`cached_projection_inputs`."""
    comp, harm = (prepared if prepared is not None
                  else prepare_projection_inputs(gi, kw["sh_degree"]))
    if comp.is_cuda:
        return project_cuda(comp, harm, view, proj, center, **kw)
    return project_plain(comp, harm, view, proj, center, **kw)


# ---------------------------------------------------------------------------
# Kernel 6: dual-eye (side-by-side stereo) projection
# ---------------------------------------------------------------------------

def stereo_constants(centers, scene_transform):
    """(scene_scale, mid): |scene_transform[:3, 0]| and the mid camera
    centre, in float32 as the JAX wrapper computes them."""
    st = np.asarray(scene_transform, np.float32)
    col = st[:3, 0]
    scale = np.sqrt(col[0] * col[0] + col[1] * col[1] + col[2] * col[2])
    c = np.asarray(centers, np.float32)
    return np.float32(scale), np.float32(0.5) * (c[0] + c[1])


def _eye_chain(px, py, pz, c3d, view, proj, *, width, height, tile_w, tile_h,
               near_plane, far_plane):
    """One eye's projection chain (the JAX ``_eye_chain``)."""
    view_m, proj_m = M.mat(view), M.mat(proj)
    k = frame_constants(proj, width=width, height=height,
                        near_plane=near_plane, far_plane=far_plane,
                        alpha_threshold=0.0, total_ink_threshold=0.0)
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    vx, vy, vz, nx, ny, depth, in_front = M.project_points_c(
        px, py, pz, view_m, proj_m, k["near_plane"])
    ok = in_front & ~M.cull_by_far_plane(depth, k["far_plane"])
    screen_x = (nx + 1.0) * k["half_w"]
    screen_y = (ny + 1.0) * k["half_h"]
    ca, cb, cd = M.project_covariance_2d_c(c3d, vx, vy, vz, view_m, proj_m,
                                           float(width), float(height))
    ca, cb, cd = M.stabilize_covariance_2d_c(ca, cb, cd, float(width),
                                             float(height))
    evx, evy, sigma1, sigma2, eig_ok = M.major_axis_sigmas_c(ca, cb, cd)
    ok &= eig_ok
    det2d = ca * cd - cb * cb
    ok &= ~M.cull_by_radius(3.0 * torch.maximum(sigma1, sigma2))
    obb_x, obb_y = M.compute_obb_extents_c(ca, cb, cd, 3.0)
    ok &= ~M.cull_by_screen_bounds_c(screen_x, screen_y, obb_x, obb_y,
                                     k["width"], k["height"])
    min_tx, max_tx, min_ty, max_ty = M.compute_tile_bounds_c(
        screen_x, screen_y, obb_x, obb_y, k["width"], k["height"], tile_w,
        tile_h, tiles_x, tiles_y)
    ok &= (min_tx <= max_tx) & (min_ty <= max_ty)
    return dict(screen_x=screen_x, screen_y=screen_y, depth=depth, evx=evx,
                evy=evy, sigma1=sigma1, sigma2=sigma2, det=det2d, visible=ok,
                min_tx=min_tx, max_tx=max_tx, min_ty=min_ty, max_ty=max_ty,
                px_min=torch.clamp(screen_x - obb_x, 0.0, k["width"]),
                px_max=torch.clamp(screen_x + obb_x, 0.0, k["width"]),
                py_min=torch.clamp(screen_y - obb_y, 0.0, k["height"]),
                py_max=torch.clamp(screen_y + obb_y, 0.0, k["height"]), k=k)


def stereo_project_plain(comp, harm, views, projs, centers, scene_transform,
                         *, width: int, height: int, tile_w: int, tile_h: int,
                         sh_degree: int, near_plane: float, far_plane: float,
                         alpha_threshold: float, total_ink_threshold: float,
                         input_is_srgb: bool,
                         key_plan=None) -> StereoPackedProjection:
    """Plain PyTorch version of the stereo projection kernel, on any device.
    ``views`` / ``projs`` (2, 4, 4), ``centers`` (2, 3) and
    ``scene_transform`` (4, 4) are host arrays.

    Both eyes' chains run on the gaussians moved by ``scene_transform``
    (scales times its first column's length); a gaussian is visible if
    either eye sees it and it survives the total-ink cull at the eyes' mean
    depth (larger covariance determinant).  SH colour is taken from the mid
    camera; the tile rect is the union of the eyes' rects."""
    check_tile(tile_w, tile_h, "projection")
    scene_scale, mid = stereo_constants(centers, scene_transform)
    st = M.mat(scene_transform)
    px0, py0, pz0, sx, sy, sz = (comp[j] for j in range(6))
    opacity = comp[10]
    shared_ok = ~M.cull_by_scale_c(sx, sy, sz)
    shared_ok &= opacity >= M.f32(alpha_threshold)
    px, py, pz, _w = M.apply_mat4_c(st, px0, py0, pz0)
    sc = float(scene_scale)
    c3d = M.build_covariance_3d_c(sx * sc, sy * sc, sz * sc, comp[6], comp[7],
                                  comp[8], comp[9])
    eyes = [_eye_chain(px, py, pz, c3d, views[e], projs[e], width=width,
                       height=height, tile_w=tile_w, tile_h=tile_h,
                       near_plane=near_plane, far_plane=far_plane)
            for e in range(2)]
    vis_l = eyes[0]["visible"] & shared_ok
    vis_r = eyes[1]["visible"] & shared_ok
    any_vis = vis_l | vis_r
    both = vis_l & vis_r
    d_l, d_r = eyes[0]["depth"], eyes[1]["depth"]
    check_depth = torch.where(both, 0.5 * (d_l + d_r),
                              torch.where(vis_l, d_l, d_r))
    det = torch.where(both, torch.maximum(eyes[0]["det"], eyes[1]["det"]),
                      torch.where(vis_l, eyes[0]["det"], eyes[1]["det"]))
    any_vis &= ~M.cull_by_total_ink(opacity, det, check_depth, near_plane,
                                    far_plane, total_ink_threshold)

    color = _sh_color(harm, px, py, pz, [float(v) for v in mid], sh_degree,
                      input_is_srgb)
    w3 = (_u8(color[0]) | (_u8(color[1]) << 8) | (_u8(color[2]) << 16)
          | (_u8(opacity) << 24))

    big = 1 << 20

    def pick(key, reduce_min, fill):
        a = torch.where(vis_l, eyes[0][key], fill if reduce_min else -fill)
        b = torch.where(vis_r, eyes[1][key], fill if reduce_min else -fill)
        return torch.minimum(a, b) if reduce_min else torch.maximum(a, b)

    min_tx, max_tx = pick("min_tx", True, big), pick("max_tx", False, big)
    min_ty, max_ty = pick("min_ty", True, big), pick("max_ty", False, big)
    bounds = [pick(key, key.endswith("min"), float(big))
              for key in ("px_min", "px_max", "py_min", "py_max")]
    any_vis &= (min_tx <= max_tx) & (min_ty <= max_ty)

    def eye_words(e, vis):
        ey = eyes[e]

        def f16(key, fill):
            return f32_to_f16_bits(torch.where(vis, ey[key], fill))

        return (f16("screen_x", INVISIBLE_MEAN)
                | (f16("screen_y", INVISIBLE_MEAN) << 16),
                _theta_u16(ey["evx"], ey["evy"], ey["k"], vis)
                | (f16("sigma1", 1.0) << 16),
                f16("sigma2", 1.0) | (f16("depth", 0.0) << 16))

    w0l, w1l, w2l = eye_words(0, vis_l)
    w0r, w1r, w2r = eye_words(1, vis_r)

    min_tx = torch.where(any_vis, min_tx, 0)
    min_ty = torch.where(any_vis, min_ty, 0)
    rect_w = torch.where(any_vis, max_tx - min_tx + 1, 1)
    rect_h = torch.where(any_vis, max_ty - min_ty + 1, 1).to(torch.int32)
    rw = M.u32(pack_rect_word(min_tx, min_ty, rect_w))
    rw = torch.where(any_vis, rw, rw | CULLED_BIT)
    words = [M.to_i32(w) for w in (w0l, w1l, w2l, w3, w0r, w1r, w2r)]
    bounds = [torch.where(any_vis, b, 0.0) for b in bounds]
    return StereoPackedProjection(
        rect_word=M.to_i32(rw), rect_h=rect_h,
        dsw=M.to_i32(_depth_word(check_depth, any_vis, key_plan)),
        words=words + [words[3]], visible=any_vis,
        px_min=bounds[0], px_max=bounds[1], py_min=bounds[2], py_max=bounds[3])


def stereo_project_cuda(comp, harm, views, projs, centers, scene_transform,
                        *, width: int, height: int, tile_w: int, tile_h: int,
                        sh_degree: int, near_plane: float, far_plane: float,
                        alpha_threshold: float, total_ink_threshold: float,
                        input_is_srgb: bool,
                        key_plan=None) -> StereoPackedProjection:
    """Launch the stereo kernel of ``csrc/project.cu`` on CUDA tensors."""
    check_tile(tile_w, tile_h, "projection kernel")
    dev = comp.device
    n = comp.shape[1]
    n_coeffs = (sh_degree + 1) ** 2
    _native.check(comp, "comp", torch.float32, (11, n), dev)
    _native.check(harm, "harm", torch.float32, (3 * n_coeffs, n), dev)
    params = stereo_pose_block(
        views, projs, centers, scene_transform, width=width, height=height,
        near_plane=near_plane, far_plane=far_plane,
        alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold)
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    ints = np.asarray([n, tiles_x, tiles_y, sh_degree, int(input_is_srgb),
                       int(key_plan is not None), tile_w, 0, tile_h], np.int32)
    plan = np.asarray([key_plan.near_key, key_plan.span] if key_plan else [0, 0],
                      np.uint32)
    out_i = torch.empty((10, n), dtype=torch.int32, device=dev)
    out_f = torch.empty((4, n), dtype=torch.float32, device=dev)
    visible = torch.empty(n, dtype=torch.bool, device=dev)
    STEREO_PROJECT.launch(
        _native.ptr(comp), _native.ptr(harm),
        params.ctypes.data_as(ctypes.c_void_p),
        ints.ctypes.data_as(ctypes.c_void_p),
        plan.ctypes.data_as(ctypes.c_void_p),
        _native.ptr(out_i), _native.ptr(out_f), _native.ptr(visible))
    rect_word, rect_h, dsw, w0l, w1l, w2l, w3, w0r, w1r, w2r = out_i.unbind(0)
    return StereoPackedProjection(
        rect_word=rect_word, rect_h=rect_h, dsw=dsw,
        words=[w0l, w1l, w2l, w3, w0r, w1r, w2r, w3], visible=visible,
        px_min=out_f[0], px_max=out_f[1], py_min=out_f[2], py_max=out_f[3])


def stereo_project_and_cull_packed(gi, views, projs, centers, scene_transform,
                                   *, prepared=None,
                                   **kw) -> StereoPackedProjection:
    """Fused dual-eye projection of a GaussianInput: the CUDA kernel for
    inputs on the card, the plain version for inputs on the CPU."""
    comp, harm = (prepared if prepared is not None
                  else prepare_projection_inputs(gi, kw["sh_degree"]))
    if comp.is_cuda:
        return stereo_project_cuda(comp, harm, views, projs, centers,
                                   scene_transform, **kw)
    return stereo_project_plain(comp, harm, views, projs, centers,
                                scene_transform, **kw)
