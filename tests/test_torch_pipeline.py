"""Whole-frame parity of gsm_renderer_tpu_torch's DepthFirstRenderer (mono,
``row_expand=False`` unless a test says otherwise, on the CPU: the plain
PyTorch versions of the kernels) against the JAX package and the NumPy
oracle, plus the renderer's contract.

Tolerances:
* vs JAX ``depth_first_frame(..., interpret=True, row_capacity=0)`` (the
  production Pallas path): colour and alpha max |d| <= 1e-2, depth <= 5e-2,
  visible_count equal up to counted projection flips (<= 0.2%).
* vs tests/reference_impl.py (scenes of tests/test_pipeline_depthfirst.py):
  colour and alpha max |d| <= 1e-2 (the oracle stops per pixel at T < 1/255,
  the port per tile after a batch: <= 1/255 apart), depth <= 0.1.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_frame
from reference_impl import render_reference

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.io.scene import (generate_grid_gaussians,
                                             generate_visible_gaussians)
from gsm_renderer_tpu_torch.pipelines.base import instance_capacity

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

COLOR_TOL = 1e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def renderer(**cfg):
    return T.DepthFirstRenderer(T.RendererConfig(row_expand=False, **cfg),
                                device="cpu")


def test_frame_matches_jax_pallas_path():
    w, h, n = 128, 96, 600
    ds = jax_gen(n, sh_degree=1, scale_range=(0.01, 0.06))
    cam = G.make_camera(w, h, far=20.0)
    view, proj, center = cam.astuple_jax()
    ref = jax_frame(ds.to_input(), view, proj, center, width=w, height=h,
                    capacity=4096, sh_degree=1, alpha_threshold=0.005,
                    total_ink_threshold=2.0, near_plane=0.1, far_plane=20.0,
                    input_is_srgb=False, use_xla_blend=False, interpret=True,
                    row_capacity=0)
    got = renderer(sh_degree=1).render(
        generate_visible_gaussians(n, sh_degree=1, scale_range=(0.01, 0.06))
        .to_input(device="cpu"), T.make_camera(w, h, far=20.0), w, h)
    assert abs(int(got.header.visible_count)
               - int(ref.header.visible_count)) <= int(0.002 * n)
    assert int(got.header.overflow) == int(ref.header.overflow) == 0
    assert int(got.header.slot_total) == int(ref.header.slot_total)
    assert int(got.header.total_instances) == int(ref.header.total_instances)
    assert int(got.header.row_total) == int(ref.header.row_total)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=COLOR_TOL)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=5e-2)
    assert float(got.color[..., :3].max()) > 0.05


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_frame_matches_reference_oracle(sh_degree):
    w, h = 128, 96
    ds = generate_grid_gaussians(300, sh_degree=sh_degree, xy_extent=1.2)
    cam = T.make_camera(w, h)
    ref_color, ref_depth, aux = render_reference(
        ds, cam.view_matrix, cam.projection_matrix, cam.position, w, h,
        sh_degree=sh_degree)
    out = renderer(sh_degree=sh_degree).render(ds.to_input(device="cpu"), cam,
                                               w, h)
    assert int(out.header.visible_count) == aux["visible"]
    assert int(out.header.total_instances) == aux["total_instances"]
    assert int(out.header.overflow) == 0
    np.testing.assert_allclose(out.color.numpy(), ref_color, atol=COLOR_TOL)
    np.testing.assert_allclose(out.depth.numpy(), ref_depth, atol=0.1)


def test_opengl_convention_renders_the_same():
    w, h = 128, 96
    ds = generate_grid_gaussians(200, sh_degree=0)
    r = renderer(sh_degree=0)
    out_cv = r.render(ds.to_input(device="cpu"),
                      T.make_camera(w, h, convention="opencv"), w, h)
    ds.positions = ds.positions * np.array([1, 1, -1], np.float32)
    ds.rotations = ds.rotations * np.array([-1, -1, 1, 1], np.float32)
    out_gl = r.render(ds.to_input(device="cpu"),
                      T.make_camera(w, h, convention="opengl"), w, h)
    np.testing.assert_allclose(out_cv.color.numpy(), out_gl.color.numpy(),
                               atol=0.02)


def test_header_invariants():
    w, h = 160, 120
    out = renderer(sh_degree=0).render(
        generate_visible_gaussians(500, sh_degree=0).to_input(device="cpu"),
        T.make_camera(w, h), w, h)
    visible = int(out.header.visible_count)
    assert 0 < visible <= 500
    assert int(out.header.total_instances) >= visible
    assert int(out.header.slot_total) >= int(out.header.total_instances)
    assert int(out.header.overflow) == 0
    for f in ("visible_count", "total_instances", "overflow", "slot_total",
              "row_total"):
        t = getattr(out.header, f)
        assert t.dtype == torch.int32 and t.dim() == 0


def test_empty_scene_is_black():
    w, h = 64, 64
    ds = generate_grid_gaussians(10)
    ds.positions[:, 2] = -5.0
    out = renderer(sh_degree=0).render(ds.to_input(device="cpu"),
                                       T.make_camera(w, h), w, h)
    assert int(out.header.visible_count) == 0
    assert int(out.header.total_instances) == 0
    assert float(out.color.abs().max()) == 0.0


def test_overflow_sets_flag_and_renders():
    w, h = 64, 64
    ds = generate_grid_gaussians(3000, xy_extent=0.3, scale_range=(0.1, 0.3))
    out = renderer(sh_degree=0, max_instances=1024).render(
        ds.to_input(device="cpu"), T.make_camera(w, h), w, h)
    assert int(out.header.overflow) == 1
    assert int(out.header.slot_total) > 1024
    assert torch.isfinite(out.color).all() and torch.isfinite(out.depth).all()


def test_fp16_input_renders_close_to_fp32():
    w, h = 96, 64
    ds = generate_grid_gaussians(150, sh_degree=1)
    r = renderer(sh_degree=1, precision=T.Precision.FLOAT16)
    cam = T.make_camera(w, h)
    out16 = r.render(ds.to_input(T.Precision.FLOAT16, device="cpu"), cam, w, h)
    out32 = r.render(ds.to_input(T.Precision.FLOAT32, device="cpu"), cam, w, h)
    np.testing.assert_allclose(out16.color.numpy(), out32.color.numpy(), atol=0.08)


def test_rgba16_float_and_no_depth_outputs():
    w, h = 96, 64
    gi = generate_visible_gaussians(300, sh_degree=0).to_input(device="cpu")
    cam = T.make_camera(w, h)
    base = renderer(sh_degree=0).render(gi, cam, w, h)
    half = renderer(sh_degree=0, color_format=T.ColorFormat.RGBA16_FLOAT).render(
        gi, cam, w, h)
    assert half.color.dtype == torch.float16 and half.depth.dtype == torch.float16
    np.testing.assert_array_equal(half.color.numpy(),
                                  base.color.to(torch.float16).numpy())
    nod = renderer(sh_degree=0, depth_output=False).render(gi, cam, w, h)
    assert nod.depth is None
    np.testing.assert_array_equal(nod.color.numpy(), base.color.numpy())


def test_capacity_locks_in_and_output_is_identical():
    w, h, n = 128, 96, 3000
    gi = generate_visible_gaussians(n, sh_degree=1,
                                    scale_range=(0.005, 0.03)).to_input(device="cpu")
    cam = T.make_camera(w, h)
    r = renderer(sh_degree=1)
    full = instance_capacity(r.config, n)
    o1 = r.render(gi, cam, w, h)
    o2 = r.render(gi, cam, w, h)
    cap = r._cap_state[(r._mono_key, n)]["cap"]
    assert int(o1.header.slot_total) < cap < full
    assert int(o2.header.overflow) == 0
    np.testing.assert_array_equal(o1.color.numpy(), o2.color.numpy())
    r.render(gi, cam, w, h)
    assert r._cap_state[(r._mono_key, n)]["cap"] == cap


def test_capacity_policy():
    n = 5000
    r = renderer(sh_degree=0)
    full = instance_capacity(r.config, n)
    r._cap_feedback = {(r._mono_key, n): types.SimpleNamespace(
        slot_total=torch.tensor(3 * full, dtype=torch.int32))}
    assert 3 * full <= r.pick_capacity(n, kind=r._mono_key) <= 4 * full
    fixed = renderer(sh_degree=0, max_instances=65536)
    assert fixed.pick_capacity(n) == instance_capacity(fixed.config, n)
    off = T.DepthFirstRenderer(T.RendererConfig(row_expand=False),
                               device="cpu", adaptive_capacity=False)
    off.note_frame(n, types.SimpleNamespace(slot_total=torch.tensor(10)))
    assert off.pick_capacity(n) == instance_capacity(off.config, n)


@pytest.mark.parametrize("cfg,what", [
    (dict(row_expand=False,
          depth_sort_key_precision=T.DepthSortKeyPrecision.BITS16), "BITS16"),
    (dict(depth_sort_key_precision=T.DepthSortKeyPrecision.BITS16,
          tile_id_precision=T.TileIdPrecision.BITS32), "BITS16 rows"),
])
def test_unported_options_raise(cfg, what):
    """Mono frames with 16-bit depth keys, the last mono option that raised
    as unported, now render whatever the tile ids and rows: rows off (as in
    JAX), the frame of ``depth_first_frame(depth_key_bits=16)``.  The
    HardwareRenderer, the last renderer that raised as unported, renders
    under the same options: the Hardware frame with 16-bit depth keys."""
    from gsm_renderer_tpu_torch.pipelines.hardware import hardware_frame
    from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame

    r = T.DepthFirstRenderer(T.RendererConfig(**cfg), device="cpu")
    gi = generate_visible_gaussians(50).to_input(device="cpu")
    cam = T.make_camera(64, 64)
    out = r.render(gi, cam, 64, 64)
    ref = depth_first_frame(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=64,
        height=64, capacity=instance_capacity(r.config, 50), sh_degree=0,
        alpha_threshold=0.005, total_ink_threshold=2.0, near_plane=0.1,
        far_plane=cam.far_plane, input_is_srgb=False, depth_key_bits=16)
    assert int(out.header.visible_count) > 0
    np.testing.assert_array_equal(out.color.numpy(), ref.color.numpy())
    np.testing.assert_array_equal(out.depth.numpy(), ref.depth.numpy())
    assert int(out.header.slot_total) == int(ref.header.slot_total)
    hw = T.HardwareRenderer(T.RendererConfig(**cfg), device="cpu")
    out = hw.render(gi, cam, 64, 64)
    ref = hardware_frame(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=64,
        height=64, capacity=instance_capacity(hw.config, 50, 8), sh_degree=0,
        alpha_threshold=0.005, total_ink_threshold=2.0, near_plane=0.1,
        far_plane=cam.far_plane, input_is_srgb=False, depth_key_bits=16)
    assert int(out.header.visible_count) > 0 and out.header.row_total is None
    np.testing.assert_array_equal(out.color.numpy(), ref.color.numpy())
    np.testing.assert_array_equal(out.depth.numpy(), ref.depth.numpy())


@pytest.mark.parametrize("frame", ["stereo", "foveated"])
@pytest.mark.parametrize("option", [
    dict(depth_sort_key_precision=T.DepthSortKeyPrecision.BITS16),
    dict(tile_id_precision=T.TileIdPrecision.BITS32)],
    ids=["depth16", "tile32"])
def test_key_precision_options_render_the_default_stereo_frames(option, frame):
    """The JAX stereo and foveated frames take neither key precision: under
    each option they render, equal to the default config's frame."""
    w, h = 64, 48
    gi = generate_visible_gaussians(120, sh_degree=1).to_input(device="cpu")
    stereo = T.make_side_by_side_stereo(T.make_camera(w, h))

    def render(**opt):
        r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1, **opt),
                                 device="cpu")
        if frame == "stereo":
            return r.render_stereo(gi, stereo, w, h)
        return r.render_stereo_foveated(gi, stereo, T.make_rate_maps(w, h))

    out, base = render(**option), render()
    assert float(base.color[..., :3].max()) > 0.05
    np.testing.assert_array_equal(out.color.numpy(), base.color.numpy())
    np.testing.assert_array_equal(out.depth.numpy(), base.depth.numpy())


def test_mono_tile_ids_bits32_equal_bits16():
    """With 32-bit depth keys, BITS32 tile ids render the same KeyPlan
    frame as BITS16 (rows on, the default), as in JAX."""
    w, h = 96, 64
    gi = generate_visible_gaussians(200, sh_degree=3).to_input(device="cpu")
    cam = T.make_camera(w, h)
    out = T.DepthFirstRenderer(T.RendererConfig(
        tile_id_precision=T.TileIdPrecision.BITS32), device="cpu").render(
            gi, cam, w, h)
    base = T.DepthFirstRenderer(T.RendererConfig(), device="cpu").render(
        gi, cam, w, h)
    assert int(out.header.visible_count) > 0
    np.testing.assert_array_equal(out.color.numpy(), base.color.numpy())
    np.testing.assert_array_equal(out.depth.numpy(), base.depth.numpy())
    for f in ("visible_count", "total_instances", "slot_total", "row_total"):
        assert int(getattr(out.header, f)) == int(getattr(base.header, f)), f


def test_bits16_tile_ids_raise_above_65535_tiles():
    """16-bit tile ids cannot address 257 x 256 tiles: the JAX message."""
    w, h = 4112, 4096
    r = T.DepthFirstRenderer(T.RendererConfig(max_width=w, max_height=h),
                             device="cpu")
    gi = generate_visible_gaussians(50).to_input(device="cpu")
    with pytest.raises(ValueError, match="BITS16 cannot address 65792 tiles"):
        r.render(gi, T.make_camera(w, h), w, h)


def test_default_config_renders():
    """RendererConfig() (row_expand on) renders on the CPU, equal to the
    rows-off frame."""
    w, h = 96, 64
    gi = generate_visible_gaussians(200, sh_degree=3).to_input(device="cpu")
    cam = T.make_camera(w, h)
    out = T.DepthFirstRenderer(T.RendererConfig(), device="cpu").render(
        gi, cam, w, h)
    base = renderer().render(gi, cam, w, h)
    assert int(out.header.overflow) == 0 and int(out.header.visible_count) > 0
    np.testing.assert_array_equal(out.color.numpy(), base.color.numpy())
    np.testing.assert_array_equal(out.depth.numpy(), base.depth.numpy())


def test_render_stereo_renders():
    w, h = 96, 64
    gi = generate_visible_gaussians(200, sh_degree=1).to_input(device="cpu")
    out = renderer(sh_degree=1).render_stereo(
        gi, T.make_side_by_side_stereo(T.make_camera(w, h)), w, h)
    assert out.color.shape == (h, 2 * w, 4) and out.depth.shape == (h, 2 * w)
    assert torch.isfinite(out.color).all()
    assert float(out.color[:, :w, :3].max()) > 0.05
    assert float(out.color[:, w:, :3].max()) > 0.05


def test_unported_renderers_and_modes_raise():
    """HardwareRenderer, once unported, renders mono and stereo frames; the
    Global and Local renderers are mono only and refuse stereo with the JAX
    package's message."""
    gi = generate_visible_gaussians(20).to_input(device="cpu")
    hw = T.HardwareRenderer(device="cpu")
    out = hw.render(gi, T.make_camera(64, 48), 64, 48)
    assert out.color.shape == (48, 64, 4) and int(out.header.overflow) == 0
    out = hw.render_stereo(gi, T.make_side_by_side_stereo(
        T.make_camera(64, 48)), 64, 48)
    assert out.color.shape == (48, 128, 4)
    stereo = T.make_side_by_side_stereo(T.make_camera(64, 48))
    for cls in (T.GlobalRenderer, T.LocalRenderer):
        with pytest.raises(NotImplementedError,
                           match=f"{cls.__name__} does not support stereo"):
            cls(device="cpu").render_stereo(gi, stereo, 64, 48)


def test_import_loads_no_jax():
    """Importing the port pulls in neither jax nor the JAX package (a
    subprocess: this test process has jax loaded already)."""
    code = ("import sys, gsm_renderer_tpu_torch, gsm_renderer_tpu_torch.interop, "
            "gsm_renderer_tpu_torch.io.scene, gsm_renderer_tpu_torch._native, "
            "gsm_renderer_tpu_torch.kernels.expand, "
            "gsm_renderer_tpu_torch.kernels.project, "
            "gsm_renderer_tpu_torch.kernels.blend, "
            "gsm_renderer_tpu_torch.parallel.multichip, "
            "gsm_renderer_tpu_torch.io.ply, gsm_renderer_tpu_torch.io.splat, "
            "gsm_renderer_tpu_torch.io.poses, gsm_renderer_tpu_torch.native, "
            "gsm_renderer_tpu_torch.profiling, "
            "gsm_renderer_tpu_torch.ops.binning; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'jaxlib' or m == 'gsm_renderer_tpu' "
            "or m.startswith('gsm_renderer_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.DepthFirstRenderer(T.RendererConfig(row_expand=False))
    with pytest.raises(RuntimeError):
        generate_visible_gaussians(10).to_input()


@pytest.mark.parametrize("precision", [G.Precision.FLOAT32, G.Precision.FLOAT16])
def test_interop_round_trips_jax_input_exactly(precision):
    ds = jax_gen(200, sh_degree=2)
    jgi = ds.to_input(precision)
    gi = T.gaussian_input_from_numpy(
        np.asarray(jgi.positions), np.asarray(jgi.scales),
        np.asarray(jgi.rotations), np.asarray(jgi.opacities),
        np.asarray(jgi.harmonics), device="cpu")
    for name in ("positions", "scales", "rotations", "opacities", "harmonics"):
        a, b = np.asarray(getattr(jgi, name)), getattr(gi, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    jcam = G.make_camera(320, 240, far=30.0)
    cam = T.camera_from_numpy(jcam.view_matrix, jcam.projection_matrix,
                              jcam.position, jcam.near_plane, jcam.far_plane,
                              320, 240)
    for name in ("view_matrix", "projection_matrix", "position"):
        np.testing.assert_array_equal(getattr(cam, name), getattr(jcam, name))
    assert (cam.near_plane, cam.far_plane) == (jcam.near_plane, jcam.far_plane)
