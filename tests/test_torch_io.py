"""Scene files of gsm_renderer_tpu_torch (``io/ply.py``, ``io/splat.py``,
``io/poses.py``, the native helper ``native/``) against the JAX package.

* The port's counterpart of each test of tests/test_io.py on PLY,
  compressed PLY, .splat, poses, the native decode and the Morton order,
  with that file's tolerances (round trips within each format's
  quantization; native against NumPy decode within float rounding).
* Across the packages, on the same bytes: every array that JAX's
  ``load_ply`` / ``load_splat`` returns equals the port's bit for bit, on
  the NumPy paths and on the native paths (each package's own build of the
  same source with the same flags); the writers' bytes are equal; poses
  give equal matrices; the native Morton order is JAX's.
* The port's library loads from ``gsm_renderer_tpu_torch/_build/``.
* A frame rendered from a loaded PLY (600 gaussians, 128x96, the port's
  plain versions on the CPU) against JAX's ``depth_first_frame(...,
  interpret=True)`` on JAX's load of the same bytes, to
  tests/test_torch_pipeline.py's tolerances: colour 1e-2, depth 5e-2,
  visible counts within 0.2%.
"""

import io
import json

import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
import gsm_renderer_tpu.native as JN
from gsm_renderer_tpu.io import ply as JP
from gsm_renderer_tpu.io import poses as JPO
from gsm_renderer_tpu.io import splat as JS
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_frame

import gsm_renderer_tpu_torch as T
import gsm_renderer_tpu_torch.mathlib as TM
import gsm_renderer_tpu_torch.native as TN
from gsm_renderer_tpu_torch.io import ply
from gsm_renderer_tpu_torch.io import poses, splat
from gsm_renderer_tpu_torch.io.scene import (GaussianDataset,
                                             generate_visible_gaussians,
                                             morton_codes, sort_by_morton)

torch.set_num_threads(1)

FIELDS = ("positions", "scales", "rotations", "opacities", "harmonics")


def make_ds(n=50, sh_degree=2, seed=3):
    return generate_visible_gaussians(n, sh_degree=sh_degree, seed=seed)


def need_native():
    if not TN.native_available():
        pytest.skip("the native library does not build on this host (no g++)")


@pytest.fixture
def numpy_decode(monkeypatch):
    """Both packages on their NumPy paths (no native library)."""
    monkeypatch.setattr(TN, "get_lib", lambda: None)
    monkeypatch.setattr(JN, "get_lib", lambda: None)


def ply_bytes(ds, **kw):
    buf = io.BytesIO()
    ply.write_ply(ds, buf, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Counterparts of tests/test_io.py
# ---------------------------------------------------------------------------

def test_ply_roundtrip_standard():
    ds = make_ds(64, sh_degree=2)
    out = ply.load_ply(ply_bytes(ds))
    assert out.count == 64
    center = 0.5 * (ds.positions.min(0) + ds.positions.max(0))
    np.testing.assert_allclose(out.positions, ds.positions - center, atol=1e-5)
    np.testing.assert_allclose(out.scales, ds.scales, rtol=1e-5)
    np.testing.assert_allclose(out.opacities, ds.opacities, atol=1e-5)
    np.testing.assert_allclose(out.harmonics, ds.harmonics, atol=1e-5)
    dots = np.abs(np.sum(out.rotations * ds.rotations, -1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


def test_ply_autodetect_linear_scale():
    ds = make_ds(120, sh_degree=0)
    ds.scales = np.clip(ds.scales, 0.01, 0.3)
    ds.opacities = np.clip(ds.opacities, 0.05, 0.95)
    out = ply.load_ply(ply_bytes(ds, log_scale=False, logit_opacity=False))
    np.testing.assert_allclose(out.scales, ds.scales, rtol=1e-5)
    np.testing.assert_allclose(out.opacities, ds.opacities, atol=1e-5)


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_ply_placeholder_skip(decoder, monkeypatch):
    if decoder == "native":
        need_native()
    else:
        monkeypatch.setattr(TN, "get_lib", lambda: None)
    ds = make_ds(10, sh_degree=0)
    out0 = ply.load_ply(ply_bytes(ds))
    ds.scales[0] = np.exp(2.0)  # log-scale 2.0
    ds.opacities[0] = 1.0 / (1.0 + np.exp(-4.8402))
    out = ply.load_ply(ply_bytes(ds))
    assert ply.last_decoder() == decoder
    assert out.count == 9 and out0.count == 10


def compressed_blob():
    """A compressed PLY built by hand per the PlayCanvas layout (two
    256-vertex chunks, identity quaternions), with its source values."""
    rng = np.random.default_rng(5)
    n, n_chunks = 512, 2
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    log_scale = rng.uniform(-5, -2, (n, 3)).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0, 1, n).astype(np.float32)
    ci = np.arange(n) // 256

    def per_chunk(v, fn):
        return np.stack([fn(v[ci == c], 0) for c in range(n_chunks)])

    lo_p, hi_p = per_chunk(pos, np.min), per_chunk(pos, np.max)
    lo_s, hi_s = per_chunk(log_scale, np.min), per_chunk(log_scale, np.max)
    lo_c, hi_c = per_chunk(color, np.min), per_chunk(color, np.max)

    def unorm(t, bits):
        return np.round(np.clip(t, 0, 1) * ((1 << bits) - 1)).astype(np.uint32)

    def norm01(v, lo, hi):
        return (v - lo) / np.maximum(hi - lo, 1e-12)

    def pack_11_10_11(t):
        return ((unorm(t[:, 0], 11) << 21) | (unorm(t[:, 1], 10) << 11)
                | unorm(t[:, 2], 11))

    tc = norm01(color, lo_c[ci], hi_c[ci])
    half = unorm(np.full(n, 0.5), 10)
    fields = ["min_x", "min_y", "min_z", "max_x", "max_y", "max_z",
              "min_scale_x", "min_scale_y", "min_scale_z",
              "max_scale_x", "max_scale_y", "max_scale_z",
              "min_r", "min_g", "min_b", "max_r", "max_g", "max_b"]
    crec = np.zeros(n_chunks, np.dtype([(f, "<f4") for f in fields]))
    for k, arr in enumerate((lo_p, hi_p, lo_s, hi_s)):
        for i in range(3):
            crec[fields[3 * k + i]] = arr[:, i]
    for k, arr in enumerate((lo_c, hi_c)):
        for i in range(3):
            crec[fields[12 + 3 * k + i]] = arr[:, i]
    vrec = np.zeros(n, np.dtype([("packed_position", "<u4"),
                                 ("packed_rotation", "<u4"),
                                 ("packed_scale", "<u4"),
                                 ("packed_color", "<u4")]))
    vrec["packed_position"] = pack_11_10_11(norm01(pos, lo_p[ci], hi_p[ci]))
    vrec["packed_rotation"] = (half << 20) | (half << 10) | half
    vrec["packed_scale"] = pack_11_10_11(norm01(log_scale, lo_s[ci], hi_s[ci]))
    vrec["packed_color"] = ((unorm(tc[:, 0], 8) << 24) | (unorm(tc[:, 1], 8) << 16)
                            | (unorm(tc[:, 2], 8) << 8) | unorm(opacity, 8))
    header = (["ply", "format binary_little_endian 1.0",
               f"element chunk {n_chunks}"]
              + [f"property float {f}" for f in fields]
              + [f"element vertex {n}"]
              + [f"property uint {f}" for f in vrec.dtype.names]
              + ["end_header"])
    blob = (("\n".join(header) + "\n").encode() + crec.tobytes()
            + vrec.tobytes())
    return blob, dict(pos=pos, log_scale=log_scale, color=color,
                      opacity=opacity, extent=float((hi_p - lo_p).max()))


def test_ply_compressed_roundtrip():
    blob, src = compressed_blob()
    out = ply.load_ply(blob)
    pos = src["pos"]
    assert out.count == 512
    np.testing.assert_allclose(out.positions,
                               pos - 0.5 * (pos.min(0) + pos.max(0)),
                               atol=src["extent"] / 1024)
    np.testing.assert_allclose(out.scales, np.exp(src["log_scale"]), rtol=0.02)
    np.testing.assert_allclose(out.opacities, src["opacity"],
                               atol=1 / 255 + 1e-6)
    np.testing.assert_allclose(out.rotations, np.tile([0, 0, 0, 1.0], (512, 1)),
                               atol=2e-3)
    np.testing.assert_allclose(out.harmonics[:, 0, :] * ply.SH_C0 + 0.5,
                               src["color"], atol=0.02)


def test_morton_sort_preserves_set():
    ds = make_ds(200, sh_degree=1)
    out = sort_by_morton(ds)
    assert out.count == ds.count
    a = np.sort(ds.positions.view([("", np.float32)] * 3), axis=0)
    b = np.sort(out.positions.view([("", np.float32)] * 3), axis=0)
    np.testing.assert_array_equal(a, b)

    def avg_step(d):
        return np.linalg.norm(np.diff(d.positions, axis=0), axis=1).mean()
    assert avg_step(out) < avg_step(ds)


def test_native_matches_numpy_standard(monkeypatch):
    need_native()
    data = ply_bytes(make_ds(200, sh_degree=3, seed=11))
    loaded = ply.load_ply(data)
    assert ply.last_decoder() == "native"
    monkeypatch.setattr(TN, "get_lib", lambda: None)
    numpy_ds = ply.load_ply(data)
    assert ply.last_decoder() == "numpy"
    np.testing.assert_allclose(loaded.positions, numpy_ds.positions, atol=1e-6)
    np.testing.assert_allclose(loaded.scales, numpy_ds.scales, rtol=1e-6)
    np.testing.assert_allclose(loaded.rotations, numpy_ds.rotations, atol=1e-6)
    np.testing.assert_allclose(loaded.opacities, numpy_ds.opacities, atol=1e-7)
    np.testing.assert_allclose(loaded.harmonics, numpy_ds.harmonics, atol=1e-6)


def test_native_morton_matches_numpy():
    need_native()
    ds = make_ds(500, sh_degree=0, seed=9)
    native = TN.morton_sort_indices(ds.positions)
    np.testing.assert_array_equal(
        native, np.argsort(morton_codes(ds.positions), kind="stable"))


def _rename_ply_props(data: bytes, mapping: dict) -> bytes:
    end = data.find(b"\n", data.find(b"end_header")) + 1
    lines = []
    for ln in data[:end].decode("ascii").splitlines():
        parts = ln.split()
        if len(parts) == 3 and parts[0] == "property" and parts[2] in mapping:
            ln = " ".join(parts[:2] + [mapping[parts[2]]])
        lines.append(ln)
    return ("\n".join(lines) + "\n").encode("ascii") + data[end:]


ALIASES = {
    "x": "px", "y": "pos_y", "z": "position_z",
    "scale_0": "sx", "scale_1": "scale_y", "scale_2": "scale2",
    "rot_0": "qw", "rot_1": "rotation_x", "rot_2": "qy", "rot_3": "rot3",
    "opacity": "alpha",
    **{f"f_dc_{i}": f"sh_{i}" for i in range(3)},
    **{f"f_rest_{j}": f"sh_{j + 3}" for j in range(9)},
}


def test_ply_property_aliases():
    data = ply_bytes(make_ds(40, sh_degree=1, seed=5))
    canonical = ply.load_ply(data)
    aliased = ply.load_ply(_rename_ply_props(data, ALIASES))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(aliased, name),
                                      getattr(canonical, name))


def nonstandard_sh_dataset():
    """15 f_rest properties (5 a channel): the loader clamps to degree 1
    and must index with the file's stride of 5."""
    ds = make_ds(16, sh_degree=0, seed=7)
    harm = np.zeros((ds.count, 6, 3), np.float32)
    harm[:, 0, :] = ds.harmonics[:, 0, :]
    for ch in range(3):
        for c in range(5):
            harm[:, 1 + c, ch] = ch * 100.0 + c + 1
    return GaussianDataset(positions=ds.positions, scales=ds.scales,
                           rotations=ds.rotations, opacities=ds.opacities,
                           harmonics=harm)


def test_ply_nonstandard_sh_count_keeps_file_stride():
    ds = nonstandard_sh_dataset()
    out = ply.load_ply(ply_bytes(ds))
    assert out.harmonics.shape[1] == 4
    np.testing.assert_array_equal(out.harmonics[:, :4, :], ds.harmonics[:, :4, :])


def test_splat_roundtrip():
    ds = make_ds(80, sh_degree=0, seed=13)
    ds.opacities = np.clip(ds.opacities, 0.05, 0.95)
    data = splat.write_splat(ds)
    assert len(data) == 80 * 32
    out = splat.load_splat(data)
    assert out.count == 80
    np.testing.assert_allclose(out.positions, ds.positions, atol=1e-6)
    np.testing.assert_allclose(out.scales, ds.scales, rtol=1e-6)
    np.testing.assert_allclose(out.opacities, ds.opacities, atol=1 / 255)
    np.testing.assert_allclose(out.harmonics, ds.harmonics, atol=1 / 255 / 0.28)
    dots = np.abs(np.sum(out.rotations * ds.rotations, -1))
    np.testing.assert_allclose(dots, 1.0, atol=2e-4)
    with pytest.raises(ValueError):
        splat.load_splat(data[:-1])


def test_compressed_ply_roundtrip():
    ds = make_ds(600, sh_degree=0, seed=21)
    ds.opacities = np.clip(ds.opacities, 0.02, 0.98)
    out = ply.load_ply(ply.write_compressed_ply(ds))
    assert out.count == 600
    span = (ds.positions.max(0) - ds.positions.min(0)).max()
    src_center = 0.5 * (ds.positions.min(0) + ds.positions.max(0))
    np.testing.assert_allclose(out.positions, ds.positions - src_center,
                               atol=span / 1024 * 2 + 1e-4)
    np.testing.assert_allclose(np.log(out.scales), np.log(ds.scales), atol=2e-2)
    np.testing.assert_allclose(out.opacities, ds.opacities, atol=1.5 / 255)
    np.testing.assert_allclose(out.harmonics, ds.harmonics,
                               atol=2.5 / 255 / 0.28)
    dots = np.abs(np.sum(out.rotations * ds.rotations, -1))
    np.testing.assert_allclose(dots, 1.0, atol=3e-3)


def test_compressed_ply_native_matches_numpy(monkeypatch):
    need_native()
    ds = make_ds(500, sh_degree=0, seed=5)
    ds.opacities = np.clip(ds.opacities, 0.02, 0.98)
    data = ply.write_compressed_ply(ds)
    out_a = ply.load_ply(data)
    assert ply.last_decoder() == "native"
    monkeypatch.setattr(TN, "get_lib", lambda: None)
    out_b = ply.load_ply(data)
    assert ply.last_decoder() == "numpy"
    span = float((out_b.positions.max(0) - out_b.positions.min(0)).max())
    np.testing.assert_allclose(out_a.positions, out_b.positions,
                               atol=span * 1e-6 + 1e-6)
    np.testing.assert_allclose(out_a.scales, out_b.scales, rtol=1e-5)
    np.testing.assert_allclose(out_a.rotations, out_b.rotations, atol=1e-6)
    np.testing.assert_allclose(out_a.opacities, out_b.opacities, atol=1e-7)
    np.testing.assert_allclose(out_a.harmonics, out_b.harmonics, atol=1e-5)


def test_camera_poses_json():
    """Both formats give a view matrix that maps the camera centre to the
    origin and projects a point before the camera to the expected pixel."""
    entry = dict(id=0, img_name="r_0", width=640, height=480,
                 position=[1.0, 2.0, 3.0], rotation=np.eye(3).tolist(),
                 fx=500.0, fy=500.0)
    (cam, w, h, name), = poses.load_cameras_json(json.dumps([entry]))
    assert (w, h, name) == (640, 480, "r_0")
    assert isinstance(cam, T.CameraParams)
    assert isinstance(cam.view_matrix, np.ndarray)
    vp = cam.view_matrix @ np.array([1.0, 2.0, 3.0, 1.0])
    np.testing.assert_allclose(vp[:3], 0.0, atol=1e-6)

    def pixel_x(cam, point):
        _vp, ndc, depth, in_front = TM.project_points(
            torch.tensor([point], dtype=torch.float32),
            torch.from_numpy(cam.view_matrix),
            torch.from_numpy(cam.projection_matrix), 0.01)
        assert bool(in_front[0]) and float(depth[0]) > 0
        return (float(ndc[0, 0]) + 1) * 0.5 * 640

    np.testing.assert_allclose(pixel_x(cam, [1.1, 2.0, 5.0]),
                               320 + 500 * 0.1 / 2.0, rtol=1e-5)
    meta = dict(fl_x=500.0, fl_y=500.0, w=640, h=480, frames=[
        dict(transform_matrix=np.eye(4).tolist(), file_path="f0")])
    cam2 = poses.load_transforms_json(json.dumps(meta))[0][0]
    np.testing.assert_allclose(pixel_x(cam2, [0.1, 0.0, -5.0]),
                               320 + 500 * 0.1 / 5.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# Across the packages: the same bytes, the same arrays
# ---------------------------------------------------------------------------

CROSS_FILES = ("sh3", "linear", "placeholder", "aliased", "nonstandard_sh",
               "compressed", "compressed_hand")


def cross_files():
    """name -> the bytes of one file of each layout the loaders take."""
    ds3 = make_ds(700, sh_degree=3, seed=17)
    lin = make_ds(150, sh_degree=0, seed=4)
    lin.scales = np.clip(lin.scales, 0.01, 0.3)
    lin.opacities = np.clip(lin.opacities, 0.05, 0.95)
    ph = make_ds(30, sh_degree=1, seed=2)
    ph.scales[[0, 7]] = np.exp(2.0)
    ph.opacities[[0, 7]] = 1.0 / (1.0 + np.exp(-4.8402))
    return {
        "sh3": ply_bytes(ds3),
        "linear": ply_bytes(lin, log_scale=False, logit_opacity=False),
        "placeholder": ply_bytes(ph),
        "aliased": _rename_ply_props(ply_bytes(make_ds(40, sh_degree=1,
                                                       seed=5)), ALIASES),
        "nonstandard_sh": ply_bytes(nonstandard_sh_dataset()),
        "compressed": ply.write_compressed_ply(ds3),
        "compressed_hand": compressed_blob()[0],
    }


def assert_same_dataset(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=name)


@pytest.mark.parametrize("name", CROSS_FILES)
def test_load_ply_bit_equal_to_jax_native(name):
    need_native()
    if JN.get_lib() is None:
        pytest.skip("the JAX package's native library does not build here")
    data = cross_files()[name]
    got = ply.load_ply(data)
    assert ply.last_decoder() == "native"
    assert_same_dataset(got, JP.load_ply(data))


@pytest.mark.parametrize("name", CROSS_FILES)
def test_load_ply_bit_equal_to_jax_numpy(name, numpy_decode):
    data = cross_files()[name]
    got = ply.load_ply(data)
    assert ply.last_decoder() == "numpy"
    assert_same_dataset(got, JP.load_ply(data))


def test_writers_byte_equal_to_jax():
    src = dict(n=300, sh_degree=3, seed=19)
    ds, jds = make_ds(**src), jax_gen(src["n"], sh_degree=3, seed=19)
    for kw in ({}, dict(log_scale=False, logit_opacity=False),
               dict(sh_degree=1)):
        assert ply.write_ply(ds, io.BytesIO(), **kw) == JP.write_ply(
            jds, io.BytesIO(), **kw), kw
    assert ply.write_compressed_ply(ds) == JP.write_compressed_ply(jds)
    assert splat.write_splat(ds) == JS.write_splat(jds)
    data = splat.write_splat(ds)
    assert_same_dataset(splat.load_splat(data), JS.load_splat(data))


def test_poses_bit_equal_to_jax():
    r = np.random.default_rng(23)

    def rotation():
        q, _ = np.linalg.qr(r.normal(size=(3, 3)))
        return q * np.sign(np.linalg.det(q))

    entries = [dict(id=i, img_name=f"v{i}", width=800, height=600,
                    position=r.normal(size=3).tolist(),
                    rotation=rotation().tolist(), fx=float(r.uniform(400, 900)),
                    fy=float(r.uniform(400, 900))) for i in range(5)]
    frames = []
    for i in range(5):
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = rotation(), r.normal(size=3)
        frames.append(dict(transform_matrix=m.tolist(), file_path=f"f{i}",
                           **({"fl_x": 600.0 + i} if i % 2 else {})))
    meta = json.dumps(dict(fl_x=550.0, fl_y=560.0, w=640, h=480,
                           frames=frames))
    for load, jload, text in (
            (poses.load_cameras_json, JPO.load_cameras_json,
             json.dumps(entries)),
            (poses.load_transforms_json, JPO.load_transforms_json, meta)):
        got, want = load(text, near=0.05, far=40.0), jload(text, near=0.05,
                                                           far=40.0)
        assert len(got) == len(want) == 5
        for (c, w, h, nm), (jc, jw, jh, jnm) in zip(got, want):
            assert (w, h, nm) == (jw, jh, jnm)
            for f in ("view_matrix", "projection_matrix", "position"):
                a, b = getattr(c, f), np.asarray(getattr(jc, f))
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            for f in ("focal_x", "focal_y", "near_plane", "far_plane"):
                assert getattr(c, f) == getattr(jc, f)


def test_native_morton_equals_jax():
    need_native()
    if JN.get_lib() is None:
        pytest.skip("the JAX package's native library does not build here")
    pos = np.random.default_rng(29).normal(size=(20000, 3)).astype(np.float32)
    np.testing.assert_array_equal(TN.morton_sort_indices(pos),
                                  JN.morton_sort_indices(pos))


def test_library_loads_from_the_port_build():
    need_native()
    path = TN.library_path()
    build = (TN._HERE.parent / "_build").resolve()
    assert path.resolve().is_relative_to(build)
    assert TN.get_lib()._name == str(path)
    assert "gsm_renderer_tpu/native" not in TN.get_lib()._name


# ---------------------------------------------------------------------------
# A frame from a loaded PLY against JAX's frame from its own load
# ---------------------------------------------------------------------------

def test_frame_from_loaded_ply_matches_jax():
    w, h, n = 128, 96, 600
    data = ply_bytes(generate_visible_gaussians(n, sh_degree=1,
                                                scale_range=(0.01, 0.06)))
    got_ds, ref_ds = ply.load_ply(data), JP.load_ply(data)
    assert_same_dataset(got_ds, ref_ds)
    # the loader recentres the scene on the origin: the camera backs off
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = 6.0
    cam = G.make_camera(w, h, view_matrix=view, far=20.0)
    jview, jproj, jcenter = cam.astuple_jax()
    ref = jax_frame(ref_ds.to_input(), jview, jproj, jcenter, width=w,
                    height=h, capacity=4096, sh_degree=1,
                    alpha_threshold=0.005, total_ink_threshold=2.0,
                    near_plane=0.1, far_plane=20.0, input_is_srgb=False,
                    use_xla_blend=False, interpret=True, row_capacity=0)
    got = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1, row_expand=False),
                               device="cpu").render(
        got_ds.to_input(device="cpu"),
        T.make_camera(w, h, view_matrix=view, far=20.0), w, h)
    assert abs(int(got.header.visible_count)
               - int(ref.header.visible_count)) <= int(0.002 * n)
    assert int(got.header.visible_count) > n // 2
    assert int(got.header.overflow) == int(ref.header.overflow) == 0
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=1e-2)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=5e-2)
    assert float(got.color[..., :3].max()) > 0.05
