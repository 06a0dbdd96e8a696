"""PLY loader and writers: the standard 3DGS layout and the PlayCanvas /
splat-transform compressed layout.

Port of ``gsm_renderer_tpu/io/ply.py``: the same NumPy code, line for
line, so that the same bytes give the same arrays in both packages, and
the same C++ fast paths (``native/gsm_native.cpp``, this package's own
copy and build).  What it reads:

* the header: ascii / binary little- and big-endian, typed properties
  (ascii bodies are refused);
* the standard layout (x/y/z, scale_0..2, rot_0..3, opacity,
  f_dc_* / f_rest_*, and their aliases) with format autodetect -- log-space
  scale and logit opacity sampled from the first 100 vertices -- the SH
  reorder [DC_R, DC_G, DC_B, R1.., G1.., B1..] -> per-coefficient RGB, the
  placeholder-vertex skip (scale 2, 2, 2 and opacity ~4.8402) and the
  recentring on the bounding box's centre;
* the compressed layout: 256-vertex chunks, 11-10-11 packed position and
  log-scale, the 2-bit largest-component quaternion, 8888 colour, per-chunk
  min / max lerp.

The loaders return the port's :class:`~.scene.GaussianDataset` (host
arrays; ``to_input()`` puts the scene on the card).  The native decoders
run where the library builds (:func:`..native.native_available`);
:func:`last_decoder` says which decoder the last :func:`load_ply` used.
"""

from __future__ import annotations

import io as _io

import numpy as np

from .. import native
from .scene import GaussianDataset

SH_C0 = 0.28209479177387814

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PLYError(ValueError):
    pass


#: "native" or "numpy": the decoder of the last :func:`load_ply` (None
#: before the first)
_last_decoder = None


def last_decoder():
    """Which decoder the last :func:`load_ply` of this process used:
    "native", "numpy", or None before the first."""
    return _last_decoder


def _decoded(ds: GaussianDataset, decoder: str) -> GaussianDataset:
    global _last_decoder
    _last_decoder = decoder
    return ds


# Property-name alias table: canonical <- variants,
# matched on the lowercased property name.
_CANONICAL = {}
for _canon, _variants in {
    "x": ("x", "px", "pos_x", "position_x"),
    "y": ("y", "py", "pos_y", "position_y"),
    "z": ("z", "pz", "pos_z", "position_z"),
    "scale_0": ("scale_0", "scale0", "sx", "scale_x"),
    "scale_1": ("scale_1", "scale1", "sy", "scale_y"),
    "scale_2": ("scale_2", "scale2", "sz", "scale_z"),
    "rot_0": ("rot_0", "rot0", "qw", "rotation_w"),
    "rot_1": ("rot_1", "rot1", "qx", "rotation_x"),
    "rot_2": ("rot_2", "rot2", "qy", "rotation_y"),
    "rot_3": ("rot_3", "rot3", "qz", "rotation_z"),
    "opacity": ("opacity", "alpha"),
}.items():
    for _v in _variants:
        _CANONICAL[_v] = _canon


def _canonical_prop_map(raw_names):
    """Map canonical property names -> actual names present in the file.

    Handles the alias table plus ``sh_N`` / ``spherical_harmonics_N`` SH
    naming (sh_0..sh_2 sort like DC terms, sh_3.. like rest terms).
    """
    m = {}
    for nm in raw_names:
        low = nm.lower()
        canon = _CANONICAL.get(low)
        if canon is None:
            if low.startswith("f_dc_") or low.startswith("f_rest_"):
                canon = low
            else:
                for prefix in ("sh_", "spherical_harmonics_"):
                    if low.startswith(prefix):
                        try:
                            i = int(low[len(prefix):])
                        except ValueError:
                            break
                        canon = f"f_dc_{i}" if i < 3 else f"f_rest_{i - 3}"
                        break
        if canon is not None and canon not in m:
            m[canon] = nm
    return m


def parse_header(data: bytes):
    """Parse the PLY header; returns (format, elements, body_offset) where
    elements is a list of (name, count, [(prop_name, np_type), ...])."""
    end = data.find(b"end_header")
    if end < 0:
        raise PLYError("missing end_header")
    end_line = data.find(b"\n", end)
    body_offset = end_line + 1
    text = data[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or lines[0] != "ply":
        raise PLYError("not a PLY file")

    fmt = None
    elements = []
    for ln in lines[1:]:
        parts = ln.split()
        kw = parts[0]
        if kw == "format":
            fmt = parts[1]
        elif kw == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif kw == "property":
            if not elements:
                raise PLYError("property before element")
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
            else:
                t = _PLY_TYPES.get(parts[1])
                if t is None:
                    raise PLYError(f"unknown property type {parts[1]}")
                elements[-1][2].append((parts[2], t))
        elif kw in ("comment", "obj_info"):
            continue
    if fmt is None:
        raise PLYError("missing format line")
    return fmt, elements, body_offset


def _element_dtype(props, endian):
    fields = []
    for name, t in props:
        if isinstance(t, tuple):
            raise PLYError("list properties unsupported in vertex data")
        fields.append((name, endian + t))
    return np.dtype(fields)


def load_ply(path_or_bytes) -> GaussianDataset:
    """Load a gaussian-splat PLY (standard or compressed) into a dataset."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        data = np.fromfile(path_or_bytes, dtype=np.uint8).tobytes()

    fmt, elements, body = parse_header(data)
    if fmt == "ascii":
        raise PLYError("ascii PLY bodies are not supported (binary only, like "
                       "the reference renderer)")
    endian = "<" if fmt == "binary_little_endian" else ">"

    names = [e[0] for e in elements]
    vertex = next((e for e in elements if e[0] == "vertex"), None)
    if vertex is None:
        raise PLYError("missing vertex element")

    prop_names = [p[0] for p in vertex[2]]
    if "chunk" in names and "packed_position" in prop_names:
        return _load_compressed(data, elements, body, endian)
    return _load_standard(data, vertex, elements, body, endian)


def _load_standard(data, vertex, elements, body, endian) -> GaussianDataset:
    name, count, props = vertex
    # vertex data begins after any prior elements (rare; vertex is usually first)
    offset = body
    for ename, ecount, eprops in elements:
        if ename == "vertex":
            break
        offset += _element_dtype(eprops, endian).itemsize * ecount

    dt = _element_dtype(props, endian)
    arr = np.frombuffer(data, dtype=dt, count=count, offset=offset)
    canon = _canonical_prop_map(arr.dtype.names)

    ds = _load_standard_native(data, props, count, offset, endian, canon)
    if ds is not None:
        return _decoded(ds, "native")

    def col(nm, default=0.0):
        nm = canon.get(nm, nm)
        if nm in arr.dtype.names:
            c = arr[nm].astype(np.float32)
            if arr.dtype[nm].kind == "u" and arr.dtype[nm].itemsize == 1:
                c = c / 255.0  # uint8 properties are normalized
            return c
        return np.full(count, default, np.float32)

    s0, s1, s2 = col("scale_0"), col("scale_1"), col("scale_2")
    op_raw = col("opacity")

    # Format autodetect on the first 100 vertices
    sample = slice(0, min(100, count))
    ss = np.stack([s0[sample], s1[sample], s2[sample]]).ravel()
    scale_is_log = True
    if ss.size:
        if (ss < 0).any():
            scale_is_log = True
        elif not (ss > 1.0).any() and 0 < ss.mean() < 0.5:
            scale_is_log = False
    so = op_raw[sample]
    opacity_is_logit = bool(so.size and ((so.min() < 0) or (so.max() > 1.0)))

    # Placeholder-vertex skip
    placeholder = (s0 == 2.0) & (s1 == 2.0) & (s2 == 2.0) & \
        (np.abs(op_raw - 4.8402) < 0.001)
    keep = ~placeholder

    positions = np.stack([col("x"), col("y"), col("z")], -1)[keep]
    if scale_is_log:
        scales = np.exp(np.stack([s0, s1, s2], -1))[keep]
    else:
        scales = np.stack([s0, s1, s2], -1)[keep]

    # rot_0 = w (scalar), rot_1..3 = x, y, z — our layout is (x, y, z, w)
    quat = np.stack([col("rot_1"), col("rot_2"), col("rot_3"),
                     col("rot_0", 1.0)], -1)[keep]
    norms = np.maximum(np.linalg.norm(quat, axis=-1, keepdims=True), 1e-12)
    quat = quat / norms

    if opacity_is_logit:
        opacities = 1.0 / (1.0 + np.exp(-op_raw))
    else:
        opacities = op_raw
    opacities = opacities[keep].astype(np.float32)

    # SH: f_dc_0..2 + f_rest_0..(3*(C-1)-1)
    n_rest = sum(1 for nm in canon if nm.startswith("f_rest_"))
    if n_rest % 3 != 0:
        import warnings
        warnings.warn(f"PLY has {n_rest} f_rest properties (not divisible by "
                      "3); trailing coefficients ignored", stacklevel=2)
    has_dc = "f_dc_0" in canon
    n_coeffs = 1 + n_rest // 3 if has_dc else 0
    # clamp to a supported degree (1/4/9/16 coefficients)
    for allowed in (16, 9, 4, 1):
        if n_coeffs >= allowed:
            n_coeffs = allowed
            break
    else:
        n_coeffs = 0

    n = int(keep.sum())
    if n_coeffs == 0:
        harmonics = np.zeros((n, 1, 3), np.float32)
        n_coeffs = 1
    else:
        higher = n_coeffs - 1
        # channel stride in the FILE is its true per-channel count, not the
        # degree-clamped one
        file_higher = n_rest // 3
        harmonics = np.zeros((n, n_coeffs, 3), np.float32)
        harmonics[:, 0, 0] = col("f_dc_0")[keep]
        harmonics[:, 0, 1] = col("f_dc_1")[keep]
        harmonics[:, 0, 2] = col("f_dc_2")[keep]
        # PLY layout: [R1..Rk, G1..Gk, B1..Bk] planar in f_rest
        for ch in range(3):
            for c in range(min(higher, file_higher)):
                harmonics[:, 1 + c, ch] = col(f"f_rest_{ch * file_higher + c}")[keep]

    # Recenter
    if n:
        center = 0.5 * (positions.min(0) + positions.max(0))
        if np.linalg.norm(center) > 1e-6:
            positions = positions - center

    return _decoded(GaussianDataset(
        positions=positions.astype(np.float32),
        scales=scales.astype(np.float32),
        rotations=quat.astype(np.float32),
        opacities=opacities,
        harmonics=harmonics,
    ), "numpy")


def _load_standard_native(data, props, count, offset, endian, canon):
    """Bulk-decode via the C++ library when the layout qualifies (all-float32
    little-endian standard 3DGS properties).  Returns None to fall back."""
    if endian != "<" or count == 0:
        return None
    if any(not isinstance(t, str) or t != "f4" for _, t in props):
        return None
    lib = native.get_lib()
    if lib is None:
        return None

    raw_offs = {}
    pos = 0
    for nm, _t in props:
        raw_offs[nm] = pos
        pos += 4
    stride = pos
    offs = {c: raw_offs[nm] for c, nm in canon.items() if nm in raw_offs}
    required = ["x", "y", "z", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3", "opacity"]
    if any(nm not in offs for nm in required):
        return None
    n_rest = sum(1 for nm in offs if nm.startswith("f_rest_"))
    if n_rest and ("f_rest_0" not in offs or
                   offs.get(f"f_rest_{n_rest-1}", -1) - offs["f_rest_0"]
                   != 4 * (n_rest - 1)):
        return None  # non-contiguous f_rest
    has_dc = "f_dc_0" in offs
    n_coeffs = 1 + n_rest // 3 if has_dc else 1
    for allowed in (16, 9, 4, 1):
        if n_coeffs >= allowed:
            n_coeffs = allowed
            break

    body = np.frombuffer(data, np.uint8, count=stride * count, offset=offset)
    # autodetect on the first 100 vertices (same rule as the NumPy path)
    head = np.frombuffer(data, _element_dtype(props, endian),
                         count=min(100, count), offset=offset)
    ss = np.stack([head[canon["scale_0"]], head[canon["scale_1"]],
                   head[canon["scale_2"]]]).ravel()
    scale_is_log = True
    if ss.size and not (ss < 0).any():
        if not (ss > 1.0).any() and 0 < ss.mean() < 0.5:
            scale_is_log = False
    so = head[canon["opacity"]]
    opacity_is_logit = bool(so.size and ((so.min() < 0) or (so.max() > 1.0)))

    positions = np.empty((count, 3), np.float32)
    scales = np.empty((count, 3), np.float32)
    rotations = np.empty((count, 4), np.float32)
    opacities = np.empty(count, np.float32)
    harmonics = np.zeros((count, n_coeffs, 3), np.float32)
    n = lib.ply_decode_standard(
        np.ascontiguousarray(body), count, stride,
        offs["x"], offs["y"], offs["z"],
        offs["scale_0"], offs["scale_1"], offs["scale_2"],
        offs["rot_0"], offs["rot_1"], offs["rot_2"], offs["rot_3"],
        offs["opacity"],
        offs.get("f_dc_0", -1), offs.get("f_dc_1", -1), offs.get("f_dc_2", -1),
        offs.get("f_rest_0", -1), n_rest,
        int(scale_is_log), int(opacity_is_logit), n_coeffs,
        positions, scales, rotations, opacities, harmonics)
    n = int(n)
    positions = positions[:n]
    if n:
        center = 0.5 * (positions.min(0) + positions.max(0))
        if np.linalg.norm(center) > 1e-6:
            positions = positions - center
    return GaussianDataset(positions=positions, scales=scales[:n],
                           rotations=rotations[:n], opacities=opacities[:n],
                           harmonics=harmonics[:n])


def _unpack_unorm(v, shift, bits):
    mask = np.uint32((1 << bits) - 1)
    return (((v >> np.uint32(shift)) & mask).astype(np.float32) / float(mask))


def _load_compressed_native(chunks, verts, n_chunks, n_verts):
    """Threaded C++ fast path for the compressed decode
    (``native/gsm_native.cpp::ply_decode_compressed``); None without the
    library."""
    lib = native.get_lib()
    if lib is None:
        return None
    need = ("packed_position", "packed_rotation", "packed_scale",
            "packed_color")
    if any(nm not in verts.dtype.names for nm in need):
        return None
    order = ("min_x", "min_y", "min_z", "max_x", "max_y", "max_z",
             "min_scale_x", "min_scale_y", "min_scale_z",
             "max_scale_x", "max_scale_y", "max_scale_z",
             "min_r", "min_g", "min_b", "max_r", "max_g", "max_b")
    cd = np.zeros((n_chunks, 18), np.float32)
    for k, nm in enumerate(order):
        if nm in chunks.dtype.names:
            cd[:, k] = chunks[nm].astype(np.float32)
    packed = np.empty((n_verts, 4), np.uint32)
    for k, nm in enumerate(need):
        packed[:, k] = verts[nm].astype(np.uint32)
    positions = np.empty((n_verts, 3), np.float32)
    scales = np.empty((n_verts, 3), np.float32)
    rotations = np.empty((n_verts, 4), np.float32)
    opacities = np.empty(n_verts, np.float32)
    harmonics = np.empty((n_verts, 1, 3), np.float32)
    lib.ply_decode_compressed(np.ascontiguousarray(cd), n_chunks,
                              np.ascontiguousarray(packed), n_verts,
                              positions, scales, rotations, opacities,
                              harmonics)
    center = 0.5 * (positions.min(0) + positions.max(0))
    if np.linalg.norm(center) > 1e-6:
        positions = positions - center
    return GaussianDataset(positions=positions, scales=scales,
                           rotations=rotations, opacities=opacities,
                           harmonics=harmonics)


def _load_compressed(data, elements, body, endian) -> GaussianDataset:
    """PlayCanvas / splat-transform compressed PLY."""
    by_name = {e[0]: e for e in elements}
    chunk = by_name.get("chunk")
    vertex = by_name.get("vertex")
    if chunk is None or vertex is None:
        raise PLYError("compressed PLY missing chunk/vertex element")

    cdt = _element_dtype(chunk[2], endian)
    vdt = _element_dtype(vertex[2], endian)
    n_chunks, n_verts = chunk[1], vertex[1]
    chunks = np.frombuffer(data, dtype=cdt, count=n_chunks, offset=body)
    vstart = body + cdt.itemsize * n_chunks
    verts = np.frombuffer(data, dtype=vdt, count=n_verts, offset=vstart)

    ds = _load_compressed_native(chunks, verts, n_chunks, n_verts)
    if ds is not None:
        return _decoded(ds, "native")

    ci = np.arange(n_verts) // 256
    ci = np.minimum(ci, n_chunks - 1)

    def cf(nm):
        if nm in chunks.dtype.names:
            return chunks[nm].astype(np.float32)[ci]
        return np.zeros(n_verts, np.float32)

    def lerp(a, b, t):
        return a * (1 - t) + b * t

    pp = verts["packed_position"].astype(np.uint32)
    px = _unpack_unorm(pp, 21, 11)
    py = _unpack_unorm(pp, 11, 10)
    pz = _unpack_unorm(pp, 0, 11)
    positions = np.stack([
        lerp(cf("min_x"), cf("max_x"), px),
        lerp(cf("min_y"), cf("max_y"), py),
        lerp(cf("min_z"), cf("max_z"), pz)], -1)

    ps = verts["packed_scale"].astype(np.uint32)
    sx = _unpack_unorm(ps, 21, 11)
    sy = _unpack_unorm(ps, 11, 10)
    sz = _unpack_unorm(ps, 0, 11)
    scales = np.exp(np.stack([
        lerp(cf("min_scale_x"), cf("max_scale_x"), sx),
        lerp(cf("min_scale_y"), cf("max_scale_y"), sy),
        lerp(cf("min_scale_z"), cf("max_scale_z"), sz)], -1))

    # 2-bit largest-component quaternion
    prot = verts["packed_rotation"].astype(np.uint32)
    norm = 1.0 / (np.sqrt(2.0) * 0.5)
    a = (_unpack_unorm(prot, 20, 10) - 0.5) * norm
    b = (_unpack_unorm(prot, 10, 10) - 0.5) * norm
    c = (_unpack_unorm(prot, 0, 10) - 0.5) * norm
    m = np.sqrt(np.maximum(0.0, 1.0 - (a * a + b * b + c * c)))
    which = (prot >> np.uint32(30)).astype(np.int32)
    # quaternion layout (x, y, z, w) by largest-component case
    qx = np.select([which == 0, which == 1, which == 2, which == 3], [a, m, b, b])
    qy = np.select([which == 0, which == 1, which == 2, which == 3], [b, b, m, c])
    qz = np.select([which == 0, which == 1, which == 2, which == 3], [c, c, c, m])
    qw = np.select([which == 0, which == 1, which == 2, which == 3], [m, a, a, a])
    quat = np.stack([qx, qy, qz, qw], -1).astype(np.float32)

    pc = verts["packed_color"].astype(np.uint32)
    cr = lerp(cf("min_r"), cf("max_r"), _unpack_unorm(pc, 24, 8))
    cg = lerp(cf("min_g"), cf("max_g"), _unpack_unorm(pc, 16, 8))
    cb = lerp(cf("min_b"), cf("max_b"), _unpack_unorm(pc, 8, 8))
    opacity = _unpack_unorm(pc, 0, 8)

    harmonics = np.zeros((n_verts, 1, 3), np.float32)
    harmonics[:, 0, 0] = (cr - 0.5) / SH_C0
    harmonics[:, 0, 1] = (cg - 0.5) / SH_C0
    harmonics[:, 0, 2] = (cb - 0.5) / SH_C0

    center = 0.5 * (positions.min(0) + positions.max(0))
    if np.linalg.norm(center) > 1e-6:
        positions = positions - center

    return _decoded(GaussianDataset(
        positions=positions.astype(np.float32),
        scales=scales.astype(np.float32),
        rotations=quat,
        opacities=opacity.astype(np.float32),
        harmonics=harmonics,
    ), "numpy")


def _pack_unorm(v, shift, bits):
    mask = float((1 << bits) - 1)
    q = np.clip(np.round(np.clip(v, 0.0, 1.0) * mask), 0, mask)
    return q.astype(np.uint32) << np.uint32(shift)


def write_compressed_ply(ds: GaussianDataset, path=None) -> bytes:
    """Write a PlayCanvas/splat-transform compressed PLY (the format
    :func:`_load_compressed` reads): 256-vertex
    chunks with min/max ranges, 11-10-11 packed position/log-scale, 2-bit
    largest-component quaternion, 8888 color.  DC color only."""
    n = ds.count
    n_chunks = max(-(-n // 256), 1)
    color = np.clip(0.5 + SH_C0 * ds.harmonics[:, 0, :], 0.0, 1.0)
    opacity = np.clip(ds.opacities, 0.0, 1.0)
    log_scale = np.log(np.maximum(ds.scales, 1e-12))

    chunk_fields = (["min_x", "min_y", "min_z", "max_x", "max_y", "max_z",
                     "min_scale_x", "min_scale_y", "min_scale_z",
                     "max_scale_x", "max_scale_y", "max_scale_z",
                     "min_r", "min_g", "min_b", "max_r", "max_g", "max_b"])
    cdt = np.dtype([(f, "<f4") for f in chunk_fields])
    vdt = np.dtype([("packed_position", "<u4"), ("packed_rotation", "<u4"),
                    ("packed_scale", "<u4"), ("packed_color", "<u4")])
    chunks = np.zeros(n_chunks, cdt)
    verts = np.zeros(n, vdt)

    for c in range(n_chunks):
        sl = slice(c * 256, min((c + 1) * 256, n))
        pos, lsc, col = ds.positions[sl], log_scale[sl], color[sl]
        lo_p, hi_p = pos.min(0), pos.max(0)
        lo_s, hi_s = lsc.min(0), lsc.max(0)
        lo_c, hi_c = col.min(0), col.max(0)
        for i, ax in enumerate("xyz"):
            chunks[c][f"min_{ax}"] = lo_p[i]
            chunks[c][f"max_{ax}"] = hi_p[i]
            chunks[c][f"min_scale_{ax}"] = lo_s[i]
            chunks[c][f"max_scale_{ax}"] = hi_s[i]
        for i, ch in enumerate("rgb"):
            chunks[c][f"min_{ch}"] = lo_c[i]
            chunks[c][f"max_{ch}"] = hi_c[i]

        def unit(v, lo, hi):
            return (v - lo) / np.maximum(hi - lo, 1e-12)

        up = unit(pos, lo_p, hi_p)
        us = unit(lsc, lo_s, hi_s)
        uc = unit(col, lo_c, hi_c)
        verts["packed_position"][sl] = (_pack_unorm(up[:, 0], 21, 11)
                                        | _pack_unorm(up[:, 1], 11, 10)
                                        | _pack_unorm(up[:, 2], 0, 11))
        verts["packed_scale"][sl] = (_pack_unorm(us[:, 0], 21, 11)
                                     | _pack_unorm(us[:, 1], 11, 10)
                                     | _pack_unorm(us[:, 2], 0, 11))
        verts["packed_color"][sl] = (_pack_unorm(uc[:, 0], 24, 8)
                                     | _pack_unorm(uc[:, 1], 16, 8)
                                     | _pack_unorm(uc[:, 2], 8, 8)
                                     | _pack_unorm(opacity[sl], 0, 8))

    # 2-bit largest-component quaternion: ``which`` selects the LARGEST of
    # (w, x, y, z); the other three are stored in the decoder's layout
    # (which=0 stores (x,y,z); 1 -> (w,y,z); 2 -> (w,x,z); 3 -> (w,x,y))
    q = ds.rotations / np.maximum(
        np.linalg.norm(ds.rotations, axis=-1, keepdims=True), 1e-12)
    wxyz = np.stack([q[:, 3], q[:, 0], q[:, 1], q[:, 2]], -1)
    which = np.argmax(np.abs(wxyz), axis=-1)
    sign = np.sign(np.take_along_axis(wxyz, which[:, None], 1)[:, 0])
    wxyz = wxyz * np.where(sign == 0, 1.0, sign)[:, None]
    stored = np.empty((n, 3), np.float32)
    for w_val, keep in ((0, (1, 2, 3)), (1, (0, 2, 3)), (2, (0, 1, 3)),
                        (3, (0, 1, 2))):
        m = which == w_val
        stored[m] = wxyz[m][:, keep]
    norm = np.sqrt(2.0) * 0.5
    u = stored * norm + 0.5
    verts["packed_rotation"] = (which.astype(np.uint32) << np.uint32(30)
                                | _pack_unorm(u[:, 0], 20, 10)
                                | _pack_unorm(u[:, 1], 10, 10)
                                | _pack_unorm(u[:, 2], 0, 10))

    header = ["ply", "format binary_little_endian 1.0",
              f"element chunk {n_chunks}"]
    header += [f"property float {f}" for f in chunk_fields]
    header += [f"element vertex {n}"]
    header += [f"property uint {f}" for f in vdt.names]
    header.append("end_header")
    out = (("\n".join(header) + "\n").encode("ascii")
           + chunks.tobytes() + verts.tobytes())
    if path is not None:
        if hasattr(path, "write"):
            path.write(out)
        else:
            with open(path, "wb") as f:
                f.write(out)
    return out


# --- Writer -----------------------------------------------------------------------

def write_ply(ds: GaussianDataset, path, *, log_scale: bool = True,
              logit_opacity: bool = True, sh_degree: int | None = None):
    """Write a standard 3DGS binary-little-endian PLY."""
    n = ds.count
    n_coeffs = ds.harmonics.shape[1] if sh_degree is None else (sh_degree + 1) ** 2
    higher = n_coeffs - 1
    fields = (["x", "y", "z"] + [f"f_dc_{i}" for i in range(3)]
              + [f"f_rest_{i}" for i in range(3 * higher)]
              + ["opacity"] + [f"scale_{i}" for i in range(3)]
              + [f"rot_{i}" for i in range(4)])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {f}" for f in fields]
    header.append("end_header")

    dt = np.dtype([(f, "<f4") for f in fields])
    rec = np.zeros(n, dt)
    rec["x"], rec["y"], rec["z"] = ds.positions.T
    for i in range(3):
        rec[f"f_dc_{i}"] = ds.harmonics[:, 0, i]
    for ch in range(3):
        for c in range(higher):
            rec[f"f_rest_{ch * higher + c}"] = ds.harmonics[:, 1 + c, ch]
    op = np.clip(ds.opacities, 1e-6, 1 - 1e-6)
    rec["opacity"] = np.log(op / (1 - op)) if logit_opacity else ds.opacities
    sc = np.log(np.maximum(ds.scales, 1e-12)) if log_scale else ds.scales
    rec["scale_0"], rec["scale_1"], rec["scale_2"] = sc.T
    # rot_0 = w, rot_1..3 = x, y, z
    rec["rot_0"] = ds.rotations[:, 3]
    rec["rot_1"] = ds.rotations[:, 0]
    rec["rot_2"] = ds.rotations[:, 1]
    rec["rot_3"] = ds.rotations[:, 2]

    buf = _io.BytesIO()
    buf.write(("\n".join(header) + "\n").encode("ascii"))
    buf.write(rec.tobytes())
    out = buf.getvalue()
    if hasattr(path, "write"):
        path.write(out)
    else:
        with open(path, "wb") as f:
            f.write(out)
    return out
