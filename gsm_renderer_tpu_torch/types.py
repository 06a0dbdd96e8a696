"""Core value types: gaussian inputs, frame headers, render outputs.

PyTorch counterpart of ``gsm_renderer_tpu/types.py``.  ``GaussianInput`` keeps
the JAX package's structure-of-arrays layout, harmonics included:
channel-planar ``(3, n_coeffs, N)``, so every SH term is one contiguous
``(N,)`` plane for the projection kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Precision, sh_components


class RendererError(ValueError):
    """Validation failure (bad shapes, sizes beyond the configured limits)."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no card and no explicit device this raises instead of
    carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gsm_renderer_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class GaussianInput:
    """SoA gaussian scene input on one device.

    ``positions`` (N, 3) float32; ``scales`` (N, 3), ``rotations`` (N, 4)
    quaternion (x, y, z, w) and ``opacities`` (N,) in the input precision;
    ``harmonics`` channel-planar (3, n_coeffs, N).
    """

    positions: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    opacities: torch.Tensor
    harmonics: torch.Tensor

    @property
    def count(self) -> int:
        return self.positions.shape[0]

    @property
    def sh_n_coeffs(self) -> int:
        return self.harmonics.shape[1]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def validate(self) -> None:
        n = self.positions.shape[0]
        checks = [
            (self.positions.shape, (n, 3), "positions"),
            (self.scales.shape, (n, 3), "scales"),
            (self.rotations.shape, (n, 4), "rotations"),
            (self.opacities.shape, (n,), "opacities"),
        ]
        for got, want, name in checks:
            if tuple(got) != tuple(want):
                raise RendererError(f"{name}: expected shape {want}, got {tuple(got)}")
        if (self.harmonics.ndim != 3 or self.harmonics.shape[0] != 3
                or self.harmonics.shape[2] != n):
            raise RendererError(
                f"harmonics: expected channel-planar (3, n_coeffs, N), got "
                f"{tuple(self.harmonics.shape)}")
        if self.harmonics.shape[1] not in (1, 4, 9, 16):
            raise RendererError(
                f"harmonics: n_coeffs must be one of 1/4/9/16, got "
                f"{self.harmonics.shape[1]}")


def make_gaussian_input(positions, scales, rotations, opacities, harmonics,
                        precision: Precision = Precision.FLOAT32,
                        device=None) -> GaussianInput:
    """Build a validated :class:`GaussianInput` on ``device`` (the card by
    default), cast to the requested precision.  ``harmonics`` may come in the
    natural (N, n_coeffs, 3) order or channel-planar (3, n_coeffs, N)."""
    dev = resolve_device(device)
    dt = torch.float32 if precision == Precision.FLOAT32 else torch.float16
    npdt = np.float32 if precision == Precision.FLOAT32 else np.float16
    harmonics = np.asarray(harmonics)
    if harmonics.ndim == 3 and harmonics.shape[2] == 3 and harmonics.shape[0] != 3:
        harmonics = harmonics.transpose(2, 1, 0)

    def put(x, np_dtype, dtype):
        x = np.ascontiguousarray(np.asarray(x).astype(np_dtype))
        return torch.from_numpy(x).to(device=dev, dtype=dtype)

    gi = GaussianInput(
        positions=put(positions, np.float32, torch.float32),
        scales=put(scales, npdt, dt),
        rotations=put(rotations, npdt, dt),
        opacities=put(opacities, npdt, dt),
        harmonics=put(harmonics, npdt, dt),
    )
    gi.validate()
    return gi


# --- Packed byte-layout codecs (host side, numpy) ----------------------------

_PACKED_F32_DTYPE = np.dtype([
    ("px", "<f4"), ("py", "<f4"), ("pz", "<f4"),
    ("opacity", "<f4"),
    ("sx", "<f4"), ("sy", "<f4"), ("sz", "<f4"),
    ("_pad0", "<f4"),
    ("rx", "<f4"), ("ry", "<f4"), ("rz", "<f4"), ("rw", "<f4"),
])  # 48 bytes a gaussian

_PACKED_F16_DTYPE = np.dtype([
    ("px", "<f4"), ("py", "<f4"), ("pz", "<f4"),
    ("opacity", "<f2"),
    ("sx", "<f2"), ("sy", "<f2"), ("sz", "<f2"),
    ("rx", "<f2"), ("ry", "<f2"), ("rz", "<f2"), ("rw", "<f2"),
    ("_pad0", "<f2"), ("_pad1", "<f2"),
])  # 32 bytes a gaussian


def unpack_world_gaussians(buf, precision: Precision, harmonics_buf=None,
                           sh_degree: int = 0, device=None) -> GaussianInput:
    """Decode the reference's packed byte layouts (48-byte float32 or
    32-byte float16 records) into a :class:`GaussianInput` on ``device``
    (the card by default).  ``harmonics_buf``: the planar per-channel SH
    buffer, count * n_coeffs * 3 values ([R0..Rn, G0..Gn, B0..Bn] a
    gaussian), float32 or float16 as ``precision``; zeros when None."""
    dtype = _PACKED_F32_DTYPE if precision == Precision.FLOAT32 else _PACKED_F16_DTYPE
    if isinstance(buf, (bytes, bytearray, memoryview)):
        rec = np.frombuffer(buf, dtype=dtype)
    else:
        rec = np.ascontiguousarray(buf).view(dtype).reshape(-1)
    n = rec.shape[0]
    positions = np.stack([rec["px"], rec["py"], rec["pz"]], axis=-1)
    scales = np.stack([rec["sx"], rec["sy"], rec["sz"]], axis=-1)
    rotations = np.stack([rec["rx"], rec["ry"], rec["rz"], rec["rw"]], axis=-1)
    n_coeffs = sh_components(sh_degree)
    hdt = np.float32 if precision == Precision.FLOAT32 else np.float16
    if harmonics_buf is None:
        harmonics = np.zeros((n, n_coeffs, 3), hdt)
    else:
        flat = (np.frombuffer(harmonics_buf, dtype=hdt)
                if isinstance(harmonics_buf, (bytes, bytearray, memoryview))
                else np.asarray(harmonics_buf, hdt).reshape(-1))
        expected = n * n_coeffs * 3
        if flat.size != expected:
            raise RendererError(
                f"harmonics buffer: expected {expected} values "
                f"(count={n} x coeffs={n_coeffs} x 3), got {flat.size}")
        harmonics = flat.reshape(n, 3, n_coeffs).transpose(0, 2, 1)
    return make_gaussian_input(positions, scales, rotations, rec["opacity"],
                               harmonics, precision, device=device)


def pack_world_gaussians(gi: GaussianInput,
                         precision: Precision) -> tuple[bytes, bytes]:
    """Encode a :class:`GaussianInput` into the reference's packed byte
    layouts: (world bytes, planar harmonics bytes)."""
    dtype = _PACKED_F32_DTYPE if precision == Precision.FLOAT32 else _PACKED_F16_DTYPE

    def host(t):
        return t.detach().cpu().numpy()

    rec = np.zeros(gi.count, dtype)
    pos = host(gi.positions).astype(np.float32)
    rec["px"], rec["py"], rec["pz"] = pos[:, 0], pos[:, 1], pos[:, 2]
    sc = host(gi.scales)
    rec["sx"], rec["sy"], rec["sz"] = sc[:, 0], sc[:, 1], sc[:, 2]
    rot = host(gi.rotations)
    rec["rx"], rec["ry"], rec["rz"], rec["rw"] = (rot[:, 0], rot[:, 1],
                                                  rot[:, 2], rot[:, 3])
    rec["opacity"] = host(gi.opacities)
    hdt = np.float32 if precision == Precision.FLOAT32 else np.float16
    # stored (3, n_coeffs, N) -> the reference's (N, 3, n_coeffs) planar
    harm = host(gi.harmonics).astype(hdt).transpose(2, 0, 1)
    return rec.tobytes(), np.ascontiguousarray(harm).tobytes()


@dataclasses.dataclass
class RenderRecord:
    """SoA form of the 16-byte quantized render record: screen mean, sigmas
    and depth as float16, theta as u16 in [0, pi) (held in int32), color
    (N, 3) and opacity as u8."""

    mean_x: torch.Tensor
    mean_y: torch.Tensor
    theta: torch.Tensor
    sigma1: torch.Tensor
    sigma2: torch.Tensor
    depth: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor


@dataclasses.dataclass
class FrameHeader:
    """Frame counters as 0-d int32 tensors on the render device.

    ``overflow`` is 1 when the capacity clamp dropped instances (the frame
    still renders); ``slot_total`` is the unclamped expansion-slot demand
    that adaptive capacity sizing reads; ``row_total`` is the virtual-row
    demand of the row decomposition (measured even while it is off)."""

    visible_count: torch.Tensor
    total_instances: torch.Tensor
    overflow: torch.Tensor
    slot_total: torch.Tensor | None = None
    row_total: torch.Tensor | None = None


@dataclasses.dataclass
class RenderOutput:
    """Frame output: color (H, W, 4), optional depth (H, W), and the header."""

    color: torch.Tensor
    depth: torch.Tensor | None
    header: FrameHeader
