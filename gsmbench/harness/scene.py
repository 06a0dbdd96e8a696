"""Synthetic scenes with the statistics of trained 3DGS captures, made on
the device from a seed.

The statistics are those of ``io/scene.py::generate_realistic_gaussians``
(frozen here): surface-clustered positions (35% a ground plane, 45% the
surfaces of 12 blobby objects, the rest a sparse far background shell),
log-normal scales (median 0.012, sigma 0.9; the background's six times
larger, clipped to [1e-4, 2.5]) with surfel-like anisotropy, bimodal
opacity (55% solid, uniform in [0.65, 1]; the rest Beta(1.2, 4)), SH with
the DC colour uniform in [0.05, 0.95] and the higher bands N(0, 0.06), in
Morton order.  Two layouts:

- ``frontal``: the generator's own, a scene in front of a camera at the
  origin looking along +z (ground at y = -1, z in [1, 14]; objects within
  x in [-3, 3], z in [2, 10]; the shell in front, 15-30 units away);
- ``orbit``: the same statistics made even in azimuth around the origin, as
  a scene captured on a 360-degree orbit about a central object: a ground
  disk, the objects within ``object_radius`` of the centre, the shell all
  around above the horizon.

``scale_factor`` multiplies every scale (a larger scene keeps the per-pixel
depth complexity of a smaller one when its splats shrink by sqrt(n0 / n)).
The scene's structure, the 12 objects' centres and radii, comes from the
configuration's ``structure_seed``, the same for every run; every gaussian
is drawn from the run's seed.  (Twelve objects drawn anew each run moved
the work of a frame by up to a third between seeds: an object near the
camera covers much of the screen.)  Everything is drawn with
``torch.Generator``s on the device, in a few large calls, and stored in the
precision the renderer is given.
"""

from __future__ import annotations

import math

import torch


def _gamma(gen, shape: float, n: int, device):
    """Gamma(shape, 1) by Marsaglia and Tsang (shape >= 1), a few rounds of
    resampling for the rejected draws."""
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, device=device)
    todo = torch.arange(n, device=device)
    while len(todo):
        m = len(todo)
        x = torch.randn(m, generator=gen, device=device)
        u = torch.rand(m, generator=gen, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    return out


def _uniform(gen, lo, hi, shape, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _spread(v):
    """Interleave the low 21 bits of int64 ``v`` with two zero bits."""
    v = v & 0x1FFFFF
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        v = (v | (v << shift)) & mask
    return v


def morton_order(pos):
    """Stable order of 63-bit Morton codes over the scene's bounding box."""
    lo = pos.min(0).values
    extent = torch.clamp(pos.max(0).values - lo, min=1e-12)
    top = float((1 << 21) - 1)
    q = torch.clamp((pos - lo) * (top / extent), 0.0, top).to(torch.int64)
    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)
    return torch.sort(code, stable=True).indices


def make_scene(spec: dict, seed: int, device, dtype=torch.float16) -> dict:
    """The renderer's inputs for ``spec`` (a configuration's ``scene``:
    ``count``, ``sh_degree``, ``layout``, ``structure_seed``,
    ``scale_factor`` and, for the orbit layout, ``ground_radius``,
    ``object_radius``): positions (N, 3)
    float32, scales (N, 3), rotations (N, 4) (x, y, z, w), opacities (N,)
    and channel-planar harmonics (3, K, N) in ``dtype``."""
    n = int(spec["count"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_ground = int(n * 0.35)
    n_obj = int(n * 0.45)
    n_bg = n - n_ground - n_obj
    sgen = torch.Generator(device=device)
    sgen.manual_seed(int(spec["structure_seed"]))
    u = lambda lo, hi, shape: _uniform(gen, lo, hi, shape, device)  # noqa: E731
    su = lambda lo, hi, shape: _uniform(sgen, lo, hi, shape, device)  # noqa: E731
    if spec["layout"] == "frontal":
        ground = torch.stack([u(-6.0, 6.0, n_ground),
                              -1.0 + 0.03 * torch.randn(n_ground, generator=gen, device=device),
                              u(1.0, 14.0, n_ground)], -1)
        centres = torch.stack([su(-3.0, 3.0, 12), su(-0.8, 1.2, 12), su(2.0, 10.0, 12)], -1)
    elif spec["layout"] == "orbit":
        r = spec["ground_radius"] * torch.sqrt(u(0.0, 1.0, n_ground))
        a = u(0.0, 2.0 * math.pi, n_ground)
        ground = torch.stack([r * torch.cos(a),
                              -1.0 + 0.03 * torch.randn(n_ground, generator=gen, device=device),
                              r * torch.sin(a)], -1)
        rc = spec["object_radius"] * torch.sqrt(su(0.0, 1.0, 12))
        ac = su(0.0, 2.0 * math.pi, 12)
        centres = torch.stack([rc * torch.cos(ac), su(-0.8, 1.2, 12), rc * torch.sin(ac)], -1)
    else:
        raise ValueError(f"unknown scene layout {spec['layout']!r}")
    radii = su(0.25, 0.9, 12)
    which = torch.randint(0, 12, (n_obj,), generator=gen, device=device)
    dirs = torch.randn((n_obj, 3), generator=gen, device=device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rr = radii[which] * (0.85 + 0.15 * torch.rand(n_obj, generator=gen, device=device))
    objs = centres[which] + dirs * rr[:, None]
    bdir = torch.randn((n_bg, 3), generator=gen, device=device)
    if spec["layout"] == "frontal":
        bdir[:, 2] = bdir[:, 2].abs() + 0.4
    else:
        bdir[:, 1] = bdir[:, 1].abs()
    bdir = bdir / torch.linalg.norm(bdir, dim=-1, keepdim=True)
    bg = bdir * u(15.0, 30.0, n_bg)[:, None]
    positions = torch.cat([ground, objs, bg]).float()

    base = torch.exp(math.log(0.012) + 0.9 * torch.randn(n, generator=gen, device=device))
    base[n_ground + n_obj:] *= 6.0
    base = torch.clamp(base, 1e-4, 2.5) * float(spec.get("scale_factor", 1.0))
    aniso = torch.stack([torch.ones(n, device=device),
                         torch.exp(0.35 * torch.randn(n, generator=gen, device=device)),
                         torch.exp(-1.6 + 0.5 * torch.randn(n, generator=gen, device=device))], -1)
    scales = base[:, None] * aniso
    quats = torch.randn((n, 4), generator=gen, device=device)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    solid = torch.rand(n, generator=gen, device=device) < 0.55
    x, y = _gamma(gen, 1.2, n, device), _gamma(gen, 4.0, n, device)
    opacities = torch.where(solid, u(0.65, 1.0, n), x / (x + y))
    k = (int(spec["sh_degree"]) + 1) ** 2
    harm = 0.06 * torch.randn((3, k, n), generator=gen, device=device)
    harm[:, 0] = (u(0.05, 0.95, (3, n)) - 0.5) / 0.28209479
    order = morton_order(positions)
    return dict(positions=positions[order].contiguous(),
                scales=scales[order].to(dtype).contiguous(),
                rotations=quats[order].to(dtype).contiguous(),
                opacities=opacities[order].to(dtype).contiguous(),
                harmonics=harm.to(dtype)[:, :, order].contiguous())
