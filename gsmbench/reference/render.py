"""Plain PyTorch reference of the renderer's frame: mono, and foveated
stereo.

What a frame is, independent of how the renderer computes it:

1. Each gaussian is projected (EWA splatting: a 3-D covariance R S S^T R^T,
   its 2-D image under the local affine camera plus a 0.3 px low-pass,
   stabilized: variance floors, a determinant repair, the largest
   eigenvalue clamped to (2/3 of the larger screen side)^2 and an axis
   ratio of at most 256) and culled: too small (largest scale under
   0.0005), behind the near plane or past the far plane, opacity under the
   alpha threshold, a degenerate ellipse, a 3-sigma radius under half a
   pixel, too little total ink (opacity * 2 pi * sqrt(det) under the
   depth-adaptive threshold), off screen, or (mono) a quantized opacity
   that cannot reach the alpha threshold.
2. It becomes a 16-byte render record (the upstream's quantized record):
   mean and the ellipse's sigmas and depth as float16, its orientation as
   u16 over [0, pi), colour and opacity as u8 (truncated).  Colour is the
   degree-3 spherical-harmonic colour seen from the camera centre (stereo:
   the mid-eye centre), + 0.5, floored at 0.
3. It is binned into the 16x16 tiles of its 3-sigma screen box where the
   quantized ellipse reaches the cutoff inside the tile: q <= -2
   ln(threshold / opacity) (mono), q <= 9 in either eye (stereo).  A
   foveated frame's tiles are the physical target's, each covering the
   display rect between its boundaries' display coordinates.
4. Each tile composites its gaussians front to back by (depth, index):
   alpha = min(0.99, opacity * exp(-q / 2)) at the pixel's sample point (the
   integer pixel corner, or the foveated pixel's display coordinate),
   stereo zeroing alpha where q > 9; colour += alpha T c, depth += alpha T
   d, T *= 1 - alpha.  The tile's records are taken in batches of 256 ranks
   aligned to 128-rank blocks of the frame's tile-major order; after a
   batch the tile stops once every pixel's T (the larger eye's) is under
   1/255.  Output alpha is 1 - T.  The batches' alignment follows from
   every earlier tile's record count, so one tile test decided the other
   way by float rounding moves where later tiles stop; wherever a tile
   stops, it is after the rank at which all its pixels fell under 1/255,
   so a pixel's colour and alpha can move by at most its T at that rank
   (its depth by that times the tile's deepest record): the frame's
   ``slack``, which the comparison allows.

The reference is computed in blocks (gaussians, tile-gaussian pairs and
tiles) so that it fits beside the renderer on the device.  ``dtype``
selects the arithmetic: float32, or a lower precision for the control.
It also counts the work any implementation of a stage must do
(:class:`Frame` ``counts``), which the benchmark's rooflines read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

MIN_SCALE = 0.0005
MIN_RADIUS = 0.5
LOW_PASS = 0.3
MIN_VAR = 1e-4
MIN_DET = 1e-8
MAX_AXIS_RATIO = 256.0
SIGMAS = 3.0
STEREO_Q_CUTOFF = 9.0
ALPHA_MAX = 0.99
EXIT_T = 1.0 / 255.0
BATCH, BLOCK = 256, 128
THETA_UNIT = 3.14159265358979 / 65535.0
INVISIBLE = -6e4


@dataclasses.dataclass
class Frame:
    """One reference frame: ``color`` (H, n_eyes * W, 4) float32, ``depth``
    (H, n_eyes * W) float32, ``visible`` the header's visible count,
    ``counts`` of the work a stage must do, and the exit's ``slack`` of
    colour and alpha and ``slack_depth`` of depth (H, n_eyes * W; 0 in
    a tile that never saturates)."""

    color: torch.Tensor
    depth: torch.Tensor
    visible: int
    counts: dict
    slack: torch.Tensor
    slack_depth: torch.Tensor


def _f16(x):
    """Round to float16 and back, subnormals read as 0 (the record's
    decode)."""
    h = x.float().to(torch.float16).float()
    return torch.where(h.abs() < 2.0 ** -14, 0.0, h)


def _u8(x):
    return torch.clamp(x.float() * 255.0, 0.0, 255.0).floor()


def _mat(m, dtype, device):
    return torch.as_tensor(np.asarray(m, np.float32), device=device).to(dtype)


def _sh_colour(harm, d, degree: int):
    """(N, 3) SH colour of channel-planar ``harm`` (3, K, N) along unit
    directions ``d`` (3, N)."""
    x, y, z = d
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    out = []
    for ch in range(3):
        acc = harm[ch, 0] * basis[0]
        for k in range(1, len(basis)):
            acc = acc + harm[ch, k] * basis[k]
        out.append(torch.clamp(acc + 0.5, min=0.0))
    return out


def _cov3d(scales, quat):
    """Upper triangle of R S S^T R^T, quaternion (x, y, z, w) normalized."""
    q = quat / torch.sqrt(torch.clamp((quat * quat).sum(0), min=1e-8))
    x, y, z, w = q
    r = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    m = [[r[i][j] * scales[j] for j in range(3)] for i in range(3)]
    return {(i, j): m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
            for i in range(3) for j in range(i, 3)}


def _eig(a, b, d, floor):
    """Eigenvalues (lam1 >= lam2, each floored) and the unit major axis."""
    det = a * d - b * b
    mid = 0.5 * (a + d)
    root = torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    lam1 = mid + root
    lam2 = torch.clamp(mid - root, min=floor)
    use_b = b.abs() > 1e-8
    vx = torch.where(use_b, b, (a >= d).to(a.dtype))
    vy = torch.where(use_b, lam1 - a, (a < d).to(a.dtype))
    return lam1, lam2, vx, vy


class Eye:
    """One camera's projection chain over a block of gaussians."""

    def __init__(self, view, proj, width, height, near, far, dtype, device):
        self.v = _mat(view, dtype, device)
        self.p = _mat(proj, dtype, device)
        self.width, self.height = width, height
        self.near, self.far = near, far
        p00, p11 = abs(float(proj[0][0])), abs(float(proj[1][1]))
        self.lim = (1.3 / max(p00, 1e-4), 1.3 / max(p11, 1e-4))
        self.focal = (width * p00 * 0.5, height * p11 * 0.5)
        self.max_eig = (max(width, height) * 2.0 / SIGMAS) ** 2

    def project(self, pos, cov):
        v, p = self.v, self.p
        view = [v[i, 0] * pos[0] + v[i, 1] * pos[1] + v[i, 2] * pos[2] + v[i, 3]
                for i in range(3)]
        clip = [p[i, 0] * view[0] + p[i, 1] * view[1] + p[i, 2] * view[2]
                + p[i, 3] for i in range(4)]
        w = clip[3]
        ok = (w > self.near) & (w <= self.far)
        inv_w = 1.0 / torch.where(w.abs() > 1e-12, w, 1e-12)
        sx = (clip[0] * inv_w + 1.0) * (0.5 * self.width)
        sy = (clip[1] * inv_w + 1.0) * (0.5 * self.height)
        # the local affine camera (EWA), with the view direction clamped to
        # 1.3x the field of view
        z = view[2]
        az = torch.clamp(z.abs(), min=1e-4)
        sign = torch.where(z >= 0.0, 1.0, -1.0).to(z.dtype)
        xc = torch.clamp(view[0] / az, -self.lim[0], self.lim[0]) * az
        yc = torch.clamp(view[1] / az, -self.lim[1], self.lim[1]) * az
        fx, fy = self.focal
        j = [(fx / az, -fx * xc * sign / (az * az)),
             (fy / az, -fy * yc * sign / (az * az))]
        t = [[j[r][0] * v[r, k] + j[r][1] * v[2, k] for k in range(3)]
             for r in range(2)]
        s = [[cov[(min(i, k), max(i, k))] for k in range(3)] for i in range(3)]
        ts = [[sum(t[r][i] * s[i][k] for i in range(3)) for k in range(3)]
              for r in range(2)]
        a = sum(ts[0][k] * t[0][k] for k in range(3)) + LOW_PASS
        b = sum(ts[0][k] * t[1][k] for k in range(3))
        d = sum(ts[1][k] * t[1][k] for k in range(3)) + LOW_PASS
        a, b, d = self._stabilize(a, b, d)
        # sigmas and orientation of the stabilized ellipse
        a1, d1 = torch.clamp(a, min=1e-8), torch.clamp(d, min=1e-8)
        lam1, lam2, vx, vy = _eig(a1, b, d1, 1e-8)
        lam1 = torch.clamp(lam1, min=1e-8)
        det = a1 * d1 - b * b
        ok &= torch.isfinite(det) & (det > 0.0)
        norm = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=1e-12)
        theta = torch.atan2(vy / norm, vx / norm)
        theta = torch.remainder(theta, math.pi)
        s1, s2 = torch.sqrt(lam1), torch.sqrt(lam2)
        ok &= torch.isfinite(s1) & torch.isfinite(s2)
        ok &= SIGMAS * torch.maximum(s1, s2) >= MIN_RADIUS
        # the axis-aligned extent of the 3-sigma box
        det_b = a * d - b * b
        mid = 0.5 * (a + d)
        root = torch.sqrt(torch.clamp(mid * mid - det_b, min=1e-6))
        e1 = SIGMAS * torch.sqrt(torch.clamp(mid + root, min=1e-6))
        e2 = SIGMAS * torch.sqrt(torch.clamp(mid - root, min=1e-6))
        use_b = b.abs() > 1e-6
        ux = torch.where(use_b, b, (a >= d).to(a.dtype))
        uy = torch.where(use_b, mid + root - a, (a < d).to(a.dtype))
        un = torch.clamp(torch.sqrt(ux * ux + uy * uy), min=1e-6)
        ux, uy = (ux / un).abs(), (uy / un).abs()
        ex, ey = ux * e1 + uy * e2, uy * e1 + ux * e2
        ok &= ~((sx + ex < 0.0) | (sx - ex > self.width)
                | (sy + ey < 0.0) | (sy - ey > self.height))
        return dict(ok=ok, sx=sx, sy=sy, depth=w, theta=theta, s1=s1, s2=s2,
                    det=det_b, ex=ex, ey=ey)

    def _stabilize(self, a, b, d):
        finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(d)
        a = torch.clamp(torch.where(finite, a, 1.0), min=MIN_VAR)
        b = torch.where(finite, b, 0.0)
        d = torch.clamp(torch.where(finite, d, 1.0), min=MIN_VAR)
        det = a * d - b * b
        det = torch.where(torch.isfinite(det), det, 0.0)
        bump = torch.where(det < MIN_DET, (MIN_DET - det) + MIN_VAR, 0.0)
        a, d = a + bump, d + bump
        lam1, lam2, vx, vy = _eig(a, b, d, MIN_VAR)
        inv = 1.0 / torch.clamp(torch.sqrt(vx * vx + vy * vy), min=1e-8)
        vx, vy = vx * inv, vy * inv
        lam1 = torch.clamp(lam1, max=self.max_eig)
        lam2 = torch.maximum(lam2, lam1 / (MAX_AXIS_RATIO * MAX_AXIS_RATIO))
        na = lam1 * vx * vx + lam2 * vy * vy
        nb = lam1 * vx * vy - lam2 * vy * vx
        nd = lam1 * vy * vy + lam2 * vx * vx
        return (torch.where(finite, na, 1.0), torch.where(finite, nb, 0.0),
                torch.where(finite, nd, 1.0))

    def tile_rect(self, e, tile_w, tile_h):
        """Inclusive tile rect of the 3-sigma box, clamped to the screen."""
        tiles_x = -(-self.width // tile_w)
        tiles_y = -(-self.height // tile_h)
        x0 = torch.clamp(e["sx"] - e["ex"], 0.0, self.width - 1.0)
        x1 = torch.clamp(e["sx"] + e["ex"], 0.0, self.width - 1.0)
        y0 = torch.clamp(e["sy"] - e["ey"], 0.0, self.height - 1.0)
        y1 = torch.clamp(e["sy"] + e["ey"], 0.0, self.height - 1.0)
        return (torch.floor(x0.float() / tile_w).long().clamp(min=0),
                (torch.ceil(x1.float() / tile_w).long() - 1).clamp(max=tiles_x - 1),
                torch.floor(y0.float() / tile_h).long().clamp(min=0),
                (torch.ceil(y1.float() / tile_h).long() - 1).clamp(max=tiles_y - 1))


def _ink_factor(depth, near, far):
    af = far * 0.02
    t = torch.clamp((af - depth) / (af - near), 0.0, 1.0)
    return 1.0 - t * t


def _record(e, visible):
    """The quantized record of one eye (float32 fields); an eye that does
    not see a gaussian gets a mean far off screen."""
    theta = torch.clamp(torch.floor(e["theta"].float() * (65535.0 / math.pi)
                                    + 0.5), 0.0, 65535.0) * THETA_UNIT
    theta = torch.where(visible, theta, 0.0)
    s1 = torch.where(visible, torch.clamp(_f16(e["s1"]), min=1e-4), 1.0)
    s2 = torch.where(visible, torch.clamp(_f16(e["s2"]), min=1e-4), 1.0)
    c, s = torch.cos(theta), torch.sin(theta)
    return dict(mx=torch.where(visible, _f16(e["sx"]), INVISIBLE),
                my=torch.where(visible, _f16(e["sy"]), INVISIBLE),
                a1=c / s1, b1=s / s1, a2=-s / s2, b2=c / s2,
                depth=torch.where(visible, _f16(e["depth"]), 0.0))


def _min_q(rec, x0, x1, y0, y1, i):
    """The smallest q of record ``i`` over the pixel rect [x0, x1] x
    [y0, y1] (the ellipse's quadratic form is convex: the minimum lies at
    the mean, or on the rect's border where the form's gradient points
    out)."""
    a1, b1, a2, b2 = (rec[k][i] for k in ("a1", "b1", "a2", "b2"))
    ca, cb, cc = a1 * a1 + a2 * a2, a1 * b1 + a2 * b2, b1 * b1 + b2 * b2
    xa, xb = x0 - rec["mx"][i], x1 - rec["mx"][i]
    ya, yb = y0 - rec["my"][i], y1 - rec["my"][i]
    inside = (xa <= 0) & (xb >= 0) & (ya <= 0) & (yb >= 0)

    def q(x, y):
        return ca * x * x + 2.0 * cb * x * y + cc * y * y

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    ica = 1.0 / torch.clamp(ca, min=1e-20)
    icc = 1.0 / torch.clamp(cc, min=1e-20)
    best = torch.minimum(
        torch.minimum(q(xa, clip(-cb * icc * xa, ya, yb)),
                      q(xb, clip(-cb * icc * xb, ya, yb))),
        torch.minimum(q(clip(-cb * ica * ya, xa, xb), ya),
                      q(clip(-cb * ica * yb, xa, xb), yb)))
    return torch.where(inside, 0.0, best)


class Reference:
    """Reference frames of one scene.  ``scene``: the inputs the renderer
    gets -- ``positions`` (N, 3), ``scales`` (N, 3), ``rotations`` (N, 4)
    (x, y, z, w), ``opacities`` (N,), ``harmonics`` channel-planar (3, K,
    N).  ``dtype``: the arithmetic (float32; the control's lower
    precision)."""

    def __init__(self, scene, *, sh_degree: int, alpha_threshold: float = 0.005,
                 ink_threshold: float = 2.0, tile: int = 16,
                 dtype=torch.float32, block: int = 1 << 20,
                 pair_block: int = 1 << 24, tile_block: int = 2048,
                 chunk: int = 32):
        self.scene = scene
        self.n = scene["positions"].shape[0]
        self.device = scene["positions"].device
        self.sh_degree = sh_degree
        self.alpha_threshold = alpha_threshold
        self.ink_threshold = ink_threshold
        self.tile = tile
        self.dtype = dtype
        self.block, self.pair_block = block, pair_block
        self.tile_block, self.chunk = tile_block, chunk

    def _inputs(self, lo, hi):
        s = self.scene
        k = (self.sh_degree + 1) ** 2
        dt = self.dtype
        return (s["positions"][lo:hi].to(dt).T, s["scales"][lo:hi].to(dt).T,
                s["rotations"][lo:hi].to(dt).T, s["opacities"][lo:hi].to(dt),
                s["harmonics"][:, :k, lo:hi].to(dt))

    # ---- projection ------------------------------------------------------

    def _project_mono(self, cam, width, height):
        eye = Eye(cam["view"], cam["proj"], width, height, cam["near"],
                  cam["far"], self.dtype, self.device)
        tau = max(self.alpha_threshold, 1e-12)
        out = []
        for lo in range(0, self.n, self.block):
            pos, sc, rot, op, harm = self._inputs(lo, lo + self.block)
            e = eye.project(pos, _cov3d(sc, rot))
            ok = e["ok"] & (sc.max(0).values >= MIN_SCALE)
            ok &= op >= self.alpha_threshold
            ink = op * 6.283185 * torch.sqrt(torch.clamp(e["det"], min=1e-12))
            ok &= ink >= _ink_factor(e["depth"], cam["near"], cam["far"]) \
                * self.ink_threshold
            rect = eye.tile_rect(e, self.tile, self.tile)
            ok &= (rect[0] <= rect[1]) & (rect[2] <= rect[3])
            op_q = _u8(op) / 255.0
            ok &= op_q >= tau
            centre = _mat(cam["position"], self.dtype, self.device)
            d = centre[:, None] - pos
            d = d / torch.sqrt(torch.clamp((d * d).sum(0), min=1e-24))
            rgb = _sh_colour(harm, d, self.sh_degree)
            rec = _record(e, ok)
            rec.update(rgb=torch.stack([_u8(c) / 255.0 for c in rgb]),
                       op=op_q, cutoff=-2.0 * torch.log(tau / op_q.clamp(min=1e-30)))
            out.append(dict(ok=ok, key_depth=e["depth"].float(), rect=rect,
                            recs=[rec]))
        return self._cat(out)

    def _project_stereo(self, rig, width, height):
        eyes = [Eye(c["view"], c["proj"], width, height, c["near"], c["far"],
                    self.dtype, self.device) for c in rig]
        near, far = rig[0]["near"], rig[0]["far"]
        out = []
        for lo in range(0, self.n, self.block):
            pos, sc, rot, op, harm = self._inputs(lo, lo + self.block)
            cov = _cov3d(sc, rot)
            shared = (sc.max(0).values >= MIN_SCALE) & (op >= self.alpha_threshold)
            es, vis = [], []
            for eye in eyes:
                e = eye.project(pos, cov)
                r = eye.tile_rect(e, self.tile, self.tile)
                es.append(e)
                vis.append(e["ok"] & (r[0] <= r[1]) & (r[2] <= r[3]) & shared)
            both = vis[0] & vis[1]
            depth = torch.where(both, 0.5 * (es[0]["depth"] + es[1]["depth"]),
                                torch.where(vis[0], es[0]["depth"],
                                            es[1]["depth"]))
            det = torch.where(both, torch.maximum(es[0]["det"], es[1]["det"]),
                              torch.where(vis[0], es[0]["det"], es[1]["det"]))
            ink = op * 6.283185 * torch.sqrt(torch.clamp(det, min=1e-12))
            ok = (vis[0] | vis[1]) & (
                ink >= _ink_factor(depth, near, far) * self.ink_threshold)
            mid = 0.5 * (_mat(rig[0]["position"], self.dtype, self.device)
                         + _mat(rig[1]["position"], self.dtype, self.device))
            d = mid[:, None] - pos
            d = d / torch.sqrt(torch.clamp((d * d).sum(0), min=1e-24))
            rgb = torch.stack([_u8(c) / 255.0 for c in
                               _sh_colour(harm, d, self.sh_degree)])
            op_q = _u8(op) / 255.0
            recs = []
            for e, v in zip(es, vis):
                rec = _record(e, v)
                rec.update(rgb=rgb, op=op_q)
                recs.append(rec)
            box = [torch.where(vis[0] & vis[1], f(a, b),
                               torch.where(vis[0], a, b))
                   for f, a, b in (
                       (torch.minimum, *(torch.clamp(e["sx"] - e["ex"], 0.0, width) for e in es)),
                       (torch.maximum, *(torch.clamp(e["sx"] + e["ex"], 0.0, width) for e in es)),
                       (torch.minimum, *(torch.clamp(e["sy"] - e["ey"], 0.0, height) for e in es)),
                       (torch.maximum, *(torch.clamp(e["sy"] + e["ey"], 0.0, height) for e in es)))]
            out.append(dict(ok=ok, key_depth=depth.float(), box=box, recs=recs))
        return self._cat(out)

    @staticmethod
    def _cat(parts):
        def cat(xs):
            if isinstance(xs[0], dict):
                return {k: cat([x[k] for x in xs]) for k in xs[0]}
            if isinstance(xs[0], (list, tuple)):
                return [cat([x[i] for x in xs]) for i in range(len(xs[0]))]
            return torch.cat(xs, dim=-1)
        return cat(parts)

    # ---- binning ---------------------------------------------------------

    def _pairs(self, g, ids, tests):
        """(tile, gaussian) pairs of the gaussians ``ids``: every tile of
        each one's rect (``g["rect"]``) that ``tests(gaussian, tx, ty)``
        keeps.  Returns (tx, ty, gaussian) of the kept pairs and the number
        of pairs tested."""
        x0, x1, y0, y1 = (r[ids] for r in g["rect"])
        w = x1 - x0 + 1
        n_cand = w * (y1 - y0 + 1)
        ends = torch.cumsum(n_cand, 0)
        kept, lo = [], 0
        while lo < len(ids):
            start = int(ends[lo - 1]) if lo else 0
            hi = int(torch.searchsorted(ends, start + self.pair_block, right=True))
            hi = max(hi, lo + 1)
            rep = torch.repeat_interleave(
                torch.arange(lo, hi, device=self.device), n_cand[lo:hi])
            j = torch.arange(rep.shape[0], device=self.device) \
                - (ends[rep] - n_cand[rep] - start)
            tx = x0[rep] + j % w[rep]
            ty = y0[rep] + torch.div(j, w[rep], rounding_mode="floor")
            keep = tests(ids[rep], tx, ty)
            kept.append((tx[keep], ty[keep], ids[rep][keep]))
            lo = hi
        tested = int(ends[-1]) if len(ends) else 0
        if not kept:
            empty = torch.zeros(0, dtype=torch.long, device=self.device)
            return empty, empty, empty, tested
        tx, ty, gid = (torch.cat(x) for x in zip(*kept))
        return tx, ty, gid, tested

    def _bin(self, g, tiles_x, tiles_y, tests):
        ids = torch.nonzero(g["ok"]).flatten()
        tx, ty, gid, tested = self._pairs(g, ids, tests)
        tile = ty * tiles_x + tx
        # front to back by (depth, gaussian index): rank the gaussians, then
        # sort the pairs by (tile, rank)
        order = torch.argsort(g["key_depth"][ids], stable=True)
        rank = torch.empty(self.n, dtype=torch.long, device=self.device)
        rank[ids[order]] = torch.arange(len(ids), device=self.device)
        bits = max(int(len(ids)).bit_length(), 1)
        key = (tile << bits) | rank[gid]
        srt = torch.argsort(key)
        counts = torch.bincount(tile, minlength=tiles_x * tiles_y)
        return gid[srt], counts, tested

    # ---- compositing -----------------------------------------------------

    def _composite(self, recs, gid, counts, tiles_x, tiles_y, sample,
                   q_cutoff):
        """Front-to-back compositing of every tile; ``sample(tx, ty)``
        gives the (x, y) sample points (T, P) of the tiles.  Returns
        (colour (n_eyes, T, P, 4), depth and the exit's slack of colour and
        of depth stacked (n_eyes, T, P, 3), counts)."""
        dev, dt = self.device, self.dtype
        n_eyes = len(recs)
        n_t = tiles_x * tiles_y
        pix = self.tile * self.tile
        starts_all = torch.cumsum(counts, 0) - counts
        color = torch.zeros((n_eyes, n_t, pix, 4), device=dev)
        depth = torch.zeros((n_eyes, n_t, pix, 3), device=dev)
        pairs_alpha = torch.zeros((), dtype=torch.long, device=dev)
        records_read = torch.zeros((), dtype=torch.long, device=dev)
        fields = [torch.stack([r[k].to(dt) for k in
                               ("mx", "my", "a1", "b1", "a2", "b2")]
                              + [r["rgb"][i].to(dt) for i in range(3)]
                              + [torch.log(r["op"].to(dt)), r["depth"].to(dt)])
                  for r in recs]
        r_chunk = self.chunk
        for t0 in range(0, n_t, self.tile_block):
            tiles = torch.arange(t0, min(t0 + self.tile_block, n_t), device=dev)
            start, count = starts_all[tiles], counts[tiles]
            base = torch.div(start, BLOCK, rounding_mode="floor") * BLOCK
            shift = 255 - torch.remainder(base - start - 1, BATCH)
            sx, sy = sample(tiles % tiles_x,
                            torch.div(tiles, tiles_x, rounding_mode="floor"))
            sx, sy = sx.to(dt)[:, None, :], sy.to(dt)[:, None, :]
            trans = [torch.ones((len(tiles), pix), dtype=dt, device=dev)
                     for _ in range(n_eyes)]
            acc = [torch.zeros((len(tiles), pix, 4), dtype=dt, device=dev)
                   for _ in range(n_eyes)]
            active = count > 0
            saturated = torch.zeros_like(active)
            slack = [torch.zeros((len(tiles), pix), device=dev)
                     for _ in range(n_eyes)]
            deepest = torch.zeros(len(tiles), device=dev)
            v_end = int((count + shift).max()) if len(tiles) else 0
            for v0 in range(0, v_end, r_chunk):
                if v0 % BATCH == 0 and not bool(active.any()):
                    break
                k = v0 + torch.arange(r_chunk, device=dev)[None, :] - shift[:, None]
                valid = active[:, None] & (k >= 0) & (k < count[:, None])
                idx = gid[torch.clamp(start[:, None] + k, 0, max(len(gid) - 1, 0))] \
                    if len(gid) else torch.zeros_like(k)
                read = torch.zeros_like(valid)
                after = []
                for e in range(n_eyes):
                    f = fields[e][:, idx][..., None]  # (11, T, R, 1)
                    dx, dy = sx - f[0], sy - f[1]
                    u = f[2] * dx + f[3] * dy
                    w = f[4] * dx + f[5] * dy
                    q = u * u + w * w
                    alpha = torch.clamp(torch.exp(q * -0.5 + f[9]), max=ALPHA_MAX)
                    if q_cutoff is not None:
                        alpha = torch.where(q > q_cutoff, 0.0, alpha)
                    alpha = torch.where(valid[..., None], alpha, 0.0)
                    keep = torch.cumprod(1.0 - alpha, dim=1)
                    before = trans[e][:, None, :] * torch.cat(
                        [torch.ones_like(keep[:, :1]), keep[:, :-1]], dim=1)
                    wgt = alpha * before
                    vals = torch.stack([f[6], f[7], f[8], f[10]], -1)  # (T,R,1,4)
                    acc[e] += (wgt[..., None] * vals).sum(1)
                    after.append(trans[e][:, None, :] * keep)
                    deepest = torch.maximum(deepest, torch.where(
                        valid, f[10][..., 0], 0.0).amax(1).float())
                    trans[e] = trans[e] * keep[:, -1]
                    # the work any implementation must do: the pairs before
                    # the pixel's own exit whose alpha reaches the threshold
                    must = (alpha >= self.alpha_threshold) & (before >= EXIT_T)
                    pairs_alpha += must.sum()
                    read |= must.any(-1)
                records_read += read.sum()
                # the first rank at which every pixel of the tile is under
                # the exit's transmittance: the slack from there on
                worst = after[0].amax(-1)
                for a in after[1:]:
                    worst = torch.maximum(worst, a.amax(-1))
                hit = (worst < EXIT_T) & valid
                new = hit.any(1) & ~saturated
                if bool(new.any()):
                    first = hit.to(torch.int8).argmax(1)[new]
                    for e in range(n_eyes):
                        slack[e][new] = after[e][new, first].float()
                    saturated |= new
                del after
                v1 = v0 + r_chunk
                if v1 % BATCH == 0:
                    k_end = v1 - 1 - shift
                    worst = trans[0]
                    for t in trans[1:]:
                        worst = torch.maximum(worst, t)
                    done = (k_end >= 0) & (k_end + 1 < count) \
                        & (worst < EXIT_T).all(-1)
                    active &= ~done
            for e in range(n_eyes):
                color[e, tiles, :, :3] = acc[e][..., :3].float()
                color[e, tiles, :, 3] = (1.0 - trans[e]).float()
                depth[e, tiles, :, 0] = acc[e][..., 3].float()
                depth[e, tiles, :, 1] = slack[e]
                depth[e, tiles, :, 2] = slack[e] * deepest[:, None]
        return color, depth, dict(blend_pairs=int(pairs_alpha),
                                  blend_records=int(records_read))

    def _assemble(self, color, depth, tiles_x, tiles_y, width, height):
        n_eyes, t = color.shape[0], self.tile

        def unpack(x, ch):
            x = x.reshape(n_eyes, tiles_y, tiles_x, t, t, ch).permute(1, 3, 0, 2, 4, 5)
            x = x.reshape(tiles_y * t, n_eyes, tiles_x * t, ch)[:height, :, :width]
            return x.reshape(height, n_eyes * width, ch)

        return unpack(color, 4).contiguous(), unpack(depth, 3).contiguous()

    # ---- frames ----------------------------------------------------------

    def mono(self, cam, width: int, height: int) -> Frame:
        """``cam``: dict of ``view``, ``proj`` (4, 4), ``position`` (3,),
        ``near``, ``far``."""
        t = self.tile
        tiles_x, tiles_y = -(-width // t), -(-height // t)
        g = self._project_mono(cam, width, height)
        rec = g["recs"][0]

        def tests(i, tx, ty):
            x0, y0 = (tx * t).to(self.dtype), (ty * t).to(self.dtype)
            return _min_q(rec, x0, x0 + t, y0, y0 + t, i) <= rec["cutoff"][i]

        gid, counts, tested = self._bin(g, tiles_x, tiles_y, tests)

        def sample(tx, ty):
            p = torch.arange(t * t, device=self.device)
            return ((tx * t)[:, None] + p % t).float(), \
                ((ty * t)[:, None] + torch.div(p, t, rounding_mode="floor")).float()

        color, depth, counts_b = self._composite(g["recs"], gid, counts, tiles_x,
                                                 tiles_y, sample, None)
        color, depth = self._assemble(color, depth, tiles_x, tiles_y, width, height)
        visible = int(g["ok"].sum())
        return Frame(color, depth[..., 0], visible, dict(
            gaussians=self.n, visible=visible, pairs=int(gid.shape[0]),
            pairs_tested=tested, pixels=width * height, eyes=1, **counts_b),
            depth[..., 1], depth[..., 2])

    def stereo(self, rig, width: int, height: int, fov) -> Frame:
        """Two eyes (``rig``: two camera dicts, left first) of ``width`` x
        ``height`` each, rendered into ``fov``, a foveated target of
        :func:`foveation.target`."""
        t = self.tile
        g = self._project_stereo(rig, width, height)
        dev = self.device
        tiles_x, tiles_y = fov["tiles_x"], fov["tiles_y"]
        px, py, bx, by = (torch.as_tensor(fov[k], device=dev)
                          for k in ("px", "py", "bx", "by"))
        out_w, out_h = fov["render_width"], fov["render_height"]
        # the physical tiles whose display rect meets the union box
        x0, x1, y0, y1 = g["box"]
        g["rect"] = (
            torch.clamp(torch.searchsorted(bx, x0.float().contiguous(), right=True) - 1,
                        0, tiles_x - 1),
            torch.clamp(torch.searchsorted(bx, x1.float().contiguous(), right=False) - 1,
                        0, tiles_x - 1),
            torch.clamp(torch.searchsorted(by, y0.float().contiguous(), right=True) - 1,
                        0, tiles_y - 1),
            torch.clamp(torch.searchsorted(by, y1.float().contiguous(), right=False) - 1,
                        0, tiles_y - 1))
        bxd, byd = bx.to(self.dtype), by.to(self.dtype)
        recs = g["recs"]

        def tests(i, tx, ty):
            x0, x1, y0, y1 = bxd[tx], bxd[tx + 1], byd[ty], byd[ty + 1]
            q = torch.minimum(_min_q(recs[0], x0, x1, y0, y1, i),
                              _min_q(recs[1], x0, x1, y0, y1, i))
            return q <= STEREO_Q_CUTOFF

        gid, counts, tested = self._bin(g, tiles_x, tiles_y, tests)

        def sample(tx, ty):
            p = torch.arange(t * t, device=dev)
            return (px[(tx * t)[:, None] + p % t],
                    py[(ty * t)[:, None] + torch.div(p, t, rounding_mode="floor")])

        color, depth, counts_b = self._composite(recs, gid, counts, tiles_x,
                                                 tiles_y, sample, STEREO_Q_CUTOFF)
        color, depth = self._assemble(color, depth, tiles_x, tiles_y, out_w, out_h)
        visible = int(g["ok"].sum())
        return Frame(color, depth[..., 0], visible, dict(
            gaussians=self.n, visible=visible, pairs=int(gid.shape[0]),
            pairs_tested=tested, pixels=2 * out_w * out_h, eyes=2, **counts_b),
            depth[..., 1], depth[..., 2])
