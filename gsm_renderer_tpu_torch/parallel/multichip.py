"""Band-sharded multi-device DepthFirst rendering on ``torch.distributed``.

Port of ``gsm_renderer_tpu/parallel/multichip.py``.  Every rank of a
process group renders one frame together with the others:

* **Data-parallel projection.**  Rank r holds the r-th contiguous shard of
  the (padded) gaussians and projects it with the packed projection kernel
  (no KeyPlan: the raw sortable depth key, 0xFFFFFFFF where culled), then
  takes the shard's exact 8x4 tile masks from prep mode "mono".
* **One collective.**  An (8, n_shard) int32 block -- the 4 record words,
  the rect word, the rect rows (min_ty | max_ty << 10), the depth key and
  the mask, 32 B a gaussian -- goes through one ``dist.all_gather``.  Rank
  order is the global input order, so the KeyPlan's index tiebreak (or the
  stable sort's slot order) reproduces the mono frame's tie order.
* **Screen-space bands.**  Rank r owns the tile rows [band_starts[r],
  band_starts[r + 1]).  Prep mode "band" clamps every gathered rect to the
  band (the JAX package's XLA band clamp: the sub-mask of the global mask,
  band-local rect words, the depth word normalized under the band KeyPlan,
  the offsets); the expand runs its exact test at the band's global tile
  rows (``tile_row_offset``) and keys band-local tiles; the sort and ranges
  cover tiles_x x bands tiles; the blend samples global pixel rows
  (``tile_row_offset``) into a raster of ``bands`` tile rows.  The overflow
  flag is reduced over the group with ``all_reduce(MAX)``.

Each rank returns its own rows of the image; :meth:`ShardedDepthFirst.
gather` stitches the whole image on every rank.  With ``use_keyplan=False``,
or where no tie-free KeyPlan fits the band, the expand writes the plain tile
key and the frame sorts stably (``pipelines/common.py``), as JAX does.

Per band the instance set and its (tile, depth, gaussian index) order are
the mono frame's, and pixel coordinates are global, so the stitched image
is the mono frame's, except where a tile's span starts at another offset
of the band's sorted list than of the mono list: the blend's 256-record
batches are aligned to 128-record blocks of that list, and a tile whose
pixels all saturate stops at the end of a batch.  A world of one is the
mono frame bit for bit.

What the JAX ``build_sharded_depth_first`` takes and this one does not:
``mesh`` / ``axis`` (the process group, the caller's, takes their place),
``use_xla_blend``, ``pallas_project``, ``split_frame`` and ``interpret``:
TPU means with no counterpart here (the frame always runs the hand
kernels on CUDA tensors, their plain versions on CPU tensors).  The JAX
band frame takes any tile; this one every tile of 1 to 4096 pixels a
side, as the mono frame (a side of 0 or over 4096 raises ValueError).
One card holds every rank of a gloo group in the port's checks; NCCL
refuses two ranks on one device.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import config as cfg
from ..kernels.blend import blend_image
from ..kernels.expand import (MASK_H, MASK_W, SENTINEL, _popcount,
                              binning_prep, binning_prep_band, check_tile,
                              expand_slots)
from ..kernels.project import cached_projection_inputs, project_and_cull_packed
from ..mathlib import u32
from ..ops import binning as B
from ..pipelines.common import sort_and_ranges
from ..types import GaussianInput, resolve_device

def pad_gaussian_input(gi: GaussianInput, multiple: int) -> GaussianInput:
    """Pad the gaussian axis to a multiple of ``multiple``.  Pads are
    inert: zero scale trips the scale cull, so each takes one dead slot and
    nothing else; rotations (0, 0, 0, 1)."""
    pad = (-gi.count) % multiple
    if pad == 0:
        return gi

    def zeros(x, shape):
        return torch.cat([x, x.new_zeros(shape)], dim=0)

    rot = gi.rotations.new_zeros((pad, 4))
    rot[:, 3] = 1
    return GaussianInput(
        positions=zeros(gi.positions, (pad, 3)),
        scales=zeros(gi.scales, (pad, 3)),
        rotations=torch.cat([gi.rotations, rot], dim=0),
        opacities=zeros(gi.opacities, (pad,)),
        harmonics=torch.cat([gi.harmonics, gi.harmonics.new_zeros(
            (*gi.harmonics.shape[:2], pad))], dim=2))


def shard_gaussian_input(gi: GaussianInput, rank: int,
                         world_size: int) -> GaussianInput:
    """Rank ``rank``'s contiguous shard of ``gi`` padded to a multiple of
    ``world_size`` (:func:`pad_gaussian_input`)."""
    gi = pad_gaussian_input(gi, world_size)
    m = gi.count // world_size
    sl = slice(rank * m, (rank + 1) * m)
    return GaussianInput(
        positions=gi.positions[sl].contiguous(),
        scales=gi.scales[sl].contiguous(),
        rotations=gi.rotations[sl].contiguous(),
        opacities=gi.opacities[sl].contiguous(),
        harmonics=gi.harmonics[..., sl].contiguous())


def project_block(gi: GaussianInput, view, proj, center, *, width: int,
                  height: int, tile_w: int, tile_h: int, sh_degree: int,
                  near_plane: float, far_plane: float, alpha_threshold: float,
                  total_ink_threshold: float, input_is_srgb: bool):
    """The (8, n) int32 block of the gathered planes of ``gi``: the 4
    record words, the rect word, the rect rows (min_ty | max_ty << 10), the
    raw sortable depth key (0xFFFFFFFF where culled: visibility rides the
    depth plane) and the exact 8x4 mask at the rect's corner -- the packed
    projection with no KeyPlan, then prep mode "mono"."""
    packed = project_and_cull_packed(
        gi, view, proj, center, key_plan=None,
        prepared=cached_projection_inputs(gi, sh_degree), width=width,
        height=height, tile_w=tile_w, tile_h=tile_h, sh_degree=sh_degree,
        near_plane=near_plane, far_plane=far_plane,
        alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb)
    _off, _rect, mask = binning_prep(packed.rect_word, packed.rect_h,
                                     packed.words, mode="mono", tile_w=tile_w,
                                     tile_h=tile_h,
                                     alpha_threshold=alpha_threshold)
    min_ty = (packed.rect_word >> 10) & 0x3FF
    rows = min_ty | ((min_ty + packed.rect_h - 1) << 10)
    dkey = torch.where(packed.visible, packed.dsw, -1)
    return torch.stack([*packed.words, packed.rect_word, rows, dkey, mask])


def resolve_band_starts(tiles_y: int, n_dev: int, band_starts=None):
    """(band starts, bands): the ``n_dev + 1`` tile-row boundaries and the
    largest band's height.  ``band_starts`` None splits the rows equally
    (the last band may reach past ``tiles_y``); a given tuple must be
    strictly increasing from 0 to at least ``tiles_y``."""
    if band_starts is None:
        bands = -(-tiles_y // n_dev)
        return tuple(d * bands for d in range(n_dev + 1)), bands
    bs = tuple(int(b) for b in band_starts)
    if (len(bs) != n_dev + 1 or bs[0] != 0 or bs[-1] < tiles_y
            or any(b1 <= b0 for b0, b1 in zip(bs, bs[1:]))):
        raise ValueError(f"band_starts {bs}: need {n_dev + 1} strictly "
                         f"increasing tile rows from 0 to >= {tiles_y}")
    return bs, max(b1 - b0 for b0, b1 in zip(bs, bs[1:]))


def band_capacity(n_total: int, n_dev: int, capacity_per_device: int = 0):
    """A band's instance capacity: ``capacity_per_device``, or the JAX
    default of INSTANCE_CAPACITY_FACTOR x n_total / n_dev, rounded up to a
    multiple of 4096.  Every gathered gaussian takes at least one (dead)
    slot in every band, so a band needs the padded count plus its load."""
    if capacity_per_device <= 0:
        capacity_per_device = (cfg.INSTANCE_CAPACITY_FACTOR * n_total) // n_dev
    return -(-capacity_per_device // 4096) * 4096


class ShardedDepthFirst:
    """The band-sharded DepthFirst frame of one rank (see the module
    docstring); build it with :func:`build_sharded_depth_first` on every
    rank of the group."""

    def __init__(self, group, *, width: int, height: int, n_total: int,
                 sh_degree: int, capacity_per_device: int, tile_w: int,
                 tile_h: int, near_plane: float, far_plane: float,
                 alpha_threshold: float, total_ink_threshold: float,
                 input_is_srgb: bool, band_starts, use_keyplan: bool,
                 device):
        check_tile(tile_w, tile_h, "band frame")
        self.group = group
        self.n_dev = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        self.width, self.height, self.tile_h = width, height, tile_h
        self.tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
        self.band_starts, self.bands = resolve_band_starts(
            tiles_y, self.n_dev, band_starts)
        self.band0 = self.band_starts[self.rank]
        self.band1 = self.band_starts[self.rank + 1]
        self.capacity = band_capacity(n_total, self.n_dev, capacity_per_device)
        self.n_padded = n_total + (-n_total) % self.n_dev
        # tile ids are band-local; the gathered order is the input order
        self.key_plan = (B.make_key_plan(self.tiles_x * self.bands,
                                         self.n_padded, near_plane=near_plane,
                                         far_plane=far_plane)
                         if use_keyplan else None)
        self._proj_kw = dict(
            width=width, height=height, tile_w=tile_w, tile_h=tile_h,
            sh_degree=sh_degree, near_plane=near_plane, far_plane=far_plane,
            alpha_threshold=alpha_threshold,
            total_ink_threshold=total_ink_threshold,
            input_is_srgb=input_is_srgb)
        self._bin_kw = dict(tile_w=tile_w, tile_h=tile_h,
                            alpha_threshold=alpha_threshold)

    def segment_rows(self, rank: int) -> int:
        """Image rows of ``rank``'s band (0 for a band past the image)."""
        b0, b1 = self.band_starts[rank], self.band_starts[rank + 1]
        return max(min(b1 * self.tile_h, self.height) - b0 * self.tile_h, 0)

    def project_shard(self, gi_shard: GaussianInput, view, proj, center):
        """The data-parallel stage: the (8, n_shard) int32 block this rank
        contributes to the gather (:func:`project_block`)."""
        if gi_shard.count * self.n_dev != self.n_padded:
            raise ValueError(
                f"a shard of {gi_shard.count} gaussians on {self.n_dev} ranks "
                f"is not the padded {self.n_padded} (shard_gaussian_input)")
        if gi_shard.device.type != self.device.type:
            raise ValueError(f"gaussian shard on {gi_shard.device}, frame on "
                             f"{self.device}")
        return project_block(gi_shard, view, proj, center, **self._proj_kw)

    def __call__(self, gi_shard: GaussianInput, view, proj, center):
        """This rank's part of the frame: (color (rows, W, 4), depth (rows,
        W), overflow) with rows = :meth:`segment_rows` of this rank, the
        overflow flag (0-d int32) reduced over the group.  ``view`` /
        ``proj`` (4, 4) and ``center`` (3,) are host arrays."""
        block = self.project_shard(gi_shard, view, proj, center)
        parts = [torch.empty_like(block) for _ in range(self.n_dev)]
        dist.all_gather(parts, block, group=self.group)
        g = torch.cat(parts, dim=1)
        words = list(g[:4])
        offsets, rect, mask, dsw = binning_prep_band(
            g[4], g[5], g[6], g[7], band0=self.band0, band1=self.band1,
            key_plan=self.key_plan)
        *keys, _total, overflow = expand_slots(
            offsets, rect, mask, dsw, words, capacity=self.capacity,
            tiles_x=self.tiles_x, key_plan=self.key_plan, mode="mono",
            tile_row_offset=self.band0, **self._bin_kw)
        srt = sort_and_ranges(keys, self.key_plan, self.tiles_x * self.bands)
        color, depth = blend_image(
            srt.key, words, srt.idx_bits, srt.starts, srt.counts,
            tiles_x=self.tiles_x, tiles_y=self.bands, width=self.width,
            height=self.bands * self.tile_h, tile_w=self._bin_kw["tile_w"],
            tile_h=self.tile_h, tile_row_offset=self.band0)
        overflow = overflow.reshape(1)
        dist.all_reduce(overflow, op=dist.ReduceOp.MAX, group=self.group)
        rows = self.segment_rows(self.rank)
        return color[:rows], depth[:rows], overflow[0]

    def gather(self, color, depth):
        """The whole (H, W, 4) image and (H, W) depth on every rank,
        stitched in rank order from each rank's :meth:`__call__` rows."""
        rows = [self.segment_rows(r) for r in range(self.n_dev)]
        pad = max(rows)
        out = []
        for x in (color, depth):
            block = x.new_zeros((pad, *x.shape[1:]))
            block[:x.shape[0]] = x
            parts = [torch.empty_like(block) for _ in range(self.n_dev)]
            dist.all_gather(parts, block, group=self.group)
            out.append(torch.cat([p[:r] for p, r in zip(parts, rows)], dim=0))
        return out[0], out[1]


def build_sharded_depth_first(
        group=None, *, width: int, height: int, n_total: int,
        sh_degree: int = 3, capacity_per_device: int = 0, tile_w: int = 16,
        tile_h: int = 16, near_plane: float = 0.1, far_plane: float = 100.0,
        alpha_threshold: float = cfg.DEFAULT_ALPHA_THRESHOLD,
        total_ink_threshold: float = cfg.DEFAULT_TOTAL_INK_THRESHOLD,
        input_is_srgb: bool = False, band_starts=None,
        use_keyplan: bool = True, device=None) -> ShardedDepthFirst:
    """This rank's ``render(gi_shard, view, proj, center) -> (color, depth,
    overflow)`` over the process group ``group`` (the default group for
    None; the caller initializes it).  Every rank of the group calls it with
    the same arguments and then renders every frame together.

    ``band_starts``: optional tile-row boundaries (n_dev + 1, strictly
    increasing, [0] == 0, [-1] >= tiles_y), for instance from
    :func:`balance_band_starts`; None splits the rows equally.  Every rank
    renders a raster of the largest band's height and returns its own rows.
    ``capacity_per_device``: a band's slots (0: the JAX default, 4 x
    n_total / n_dev, which a band reports as overflow when it holds the
    padded count plus its load beyond that).  ``use_keyplan=False`` sorts
    stably by the plain tile key, as happens anyway when no tie-free
    KeyPlan fits the band.  ``device``: the card by default.  Tiles: each
    side 1 to 4096 pixels (others raise ValueError)."""
    return ShardedDepthFirst(
        group, width=width, height=height, n_total=n_total,
        sh_degree=sh_degree, capacity_per_device=capacity_per_device,
        tile_w=tile_w, tile_h=tile_h, near_plane=near_plane,
        far_plane=far_plane, alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb,
        band_starts=band_starts, use_keyplan=use_keyplan, device=device)


def row_instance_histogram(gi: GaussianInput, view, proj, center, *,
                           width: int, height: int, tile_w: int = 16,
                           tile_h: int = 16, sh_degree: int = 3,
                           near_plane: float = 0.1, far_plane: float = 100.0,
                           alpha_threshold: float = cfg.DEFAULT_ALPHA_THRESHOLD,
                           total_ink_threshold: float =
                           cfg.DEFAULT_TOTAL_INK_THRESHOLD,
                           input_is_srgb: bool = False) -> np.ndarray:
    """Instances per tile row (the exact mask's count in each row where the
    rect fits the 8x4 window, the rect width on each of its rows
    otherwise), the planning input of :func:`balance_band_starts`.  One
    device, the packed projection and prep mode "mono"; run once per scene
    or viewpoint class, not per frame.  Returns (tiles_y,) int64."""
    _tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    block = u32(project_block(
        gi, view, proj, center, width=width, height=height, tile_w=tile_w,
        tile_h=tile_h, sh_degree=sh_degree, near_plane=near_plane,
        far_plane=far_plane, alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb))
    rect_w = (block[4] >> 20) & 0x3FF
    min_ty = block[5] & 0x3FF
    rect_h = ((block[5] >> 10) & 0x3FF) - min_ty + 1
    visible = block[6] != SENTINEL
    eligible = visible & (rect_w <= MASK_W) & (rect_h <= MASK_H)
    hist = torch.zeros(tiles_y + 1, dtype=torch.int64, device=block.device)
    for dy in range(MASK_H):
        row = _popcount((block[7] >> (8 * dy)) & 0xFF)
        hist.index_add_(0, torch.clamp(min_ty + dy, 0, tiles_y - 1),
                        torch.where(eligible, row, 0))
    # the other visible rects: rect_w on each of their rows, as a
    # difference array
    full = torch.where(visible & ~eligible, rect_w, 0)
    diff = torch.zeros_like(hist)
    diff.index_add_(0, min_ty, full)
    diff.index_add_(0, torch.clamp(min_ty + rect_h, 0, tiles_y), -full)
    return (hist + torch.cumsum(diff, 0))[:tiles_y].cpu().numpy()


def balance_band_starts(row_hist, n_dev: int):
    """Split tile rows into ``n_dev`` contiguous bands with about equal
    instance loads: boundary d lands where the cumulative histogram crosses
    total * d / n_dev, on the closer side of a hot row, every band keeping
    at least one row.  Returns the ``band_starts`` tuple (n_dev + 1) of
    :func:`build_sharded_depth_first`."""
    hist = np.asarray(row_hist, np.float64)
    tiles_y = hist.shape[0]
    cum = np.concatenate([[0.0], np.cumsum(hist)])
    total = max(cum[-1], 1.0)
    starts = [0]
    for d in range(1, n_dev):
        target = total * d / n_dev
        b = int(np.searchsorted(cum, target, side="left"))
        if b > 1 and abs(cum[b - 1] - target) < abs(cum[min(b, tiles_y)]
                                                    - target):
            b -= 1
        b = min(max(b, starts[-1] + 1), tiles_y - (n_dev - d))
        starts.append(b)
    starts.append(tiles_y)
    return tuple(starts)


# ---------------------------------------------------------------------------
# Worlds of spawned ranks on one host
# ---------------------------------------------------------------------------

#: seconds a spawned world has to report before :func:`run_ranks` ends it
RANKS_TIMEOUT_S = 600.0


def _rank_main(fn, rank: int, world_size: int, init: str, results,
               args) -> None:
    """One spawned rank: join the group, run ``fn(rank, world_size,
    *args)``, leave the group, and put (rank, ok, result or traceback)."""
    try:
        # one host: gloo's transport on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world_size)
        try:
            res = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, res))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, *args) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one gloo process group (a ``file://`` store in a
    temporary directory; gloo holds any number of ranks on one card, NCCL
    one).  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function), and so must each result.  Returns the results in rank
    order; raises with the failing rank's traceback, or when the ranks have
    not all reported within RANKS_TIMEOUT_S seconds, after ending every
    process."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init, results, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            while len(out) < world_size:
                try:
                    rank, ok, res = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank of {world_size} exited "
                                           f"with {dead[0]} before reporting")
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"the ranks of {world_size} did not report "
                            f"within {RANKS_TIMEOUT_S} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{res}")
                out[rank] = res
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(world_size)]


def _dryrun_rank(rank: int, world_size: int, device: str):
    from ..camera import make_camera
    from ..io.scene import generate_visible_gaussians

    w, h = 128, 128
    n = 128 * world_size
    ds = generate_visible_gaussians(n, sh_degree=1, scale_range=(0.01, 0.05))
    cam = make_camera(w, h, far=20.0)
    gi = shard_gaussian_input(ds.to_input(device=device), rank, world_size)
    render = build_sharded_depth_first(
        width=w, height=h, n_total=n, sh_degree=1, near_plane=0.1,
        far_plane=20.0, device=device)
    color, depth, overflow = render(gi, cam.view_matrix,
                                    cam.projection_matrix, cam.position)
    color, depth = render.gather(color, depth)
    if tuple(color.shape) != (h, w, 4) or tuple(depth.shape) != (h, w):
        raise RuntimeError(f"stitched frame {tuple(color.shape)}, "
                           f"{tuple(depth.shape)}")
    if not bool(torch.isfinite(color).all()):
        raise RuntimeError("sharded render is not finite")
    if float(color[..., :3].max()) <= 0.01:
        raise RuntimeError("sharded render produced a black frame")
    if int(overflow) != 0:
        raise RuntimeError("unexpected capacity overflow")
    return float(color.max())


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Twin of the JAX package's ``__graft_entry__.dryrun_multichip``: a
    world of ``n_devices`` spawned gloo ranks on ``device`` (the card by
    default) renders one band-sharded frame of a small scene (128x128, 128
    gaussians a rank, SH1); each rank checks the stitched frame's shape,
    that it is finite and not black, and overflow 0."""
    device = str(resolve_device(device))
    maxima = run_ranks(_dryrun_rank, n_devices, device)
    print(f"dryrun_multichip OK: {n_devices} ranks on {device}, color max "
          f"{maxima[0]:.3f}")
