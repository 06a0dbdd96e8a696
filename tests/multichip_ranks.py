"""Rank functions of the spawned gloo worlds of
tests/test_torch_multichip.py.  A module of their own: each spawned rank
imports it, and it imports neither jax nor the JAX package."""

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
from gsm_renderer_tpu_torch.kernels import blend as KB
from gsm_renderer_tpu_torch.parallel import multichip as MC

NEAR, FAR = 0.1, 20.0


def hot_strip_scene(n: int):
    """tests/test_multichip.py's scene: every gaussian squashed into a thin
    horizontal strip, so that one equal-split band holds ~every instance."""
    ds = generate_visible_gaussians(n, sh_degree=1, scale_range=(0.12, 0.28))
    ds.positions[:, 1] = 0.04 * (ds.positions[:, 1] / 1.5) + 0.55
    return ds


def render_frames(rank: int, world_size: int, w: int, h: int, n: int,
                  frames: list):
    """This rank's part of each band-sharded frame of the hot-strip scene
    on the CPU, one per keyword dict of ``frames`` for
    ``build_sharded_depth_first``; a dict with ``early_exit=False`` blends
    with the tile-level early exit off (the
    blend's MIN_TRANSMITTANCE set to 0 for that frame).  Every rank returns
    each frame's overflow flag and band starts; rank 0 also the stitched
    colour and depth (numpy)."""
    ds = hot_strip_scene(n)
    cam = T.make_camera(w, h, far=FAR)
    gi = MC.shard_gaussian_input(ds.to_input(device="cpu"), rank, world_size)
    out = []
    for kw in frames:
        kw = dict(kw)
        exit_t = KB.MIN_TRANSMITTANCE
        if not kw.pop("early_exit", True):
            KB.MIN_TRANSMITTANCE = 0.0
        try:
            render = MC.build_sharded_depth_first(
                width=w, height=h, n_total=n, sh_degree=1, near_plane=NEAR,
                far_plane=FAR, device="cpu", **kw)
            color, depth, overflow = render(
                gi, cam.view_matrix, cam.projection_matrix, cam.position)
            rows = color.shape[0]
            color, depth = render.gather(color, depth)
        finally:
            KB.MIN_TRANSMITTANCE = exit_t
        res = dict(overflow=int(overflow), band_starts=render.band_starts,
                   rows=rows)
        if rank == 0:
            res.update(color=color.numpy(), depth=depth.numpy())
        out.append(res)
    return out
