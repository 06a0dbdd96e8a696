"""rebin_ms: device ms a frame of the foveated re-bin's kernels (those whose
name holds ``rebin``), from the traced frames' kernels.  None where the
renderer has no re-bin kernel (it counts no ``rebin_kernel``); 0.0 where the
window launched none."""


def read(ctx):
    from gsm_renderer_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or "rebin_kernel" not in counters():
        return None
    tr = ctx["trace"]
    sec = sum(s for name, (s, _n) in tr["kernels"].items() if "rebin" in name)
    return sec * 1e3 / tr["frames"]
