"""The port's public surface against the JAX package's.

Every public (not underscored) top-level ``def`` and ``class`` of every
module of ``gsm_renderer_tpu`` -- read from the source with ``ast``, so
that JAX is not imported -- has a counterpart of the same name in the
port's module of the same name, or stands in NO_COUNTERPART with its
one-line reason (the ROADMAP's list of what needs no counterpart).
"""

import ast
import importlib
from pathlib import Path

import pytest

JAX_ROOT = Path(__file__).resolve().parent.parent / "gsm_renderer_tpu"

_TPU = "TPU machinery"
#: (port module, name) -> why the port has no counterpart
NO_COUNTERPART = {
    ("kernels.blend", "blend_tiles_pallas"):
        "the Pallas kernel; blend_image / blend_image_cuda (csrc/blend.cu)",
    ("kernels.blend", "blend_tiles_xla"):
        "XLA mirror of the Pallas blend; blend_tiles_plain fills its role",
    ("kernels.blend", "build_blend_table"):
        "the XLA blend's attribute table; the blend decodes the entry words",
    ("kernels.blend", "build_words_table"):
        "the TPU plane-major record table; the blend reads the entry words "
        "through the sorted key's index",
    ("kernels.expand", "warped_bounds_gather_pallas"):
        "the Pallas kernel; warped_bounds_gather / _cuda (csrc/binning.cu)",
    ("kernels.expand", "binning_prep_pallas"):
        "the Pallas kernel; binning_prep / _cuda (csrc/binning.cu)",
    ("kernels.expand", "row_expand_pallas"):
        "the Pallas kernel; row_expand / _cuda (csrc/binning.cu)",
    ("kernels.expand", "row_expand_xla"):
        "XLA mirror of the Pallas row expand; row_expand_plain fills its role",
    ("kernels.expand", "expand_slots_pallas"):
        "the Pallas kernel; expand_slots / _cuda (csrc/binning.cu)",
    ("kernels.expand", "expand_slots_xla"):
        "XLA mirror of the Pallas expand; expand_slots_plain fills its role",
    ("pipelines.base", "unique_jit"):
        f"{_TPU}: names jit programs; PyTorch runs eagerly",
    ("pipelines.base", "AotProgram"):
        f"{_TPU}: ahead-of-time XLA programs",
    ("pipelines.common", "sorted_instance_attrs"):
        "the XLA blend's per-instance attributes (use_xla_blend)",
    ("pipelines.common", "binning_inputs"):
        "XLA glue before the Pallas expand; prep (kernel 2) computes it",
    ("pipelines.common", "fused_binning_words"):
        "XLA single-program binning; binning_sort_operands + sort_and_ranges",
    ("pipelines.common", "fused_binning"):
        "XLA single-program binning; binning_sort_operands + sort_and_ranges",
    ("pipelines.common", "d16_pre_frame"):
        f"{_TPU}: the 3-program split frame; d16_packed_sorted",
    ("pipelines.common", "d16_post_frame"):
        f"{_TPU}: the 3-program split frame",
    ("pipelines.common", "d16_sort_frame"):
        f"{_TPU}: the 3-program split frame",
    ("pipelines.common", "render_split16"):
        f"{_TPU}: the 3-program split frame",
    ("pipelines.depth_first", "depth_first_pre_frame"):
        f"{_TPU}: the 3-program split frame; depth_first_frame",
    ("pipelines.depth_first", "sort_frame"):
        f"{_TPU}: the 3-program split frame",
    ("pipelines.depth_first", "depth_first_post_frame"):
        f"{_TPU}: the 3-program split frame",
    ("pipelines.depth_first", "depth_first_stereo_pre_frame"):
        f"{_TPU}: the 3-program split frame; depth_first_stereo_frame",
    ("pipelines.depth_first", "depth_first_stereo_post_frame"):
        f"{_TPU}: the 3-program split frame",
    ("pipelines.depth_first", "depth_first_stereo_foveated_pre_frame"):
        f"{_TPU}: the 3-program split frame; "
        "depth_first_stereo_foveated_frame",
    ("pipelines.depth_first", "depth_first_stereo_foveated_post_frame"):
        f"{_TPU}: the 3-program split frame",
    ("profiling", "profile_depth_first_stages_upto"):
        "deprecated in JAX: it only shows XLA's dead-code-elimination bias, "
        "which eager PyTorch has not",
}


def jax_modules():
    """(port module name relative to the package, JAX source file)."""
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = list(path.relative_to(JAX_ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append((".".join(parts), path))
    return out


def public_names(path: Path) -> list:
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


@pytest.mark.parametrize("module,path", jax_modules(),
                         ids=[m or "package" for m, _ in jax_modules()])
def test_every_public_name_has_a_counterpart(module, path):
    port = importlib.import_module(
        "gsm_renderer_tpu_torch" + (f".{module}" if module else ""))
    missing = [n for n in public_names(path)
               if not hasattr(port, n) and (module, n) not in NO_COUNTERPART]
    assert not missing, (f"gsm_renderer_tpu_torch.{module} lacks {missing}: "
                         "port them or list them in NO_COUNTERPART")


def test_no_counterpart_list_is_current():
    """Every listed name is a public name of its JAX module that the port
    indeed lacks, and has a reason."""
    names = {m: set(public_names(p)) for m, p in jax_modules()}
    for (module, name), reason in NO_COUNTERPART.items():
        assert name in names[module], (module, name)
        port = importlib.import_module(f"gsm_renderer_tpu_torch.{module}")
        assert not hasattr(port, name), (module, name)
        assert reason.strip()
