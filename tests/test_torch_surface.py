"""The port's public surface against the JAX package's.

Every public (not underscored) top-level ``def`` and ``class`` of every
module of ``gsm_renderer_tpu`` -- read from the source with ``ast``, so
that JAX is not imported -- has a counterpart of the same name in the
port's module of the same name, or stands in NO_COUNTERPART with its
one-line reason (the ROADMAP's list of what needs no counterpart).

Every parameter of every public top-level JAX function with a counterpart
is a parameter of the counterpart (of the function it forwards ``**kw`` to,
FORWARDS, where it has one), or stands in NO_KEYWORD with its one-line
reason.
"""

import ast
import importlib
import inspect
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


_PREPARED = "the cached projection layout: the port's ``prepared`` (comp, harm)"
_PALLAS = "Pallas interpret mode: the plain versions run on CPU tensors"
_XLA_BLEND = "the XLA blend oracle (use_xla_blend): blend_tiles_plain"
_DMA = f"{_TPU}: the blend's DMA window (blocks_per_dma)"
_PROJECT = "the XLA projection switch: the port's frames run kernel 1"
_MESH = "the process group (``group``) of torch.distributed"
_FOV_TABLES = ("the foveated raster tables: the port's ``tables`` dict of "
               "foveated_device_tables")
_UNPACKED = ("the XLA projection's planes: the port bins the packed "
             "projection (``packed``) of kernel 1")
#: (port module, function) -> the port function its ``**kw`` reach
FORWARDS = {
    ("kernels.project", "project_and_cull_packed"): "project_plain",
    ("kernels.project", "stereo_project_and_cull_packed"):
        "stereo_project_plain",
    ("pipelines.hardware", "hardware_frame"):
        "gsm_renderer_tpu_torch.pipelines.depth_first.depth_first_frame",
}
#: (port module, function) -> {JAX parameter the port does not take: why}
NO_KEYWORD = {
    ("kernels.expand", "warped_bounds_gather"): dict.fromkeys(
        ("bounds_row", "idx", "span"),
        "kernel 7's gather of a window's boundaries, (bounds, min_tx, "
        "min_ty), where JAX's is its one-hot XLA oracle of one table row"),
    ("kernels.project", "project_and_cull_packed"): dict(interpret=_PALLAS),
    ("kernels.project", "stereo_project_and_cull_packed"):
        dict(interpret=_PALLAS),
    ("mathlib", "project_covariance_2d_c"): dict(
        view_rot="the whole view matrix (``view``), whose 3x3 block it reads"),
    ("ops.binning", "extract_tile_ranges"): dict(
        sorted_tile_key="named ``sorted_tile``, passed by position"),
    ("parallel.multichip", "shard_gaussian_input"): dict(
        mesh="``rank`` and ``world_size`` of the process group",
        axis="``rank`` and ``world_size`` of the process group"),
    ("parallel.multichip", "build_sharded_depth_first"): dict(
        mesh=_MESH, axis=_MESH, use_xla_blend=_XLA_BLEND,
        pallas_project=_PROJECT, interpret=_PALLAS,
        split_frame=f"{_TPU}: the 3-program split frame"),
    ("pipelines.common", "binning_sort_operands"): dict(
        {k: _UNPACKED for k in ("visible", "min_tx", "min_ty", "max_tx",
                                "rect_count", "depth_sort_word",
                                "word_list")},
        fused_depth16="the d16 KeyPlan orders slots as the fused key "
                      "(pipelines/common.py)",
        use_pallas=_PALLAS, interpret=_PALLAS,
        exact_test="the binning ``mode`` (mono, none, stereo, warped)",
        tile_row_offset="a band frame's: expand_slots(tile_row_offset=)",
        precount="always on: prep pre-counts every mask-eligible gaussian",
        mask_override="a band frame's: binning_prep_band",
        use_prep="always on: prep (kernel 2) builds every table"),
    ("pipelines.common", "binning_sorted_tile"): dict(
        fused_depth16="the d16 KeyPlan orders slots as the fused key"),
    ("pipelines.common", "d16_packed_sorted"): dict(
        comp=_PREPARED, harm=_PREPARED, interpret=_PALLAS),
    ("pipelines.depth_first", "depth_first_frame"): dict(
        comp=_PREPARED, harm=_PREPARED, blocks_per_dma=_DMA,
        use_xla_blend=_XLA_BLEND, interpret=_PALLAS, pallas_project=_PROJECT),
    ("pipelines.depth_first", "depth_first_stereo_frame"): dict(
        comp=_PREPARED, harm=_PREPARED, blocks_per_dma=_DMA,
        use_xla_blend=_XLA_BLEND, interpret=_PALLAS),
    ("pipelines.depth_first", "depth_first_stereo_foveated_frame"): dict(
        comp=_PREPARED, harm=_PREPARED, blocks_per_dma=_DMA,
        use_xla_blend=_XLA_BLEND, interpret=_PALLAS, inv_fit=_FOV_TABLES,
        coord_x=_FOV_TABLES, coord_y=_FOV_TABLES, warp_bounds=_FOV_TABLES),
    ("pipelines.global_", "global_frame"): dict(
        use_xla_blend=_XLA_BLEND, interpret=_PALLAS),
    ("pipelines.hardware", "hardware_frame"): dict(blocks_per_dma=_DMA),
    ("pipelines.local", "local_frame"): dict(
        use_xla_blend=_XLA_BLEND, interpret=_PALLAS),
    ("profiling", "profile_depth_first_stages"): dict(
        use_pallas="the port's frames always run the hand kernels"),
}


def jax_functions():
    """(port module, function name, JAX parameter names) of every public
    top-level JAX function that has a port counterpart."""
    out = []
    for module, path in jax_modules():
        port = importlib.import_module(
            "gsm_renderer_tpu_torch" + (f".{module}" if module else ""))
        for n in ast.parse(path.read_text()).body:
            if (isinstance(n, ast.FunctionDef) and not n.name.startswith("_")
                    and hasattr(port, n.name)):
                a = n.args
                out.append((module, n.name, [
                    x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]))
    return out


def port_parameters(module: str, name: str) -> set:
    """The parameter names the port's ``module.name`` takes, with those of
    the function its ``**kw`` reach (FORWARDS)."""
    port = importlib.import_module(
        "gsm_renderer_tpu_torch" + (f".{module}" if module else ""))
    params = set(inspect.signature(getattr(port, name)).parameters)
    target = FORWARDS.get((module, name))
    if target is not None:
        mod, _, fn = target.rpartition(".")
        owner = importlib.import_module(mod) if mod else port
        params |= set(inspect.signature(getattr(owner, fn)).parameters)
    return params


@pytest.mark.parametrize("module,name,keywords", jax_functions(),
                         ids=[f"{m}.{n}" for m, n, _ in jax_functions()])
def test_every_jax_keyword_is_accepted(module, name, keywords):
    """Each parameter of the JAX function is the port's, or is listed with
    its reason (``back_to_front`` and ``max_per_tile`` were missing until
    the port took them)."""
    params = port_parameters(module, name)
    excused = NO_KEYWORD.get((module, name), {})
    missing = [k for k in keywords if k not in params and k not in excused]
    assert not missing, (f"gsm_renderer_tpu_torch.{module}.{name} refuses "
                         f"{missing}: take them or list them in NO_KEYWORD")


def test_no_keyword_list_is_current():
    """Every listed keyword is a parameter of its JAX function that the
    port's counterpart indeed lacks, and has a reason; every FORWARDS
    entry forwards ``**kw``."""
    jax = {(m, n): set(k) for m, n, k in jax_functions()}
    for (module, name), reasons in NO_KEYWORD.items():
        params = port_parameters(module, name)
        for kw, reason in reasons.items():
            assert kw in jax[(module, name)], (module, name, kw)
            assert kw not in params, (module, name, kw)
            assert reason.strip()
    for module, name in FORWARDS:
        port = importlib.import_module(f"gsm_renderer_tpu_torch.{module}")
        kinds = [p.kind for p in
                 inspect.signature(getattr(port, name)).parameters.values()]
        assert inspect.Parameter.VAR_KEYWORD in kinds, (module, name)
