"""Every public name of the JAX package has its place in the port.

Both packages are read with `ast`; neither is imported.  A public name is
a module-level function, class or assignment not starting with ``_``, or a
method or field of such a class.  Each of the reference's passes one of
three checks:

- the port's module of the same path defines or imports it;
- `RENAMES` sends it to the port's name for it, which exists;
- `NOT_PORTED` lists it with its reason: JAX-only machinery (Pallas,
  XLA lowering and HLO parsing, sharding constraints, jit wrappers, pytree
  aliases) or a field the reference itself never reads.

A change to either package that opens a gap fails here, and so does an
entry of the two maps that no longer names a gap.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

RENAMES = {
    "core.boosting:boost_step": "core.boosting:boost_round",
    "core.distributed:make_distributed_boost_step":
        "core.distributed:distributed_round",
    "core.forest:forest_apply": "kernels.predict_kernel:forest_traverse",
    "core.forest:forest_apply_quant":
        "kernels.predict_quant_kernel:forest_traverse_quant",
    "core.histogram:build_histograms": "kernels.ops:histogram",
    "core.histogram:build_histograms_jnp": "kernels.ref:histogram_ref",
    "core.histogram:build_level_built": "kernels.ops:build_level",
    "core.histogram:build_level_jnp": "kernels.ref:hist_nodes_ref",
    "core.histogram:node_hist_jnp": "kernels.ops:node_histogram",
    "kernels.ops:decode_attention": "kernels.decode_attention:"
                                    "decode_attention",
    "kernels.ops:decode_attention_ref": "kernels.ref:decode_attention_ref",
    "kernels.ops:flash_attention": "kernels.flash_attention:flash_attention",
    "kernels.ops:forest_apply": "kernels.predict_kernel:forest_traverse",
    "kernels.ops:forest_apply_quant":
        "kernels.predict_quant_kernel:forest_traverse_quant",
    "kernels.ops:forest_apply_ref": "kernels.ref:forest_apply_ref",
    "kernels.ops:forest_apply_quant_ref":
        "kernels.ref:forest_apply_quant_ref",
    "kernels.ops:histogram_ref": "kernels.ref:histogram_ref",
    "kernels.ops:histogram_tiles_ref": "kernels.ref:hist_nodes_ref",
    "kernels.ops:mha_ref": "kernels.ref:flash_attention_ref",
    "kernels.ops:split_scan_ref": "kernels.ref:split_scan_ref",
    "kernels.ops:tree_shap": "kernels.shap_kernel:tree_shap",
    "kernels.ops:tree_shap_ref": "kernels.ref:tree_shap_ref",
    "kernels.ops:tree_shap_interventional_ref":
        "kernels.ref:tree_shap_interventional_ref",
    "kernels.ref:histogram_tiles_ref": "kernels.ref:hist_nodes_ref",
    "kernels.ref:mha_ref": "kernels.ref:flash_attention_ref",
    "kernels.hist_kernel:HIST_DTYPES": "kernels.ref:HIST_DTYPES",
    "kernels.hist_kernel:hist_tiles_pallas": "kernels.hist_kernel:hist_nodes",
    "kernels.hist_kernel:histogram_pallas": "kernels.hist_kernel:hist_direct",
    "kernels.split_kernel:split_scan_pallas": "kernels.split_kernel:"
                                              "split_scan",
    "kernels.predict_kernel:forest_traverse_pallas":
        "kernels.predict_kernel:forest_traverse",
    "kernels.predict_kernel:forest_traverse_quant_pallas":
        "kernels.predict_quant_kernel:forest_traverse_quant",
    "kernels.shap_kernel:shap_pallas": "kernels.shap_kernel:tree_shap",
    "kernels.flash_attention:flash_attention_pallas":
        "kernels.flash_attention:flash_attention",
    "kernels.flash_attention:NEG_INF": "kernels.ref:NEG_INF",
    "kernels.decode_attention:decode_attention_pallas":
        "kernels.decode_attention:decode_attention",
    "kernels.decode_attention:NEG_INF": "kernels.ref:NEG_INF",
    "models.layers:decode_attention_jnp": "kernels.ref:decode_attention_ref",
    "models.params:param_sharding": "models.params:shard_shape",
    "models.params:tree_shardings": "models.params:tree_shard_shapes",
}

_PYTREE = "a type alias (Any) for a JAX pytree"
_NOT_READ = "a field the reference never reads"
NOT_PORTED = {
    "core.histogram:KERNEL_MODES": "Pallas kernel modes (jnp, interpret, "
                                   "TPU); the port picks kernels by device",
    "core.histogram:resolve_kernel_mode": "resolves the Pallas kernel modes",
    "kernels.ops:resolve_dispatch": "Pallas interpret/TPU dispatch",
    "core.split:NEG_INF": "a jnp constant for traces; the port writes -inf",
    "kernels.split_kernel:NEG_INF": "a constant captured by the Pallas "
                                    "trace; B2 writes -inf",
    "models.layers:chunked_attention": "the XLA attention path without "
                                       "Pallas; the port always runs B7",
    "models.layers:AxisCtx.batch": "a with_sharding_constraint helper",
    "models.layers:AxisCtx.constrain": "a with_sharding_constraint helper",
    "models.layers:AxisCtx.ffn": "a with_sharding_constraint helper",
    "models.layers:AxisCtx.heads": "a with_sharding_constraint helper",
    "models.layers:AxisCtx.residual": "a with_sharding_constraint helper",
    "models.layers:AxisCtx.seq_shard": "a with_sharding_constraint helper",
    "launch.dryrun:compile_and_analyze": "XLA compilation and cost "
                                         "analysis",
    "launch.dryrun:lower_cell": "XLA lowering of an LM cell",
    "launch.dryrun:lower_decode_cell": "XLA lowering of a decode cell",
    "launch.dryrun:lower_gbdt_cell": "XLA lowering of a GBDT cell",
    "launch.dryrun:lower_train_cell": "XLA lowering of a training cell",
    "roofline.analysis:COLLECTIVE_OPS": "HLO collective op names",
    "roofline.analysis:ICI_BW": "the TPU interconnect's bandwidth",
    "roofline.analysis:cost_bytes": "reads XLA's cost_analysis",
    "roofline.analysis:cost_flops": "reads XLA's cost_analysis",
    "roofline.analysis:parse_collectives": "parses HLO text",
    "roofline.analysis:shape_bytes": "parses HLO shape strings",
    "training.train_lib:jit_train_step": "a jax.jit wrapper with donation",
    "training.train_lib:TrainConfig.compress_pods": _NOT_READ,
    "training.train_lib:TrainConfig.compress_rank": _NOT_READ,
    "training.train_lib:TrainConfig.log_every": _NOT_READ,
    "training.lm_serve:ServeConfig.eos_id": _NOT_READ,
    "data.pipeline:Tree": _PYTREE,
    "io.checkpoint:Tree": _PYTREE,
    "models.lm:Tree": _PYTREE,
    "training.serve_lib:Tree": _PYTREE,
}


def _public(name):
    return not name.startswith("_")


def _class_names(node):
    out = set()
    for b in node.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(b.name)
        elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
            out.add(b.target.id)
        elif isinstance(b, ast.Assign):
            out.update(t.id for t in b.targets if isinstance(t, ast.Name))
    return {f"{node.name}.{n}" for n in out if _public(n)}


def _names(path: Path, with_imports: bool):
    """Public module-level and class-level names of one source file (and
    the names it imports, ``with_imports``)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if _public(node.name):
                out.add(node.name)
                if isinstance(node, ast.ClassDef):
                    out |= _class_names(node)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name) and _public(t.id))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            if _public(node.target.id):
                out.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def _surface(pkg: str, with_imports: bool):
    root = SRC / pkg
    return {str(p.relative_to(root))[:-3].replace("/", "."):
            _names(p, with_imports) for p in sorted(root.rglob("*.py"))}


REF = _surface("repro", with_imports=False)
PORT = _surface("repro_torch", with_imports=True)


def _in_port(key: str) -> bool:
    mod, name = key.split(":")
    return name in PORT.get(mod, set())


def _gaps():
    return sorted(f"{mod}:{name}" for mod, names in REF.items()
                  for name in names if name not in PORT.get(mod, set()))


def test_every_reference_name_has_a_place_in_the_port():
    unplaced = [k for k in _gaps() if k not in RENAMES and k not in
                NOT_PORTED]
    assert not unplaced, (
        "public names of src/repro/ with no counterpart in src/repro_torch/ "
        f"(port them, or map them here with a reason): {unplaced}")


@pytest.mark.parametrize("key", sorted(RENAMES))
def test_each_rename_names_a_gap_and_an_existing_port_name(key):
    mod, name = key.split(":")
    assert name in REF.get(mod, set()), f"{key} is gone from the reference"
    assert not _in_port(key), f"{key} is now in the port: drop the rename"
    assert _in_port(RENAMES[key]), f"{RENAMES[key]} is not in the port"


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_each_unported_name_names_a_gap_and_a_reason(key):
    mod, name = key.split(":")
    assert name in REF.get(mod, set()), f"{key} is gone from the reference"
    assert not _in_port(key), f"{key} is now in the port: drop the entry"
    assert NOT_PORTED[key].strip()


@pytest.mark.parametrize("key", [
    "core.losses:rmse", "core.losses:accuracy",
    "core.quantize:quantize_uniform", "core.split:brute_force_best_split",
    "core.tree:route_level", "core.tree:tree_leaf_index",
    "core.tree:predict_tree", "core.tree:predict_forest",
    "core.boosting:GBDTConfig.resolve", "core.boosting:boost_scan"])
def test_the_benches_helpers_are_in_the_port(key):
    mod, name = key.split(":")
    assert name in REF[mod] and _in_port(key)

