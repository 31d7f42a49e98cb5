"""Port vs reference: the checkpoint format, read and written both ways.

A forest fitted by the JAX package is checkpointed by one package and
loaded by the other; every array field must come back with the same dtype
and bits, and the manifest with the same metadata.  Legacy heap steps (v1,
v2) and a v4 training step of the JAX package load in the port as well.
bfloat16 arrays cross as ``uint16`` bit views on the numpy side.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import quantize as JQ
from repro.data.pipeline import make_tabular
from repro.io import checkpoint as JC
from repro.training.serve_lib import ForestServer as JServer
from repro_torch.core import quantize as TQ
from repro_torch.io import checkpoint as TC
from repro_torch.io import convert
from repro_torch.training.serve_lib import ForestServer as TServer
from test_explain import save_legacy_heap_checkpoint


@pytest.fixture(scope="module")
def jax_model():
    X, y = make_tabular("multiclass", 600, 8, 5, seed=11)
    cfg = JB.GBDTConfig(n_trees=4, depth=4, sketch_k=2, use_kernel="jnp",
                        loop="python")
    return JB.SketchBoost(cfg).fit(X, y), X


def _bits(v):
    """Any array of either package as a host numpy array; bfloat16 as its
    uint16 bits."""
    if torch.is_tensor(v):
        if v.dtype == torch.bfloat16:
            return v.cpu().view(torch.int16).numpy().view(np.uint16)
        return v.cpu().numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_forest(port, ref):
    """Same forest type, fields, dtypes, bits and walk bound."""
    assert type(port).__name__ == type(ref).__name__
    assert port.depth == ref.depth
    for k, v in ref._asdict().items():
        if k == "depth":
            continue
        got = getattr(port, k)
        assert (got is None) == (v is None), k
        if v is not None:
            a, b = _bits(got), _bits(v)
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


def _jax_forest(jm, quantize):
    return (jm.packed if quantize == "none"
            else JQ.quantize_forest(jm.packed, quantize))


def _port_forest(jm, quantize):
    arrays = {k: (None if v is None else np.array(v))
              for k, v in jm.packed._asdict().items() if k != "depth"}
    pf = convert.packed_forest_from_arrays(arrays, depth=jm.packed.depth,
                                           device="cpu")
    return pf if quantize == "none" else TQ.quantize_forest(pf, quantize)


def _port_quantizer(jm):
    return convert.quantizer_from_edges(np.asarray(jm.quantizer.edges),
                                        jm.quantizer.n_bins, device="cpu")


def _manifest(root, step=0):
    with open(os.path.join(root, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


QUANT = ["none", "int8", "bfloat16"]


@pytest.mark.parametrize("quantize", QUANT)
def test_jax_written_v5_loads_in_port(tmp_path, jax_model, quantize):
    jm, _ = jax_model
    JC.save_forest_checkpoint(str(tmp_path), _jax_forest(jm, quantize),
                              jm.quantizer, metadata={"loss": "multiclass"})
    ref, ref_q, ref_meta = JC.load_forest_checkpoint(str(tmp_path))
    port, q, meta = TC.load_forest_checkpoint(str(tmp_path), device="cpu")
    assert_same_forest(port, ref)
    np.testing.assert_array_equal(q.edges.numpy(), np.asarray(ref_q.edges))
    assert q.n_bins == ref_q.n_bins
    assert meta == ref_meta


@pytest.mark.parametrize("quantize", QUANT)
def test_port_written_v5_loads_in_jax(tmp_path, jax_model, quantize):
    """The port writes what the reference writes: the same keys and
    metadata, and arrays the reference loads bit for bit."""
    jm, _ = jax_model
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    TC.save_forest_checkpoint(port_dir, _port_forest(jm, quantize),
                              _port_quantizer(jm),
                              metadata={"loss": "multiclass"})
    JC.save_forest_checkpoint(ref_dir, _jax_forest(jm, quantize),
                              jm.quantizer, metadata={"loss": "multiclass"})
    got, got_q, got_meta = JC.load_forest_checkpoint(port_dir)
    assert_same_forest(got, _jax_forest(jm, quantize))
    np.testing.assert_array_equal(np.asarray(got_q.edges),
                                  np.asarray(jm.quantizer.edges))
    port_m, ref_m = _manifest(port_dir), _manifest(ref_dir)
    assert port_m["keys"] == ref_m["keys"]
    assert port_m["metadata"] == ref_m["metadata"]
    assert got_meta == JC.load_forest_checkpoint(ref_dir)[2]


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_heap_steps_upgrade_as_in_reference(tmp_path, jax_model,
                                                   version):
    jm, _ = jax_model
    save_legacy_heap_checkpoint(str(tmp_path), jm, version=version,
                                metadata={"loss": "multiclass"})
    ref, _, ref_meta = JC.load_forest_checkpoint(str(tmp_path))
    port, _, meta = TC.load_forest_checkpoint(str(tmp_path), device="cpu")
    assert_same_forest(port, ref)
    assert meta == ref_meta and meta["format_version"] == version
    assert (port.cover is None) == (version == 1)


def test_jax_training_checkpoint_serves_in_port(tmp_path):
    """A v4 step written by a JAX fit with ``save_every`` is a serving step:
    the port ignores its ``train/*`` arrays and serves the forest."""
    X, y = make_tabular("multiclass", 500, 6, 4, seed=5)
    cfg = JB.GBDTConfig(n_trees=4, depth=3, sketch_k=2, use_kernel="jnp",
                        save_every=2, ckpt_dir=str(tmp_path))
    JB.SketchBoost(cfg).fit(X, y)
    ref, _, ref_meta = JC.load_forest_checkpoint(str(tmp_path))
    port, _, meta = TC.load_forest_checkpoint(str(tmp_path), device="cpu")
    assert meta["format_version"] == 5 and "train" in meta
    assert_same_forest(port, ref)
    assert meta == ref_meta
    got = TServer.from_checkpoint(str(tmp_path), device="cpu").predict(X[:50])
    want = JServer.from_checkpoint(str(tmp_path)).predict(X[:50])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# -- CheckpointManager: the atomicity rules of the reference -----------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "opt": {"m": torch.zeros((8, 4)), "step": np.int32(3)},
            "half": torch.randn(5, generator=g).to(torch.bfloat16),
            "codes": torch.arange(6, dtype=torch.uint8)}


def _assert_state_equal(got, want):
    flat = dict(TC._flatten(want))
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(torch.as_tensor(v)),
                                      err_msg=k)
        assert got[k].dtype == torch.as_tensor(v).dtype, k


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_roundtrip_keeps_dtypes(tmp_path, async_save):
    mgr = TC.CheckpointManager(str(tmp_path), async_save=async_save)
    state = _state()
    mgr.save(7, state, metadata={"note": "x"})
    got, step = mgr.restore_raw()
    assert step == 7
    _assert_state_equal(got, state)
    meta = mgr.manifest(7)["metadata"]
    assert meta["note"] == "x" and meta["_dtypes"] == {"half": "bfloat16"}


def test_reference_reads_port_bfloat16(tmp_path):
    state = _state(1)
    TC.CheckpointManager(str(tmp_path), async_save=False).save(1, state)
    raw, _ = JC.CheckpointManager(str(tmp_path), async_save=False)\
        .restore_raw()
    assert raw["half"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(raw["half"]), _bits(state["half"]))
    np.testing.assert_array_equal(raw["opt/m"], state["opt"]["m"].numpy())


def test_keep_n_gc(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_manifestless_step_is_ignored_and_latest_wins(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.arange(4)})
    corpse = os.path.join(str(tmp_path), "step_9")
    os.makedirs(corpse)
    with open(os.path.join(corpse, "state.npz"), "wb") as f:
        f.write(b"partial garbage")
    assert mgr.latest_step() == 3
    got, step = mgr.restore_raw()
    assert step == 3
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4))
    # LATEST names a valid older step: it wins over the newest step dir.
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write("2")
    assert mgr.latest_step() == 2


def test_keep_n_keeps_the_newest_valid_step(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    mgr.save(1, {"w": torch.arange(4)})
    corpse = os.path.join(str(tmp_path), "step_5")
    os.makedirs(corpse)
    open(os.path.join(corpse, "state.npz"), "wb").close()
    stale = os.path.join(str(tmp_path), ".tmp_step_3_deadbeef")
    os.makedirs(stale)
    mgr.save(6, {"w": torch.arange(4)})
    assert mgr.all_steps() == [1, 6]
    assert not os.path.exists(corpse) and not os.path.exists(stale)
