"""The port's examples (`repro_torch.examples`) on the CPU at cut sizes.

Each example runs through its ``main`` with ``--device cpu``, and its own
checks hold: the serving example's float32 server equals the in-memory
model bit for bit, the explain example's attributions decompose the raw
scores (local accuracy within 1e-4), and ``distributed_gbdt`` runs on a
(2, 1) mesh of two gloo ranks.  Without ``--device`` each example needs the
CUDA card, and says so before doing any work.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.examples import (distributed_gbdt, explain_gbdt, quickstart,
                                  serve_gbdt)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_compares_every_sketch_method():
    out = quickstart.main(["--device", "cpu", "--rows", "1200", "--trees",
                           "6", "--depth", "3"])
    assert [r["method"] for r in out["methods"]] == [
        m for m, _ in quickstart.METHODS]
    for r in out["methods"]:
        assert np.isfinite(r["test_loss"]) and r["rounds"] == 6
        assert r["accuracy"] > 2 / 9                 # well above chance


def test_serve_gbdt_checks_hold():
    out = serve_gbdt.main(["--device", "cpu", "--rows", "800", "--trees",
                           "6"])
    assert out["fp32_bitwise"] and out["models"] == 3
    assert out["compression"]["quantize"] == "int8"
    assert (out["compression"]["bytes_after"]
            < out["compression"]["bytes_before"])
    assert out["int8_argmax_agree"] > 0.9


def test_explain_gbdt_checks_hold():
    out = explain_gbdt.main(["--device", "cpu", "--rows", "800", "--trees",
                             "5", "--explain-rows", "32"])
    assert out["local_accuracy_err"] < 1e-4
    assert out["phi_shape"] == [32, 20, 6]
    assert out["embedding_shape"] == [4, 5]


def test_distributed_gbdt_on_two_gloo_ranks():
    out = distributed_gbdt.main(["--device", "cpu", "--mesh", "2,1",
                                 "--rows", "2048", "--trees", "4",
                                 "--compressed-trees", "2"])
    assert out["mesh"] == [2, 1] and out["n_trees"] == 4
    assert [h["round"] for h in out["history"]] == [0]
    assert out["accuracy"] > 2 / 16 and out["compressed_accuracy"] > 1 / 16
    assert 0 < out["bytes_model"]["moved_bytes"] < out["bytes_model"][
        "exact_bytes"]


@pytest.mark.parametrize("name", ["quickstart", "serve_gbdt",
                                  "explain_gbdt", "distributed_gbdt"])
def test_examples_run_on_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
