"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA card with the CUDA toolkit and
skip elsewhere.  Run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import forest as FO
from repro_torch.core import histogram as H
from repro_torch.core import quantize as Q
from repro_torch.core.tree import heap_to_node_arrays
from repro_torch.kernels import (hist_kernel, predict_kernel,
                                 predict_quant_kernel, ref, split_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,B,C,levels", [(3000, 5, 256, 6, 3),
                                            (2500, 3, 37, 11, 4),
                                            (700, 2, 16, 2, 5)])
def test_hist_nodes_kernel_matches_plain(dev, n, m, B, C, levels):
    g = torch.Generator(device=dev).manual_seed(n)
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.rand((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    state = H.init_level_state(n, device=dev)
    for lvl in range(levels):
        if lvl:
            state = H.advance_level_state(
                state, torch.rand(n, generator=g, device=dev) < 0.3)
        side, built = H.smaller_children(state.counts) if lvl else (
            None, torch.ones(1, dtype=torch.bool, device=dev))
        bc = torch.where(built, state.counts, 0).to(torch.int32)
        stats_p = stats[state.order.long()].contiguous()
        args = (codes_t, state.order, stats_p, state.counts, bc)
        out = hist_kernel.hist_nodes(*args, n_bins=B)
        assert torch.equal(out, hist_kernel.hist_nodes(*args, n_bins=B))
        plain = ref.hist_nodes_ref(*[a.cpu() for a in args], n_bins=B)
        # Same summation order as the plain version on the CPU.
        np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize("nodes,m,B,C", [(32, 9, 256, 6), (5, 4, 31, 17),
                                         (3, 3, 8, 2)])
def test_split_scan_kernel_matches_plain(dev, nodes, m, B, C):
    g = torch.Generator(device=dev).manual_seed(C)
    hist = torch.randn((nodes, m, B, C), generator=g, device=dev)
    hist[..., -1] = torch.randint(0, 9, (nodes, m, B), generator=g,
                                  device=dev).float()
    mask = (torch.rand(m, generator=g, device=dev) < 0.8).float()
    mask[0] = 1.0
    for min_data in (1.0, 30.0, 1e9):
        gain, idx = split_kernel.split_scan(hist, 1.0, min_data, mask)
        pg, pi = ref.split_scan_ref(hist.cpu(), 1.0, min_data, mask.cpu())
        assert torch.equal(idx.cpu(), pi)
        torch.testing.assert_close(gain.cpu(), pg, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,D,W,T,depth", [(1000, 512, 512, 5, 6),
                                           (333, 700, 1, 7, 3),
                                           (50, 3, 3, 2, 1)])
def test_forest_traverse_kernel_bitwise(dev, n, D, W, T, depth):
    g = torch.Generator(device=dev).manual_seed(n)
    M = 9
    feat = torch.randint(0, M, (T, 2 ** depth - 1), generator=g, device=dev,
                         dtype=torch.int32)
    thr = torch.randint(0, 256, (T, 2 ** depth - 1), generator=g,
                        device=dev, dtype=torch.int32)
    value = torch.randn((T, 2 ** depth, W), generator=g, device=dev)
    feat, thr, left, right, leaf = heap_to_node_arrays(feat, thr, value)
    codes = torch.randint(0, 256, (n, M), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cols = torch.randint(0, D - W + 1, (T,), generator=g, device=dev,
                         dtype=torch.int32)
    F0 = torch.randn((n, D), generator=g, device=dev)
    args = (codes, feat, thr, left, right, leaf, cols, 0.07)
    out = predict_kernel.forest_traverse(F0.clone(), *args, depth=depth)
    plain = ref.forest_apply_ref(F0.cpu(), *[a.cpu() if torch.is_tensor(a)
                                             else a for a in args],
                                 depth=depth)
    assert torch.equal(out.cpu(), plain)


def test_wrappers_count_launches(dev):
    before = predict_kernel.KERNEL.launches
    F = torch.zeros((4, 2), device=dev)
    feat, thr, left, right, leaf = heap_to_node_arrays(
        torch.zeros((1, 1), dtype=torch.int32, device=dev),
        torch.zeros((1, 1), dtype=torch.int32, device=dev),
        torch.ones((1, 2, 2), device=dev))
    predict_kernel.forest_traverse(
        F, torch.zeros((4, 1), dtype=torch.uint8, device=dev), feat, thr,
        left, right, leaf, torch.zeros(1, dtype=torch.int32, device=dev),
        1.0, depth=1)
    assert predict_kernel.KERNEL.launches == before + 1
    with pytest.raises(ValueError):
        predict_kernel.forest_traverse(
            F, torch.zeros((4, 1), dtype=torch.int32, device=dev), feat, thr,
            left, right, leaf, torch.zeros(1, dtype=torch.int32, device=dev),
            1.0, depth=1)


def _quant_forest(g, dev, T, depth, W, M, dtype):
    """Random heap trees with quantized storage: uint8 thresholds, int8 or
    bfloat16 leaves and a per-tree scale."""
    feat = torch.randint(0, M, (T, 2 ** depth - 1), generator=g, device=dev,
                         dtype=torch.int32)
    thr = torch.randint(0, 256, (T, 2 ** depth - 1), generator=g,
                        device=dev, dtype=torch.int32)
    value = torch.randn((T, 2 ** depth, W), generator=g, device=dev)
    feat, thr, left, right, leaf = heap_to_node_arrays(feat, thr, value)
    if dtype == torch.int8:
        leaf = torch.clamp(torch.round(leaf * 60), -127, 127).to(torch.int8)
        scale = torch.rand((T, 1), generator=g, device=dev) * 0.03
    else:
        leaf = leaf.to(torch.bfloat16)
        scale = torch.ones((T, 1), device=dev)
    return feat, thr.to(torch.uint8), left, right, leaf.contiguous(), scale


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n,D,W,T,depth", [(1000, 512, 512, 5, 6),
                                           (333, 700, 1, 7, 3),
                                           (50, 3, 3, 2, 1)])
def test_forest_traverse_quant_kernel_bitwise(dev, dtype, n, D, W, T, depth):
    """B5 against its plain version, and against B3 on the dequantized
    forest, full-width and narrow blocks."""
    g = torch.Generator(device=dev).manual_seed(n + W)
    M = 9
    feat, thr, left, right, leaf, scale = _quant_forest(g, dev, T, depth, W,
                                                        M, dtype)
    codes = torch.randint(0, 256, (n, M), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cols = torch.randint(0, D - W + 1, (T,), generator=g, device=dev,
                         dtype=torch.int32)
    F0 = torch.randn((n, D), generator=g, device=dev)
    args = (codes, feat, thr, left, right, leaf, scale, cols, 0.07)
    out = predict_quant_kernel.forest_traverse_quant(F0.clone(), *args,
                                                     depth=depth)
    plain = ref.forest_apply_quant_ref(F0.clone().cpu(), *[
        a.cpu() if torch.is_tensor(a) else a for a in args], depth=depth)
    assert torch.equal(out.cpu(), plain)
    deq = leaf.float() * scale[:, :, None]
    twin = predict_kernel.forest_traverse(
        F0.clone(), codes, feat, thr.to(torch.int32), left, right, deq,
        cols, 0.07, depth=depth)
    assert torch.equal(out, twin)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_quantized_compacted_forest_on_card(dev, dtype):
    """A pruned and compacted forest (N a multiple of 8, shallower walk),
    quantized, scores on the card as its plain version does on the CPU."""
    rng = np.random.default_rng(5)
    T, depth, W, M, n = 6, 6, 40, 11, 777
    h = 2 ** depth - 1
    feat, thr, left, right, leaf = heap_to_node_arrays(
        torch.from_numpy(rng.integers(0, M, (T, h)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 255, (T, h)).astype(np.int32)),
        torch.from_numpy(rng.normal(size=(T, h + 1, W)).astype(np.float32)))
    gain = rng.random((T, h))
    gain[:, h // 2:] *= 0.5             # the deepest splits all go at 0.6
    gain = np.concatenate([gain, np.zeros((T, h + 1))], 1)
    cover = FO._heap_cover(torch.from_numpy(
        rng.integers(0, 50, (T, h + 1)).astype(np.float32)))
    pf = FO.PackedForest(
        feat=feat, thr=thr, left=left, right=right, leaf=leaf,
        out_col=torch.zeros(T, dtype=torch.int32),
        base=torch.from_numpy(rng.normal(size=W).astype(np.float32)),
        lr=torch.tensor(0.1), cover=cover,
        gain=torch.from_numpy(gain.astype(np.float32)),
        node_count=torch.full((T,), 2 * h + 1, dtype=torch.int32),
        depth=depth)
    qf = Q.quantize_forest(FO.compact_forest(FO.prune_forest(pf, 0.6)), dtype)
    assert qf.n_nodes % 8 == 0 and qf.n_nodes < 2 * h + 1 and qf.depth < depth
    codes = torch.from_numpy(rng.integers(0, 256, (n, M)).astype(np.uint8))
    plain = FO.predict_raw(qf, codes)
    on_card = FO.predict_raw(
        qf._replace(**{k: v.to(dev) for k, v in qf._asdict().items()
                       if torch.is_tensor(v) and k != "lr"}), codes.to(dev),
        row_chunk=100)
    assert torch.equal(on_card.cpu(), plain)


def test_predict_raw_pipelined_on_card(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    feat, thr, left, right, leaf, scale = _quant_forest(g, dev, 4, 5, 16, 7,
                                                        torch.int8)
    qf = Q.QuantizedForest(
        feat=feat, thr=thr, left=left, right=right, leaf=leaf,
        leaf_scale=scale, out_col=torch.zeros(4, dtype=torch.int32,
                                              device=dev),
        base=torch.randn(16, generator=g, device=dev), lr=torch.tensor(0.3),
        depth=5)
    codes = torch.randint(0, 256, (5000, 7), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    want = FO.predict_raw(qf, codes)
    # Raw features staged through pinned memory and binned on the card.
    edges = torch.sort(torch.randn((7, 255), generator=g, device=dev),
                       dim=1).values
    q = Q.Quantizer(edges=edges, n_bins=256)
    X = torch.randn((5000, 7), generator=g, device=dev)
    binned = FO.predict_raw(qf, Q.codes_rows(Q.apply_quantizer(q, X)))
    for row_chunk in (512, 999, 8192):
        got = FO.predict_raw_pipelined(qf, codes.cpu(), row_chunk=row_chunk)
        on_card = FO.predict_raw_pipelined(qf, codes, row_chunk=row_chunk)
        feats = FO.predict_raw_pipelined(
            qf, X.cpu().numpy(), row_chunk=row_chunk,
            prepare=lambda x: Q.codes_rows(Q.apply_quantizer(q, x)))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(on_card, want)
        assert torch.equal(feats, binned)


def test_quant_wrapper_counts_launches_and_checks_types(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.int8, torch.bfloat16):
        feat, thr, left, right, leaf, scale = _quant_forest(g, dev, 1, 1, 2,
                                                            1, dtype)
        kernel = predict_quant_kernel.KERNELS[dtype]
        before = kernel.launches
        F = torch.zeros((4, 2), device=dev)
        codes = torch.zeros((4, 1), dtype=torch.uint8, device=dev)
        col = torch.zeros(1, dtype=torch.int32, device=dev)
        predict_quant_kernel.forest_traverse_quant(
            F, codes, feat, thr, left, right, leaf, scale, col, 1.0, depth=1)
        assert kernel.launches == before + 1
        with pytest.raises(ValueError):     # int32 thresholds are B3's
            predict_quant_kernel.forest_traverse_quant(
                F, codes, feat, thr.to(torch.int32), left, right, leaf,
                scale, col, 1.0, depth=1)
        with pytest.raises(ValueError):     # float32 leaves are B3's
            predict_quant_kernel.forest_traverse_quant(
                F, codes, feat, thr, left, right, leaf.float(), scale, col,
                1.0, depth=1)
        assert kernel.launches == before + 1
