"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA card with the CUDA toolkit and
skip elsewhere.  Run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import explain as EX
from repro_torch.core import forest as FO
from repro_torch.core import histogram as H
from repro_torch.core import quantize as Q
from repro_torch.core.tree import heap_to_node_arrays
from repro_torch.kernels import (decode_attention, flash_attention,
                                 hist_kernel, predict_kernel,
                                 predict_quant_kernel, ref, shap_kernel,
                                 split_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


R = ref.TILE_ROWS


@pytest.mark.parametrize("n,m,B,C,levels", [(3000, 5, 256, 6, 3),
                                            (2500, 3, 37, 11, 4),
                                            (700, 2, 16, 2, 5),
                                            (3 * R + 17, 4, 256, 6, 3),
                                            (3 * R + 17, 2, 37, 13, 2)])
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
        # Same summation order as the plain version on the CPU, so the
        # same bits.
        assert torch.equal(out.cpu(), plain), float(
            (out.cpu() - plain).abs().max())
        assert torch.equal(out[..., -1].cpu(), plain[..., -1])


@pytest.mark.parametrize("nodes,m,B,C", [(32, 9, 256, 6), (5, 4, 31, 17),
                                         (3, 3, 8, 2), (4, 5, 64, 513)])
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


def _split_pair(hist, mask, min_data):
    """B2 on the card twice and its plain version on the CPU."""
    gain, idx = split_kernel.split_scan(hist, 1.0, min_data, mask)
    gain2, idx2 = split_kernel.split_scan(hist, 1.0, min_data, mask)
    torch.cuda.synchronize()
    assert torch.equal(gain, gain2) and torch.equal(idx, idx2)
    pg, pi = ref.split_scan_ref(hist.cpu(), 1.0, min_data, mask.cpu())
    return gain.cpu(), idx.cpu(), pg, pi


@pytest.mark.parametrize("nodes", [1, 2])
@pytest.mark.parametrize("B,C", [(8, 2), (31, 17), (256, 6), (256, 64),
                                 (31, 64), (8, 17), (256, 65), (256, 513),
                                 (31, 1024), (256, 200), (256, 12),
                                 (256, 32), (256, 33)])
def test_split_scan_few_nodes(dev, nodes, B, C):
    """A tree's root and a leaf-wise expansion at every run length (B = 8,
    31, 256 bins over 32 lanes): the narrow kernel at each channel template
    (C = 2, 12, 17, 32), the wide one (C > 32) at whole and partial chunks
    and spans of channels (C - 1 = 32, 63, 64, 199, 512, 1,023); two runs
    equal."""
    g = torch.Generator(device=dev).manual_seed(nodes * B + C)
    m = 9
    hist = torch.randn((nodes, m, B, C), generator=g, device=dev)
    hist[..., -1] = torch.randint(0, 9, (nodes, m, B), generator=g,
                                  device=dev).float()
    mask = torch.ones(m, device=dev)
    mask[3] = 0.0
    for min_data in (1.0, 20.0):
        gain, idx, pg, pi = _split_pair(hist, mask, min_data)
        assert torch.equal(idx, pi)
        torch.testing.assert_close(gain, pg, rtol=1e-5, atol=0)


@pytest.mark.parametrize("C", [5, 65, 513, 1024])
@pytest.mark.parametrize("case", ["masked", "min_data"])
def test_split_scan_nothing_legal(dev, case, C):
    """Every feature masked, or min_data above every count: (-inf, 0), on
    the narrow (C = 5) and the wide path."""
    g = torch.Generator(device=dev).manual_seed(5)
    hist = torch.randn((3, 4, 31, C), generator=g, device=dev)
    hist[..., -1] = 2.0
    mask = torch.zeros(4, device=dev) if case == "masked" else torch.ones(
        4, device=dev)
    gain, idx, pg, pi = _split_pair(hist, mask,
                                    1.0 if case == "masked" else 1e9)
    assert torch.isneginf(gain).all() and (idx == 0).all()
    assert torch.equal(idx, pi) and torch.equal(gain, pg)


@pytest.mark.parametrize("nodes,B,C", [(1, 256, 6), (2, 31, 5), (3, 8, 2),
                                       (2, 256, 4), (1, 256, 65),
                                       (2, 31, 513), (3, 256, 513),
                                       (1, 256, 1024)])
def test_split_scan_dyadic_ties_bitwise(dev, nodes, B, C):
    """Gradient sums in quarters and small counts, so every sum is exact:
    the gains are bitwise the plain version's, and where features (0 and
    2) and bins (an empty band) tie, the lowest index wins."""
    rng = np.random.default_rng(B * C + nodes)
    m = 4
    h = (rng.integers(-4, 5, (nodes, m, B, C)) / 4).astype(np.float32)
    h[..., -1] = rng.integers(0, 4, (nodes, m, B))
    h[:, 2] = h[:, 0]
    h[:, :, B // 3:B // 3 + 3] = 0.0
    hist = torch.from_numpy(h).to(dev)
    gain, idx, pg, pi = _split_pair(hist, torch.ones(m, device=dev), 1.0)
    assert torch.equal(idx, pi) and torch.equal(gain, pg)
    assert not ((idx // B) == 2).any()


@pytest.mark.parametrize("B,C", [(256, 2), (37, 2), (256, 6), (256, 32)])
def test_split_scan_empty_bin_at_a_run_start_ties_the_bin_before(dev, B, C):
    """Random (inexact) sums with empty bins where lanes' runs of bins
    start: the narrow kernel's left sums there are the bin before's, bit
    for bit, so it picks the plain version's (lower) bin, and its gains
    are the CPU plain version's bits (squares summed in float64, rounded
    once)."""
    rng = np.random.default_rng(B + C)
    run = -(-B // 32)
    h = rng.normal(size=(8, 5, B, C)).astype(np.float32)
    h[..., -1] = rng.integers(1, 9, (8, 5, B))
    h[:, :, np.arange(run, B - 1, run)] = 0.0
    hist = torch.from_numpy(h).to(dev)
    mask = torch.ones(5, device=dev)
    gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
    pg, pi = ref.split_scan_ref(hist.cpu(), 1.0, 1.0, mask.cpu())
    assert torch.equal(idx.cpu(), pi)
    assert torch.equal(gain.cpu(), pg)


@pytest.mark.parametrize("B", [256, 37])
@pytest.mark.parametrize("C", [33, 64, 513])
def test_split_scan_wide_empty_bin_at_a_run_start_ties_the_bin_before(
        dev, C, B):
    """The wide entry point (C > 32) on random (inexact) sums with empty
    bins where lanes' runs of bins start: each channel's left sums are
    summed bin by bin in double, so an empty bin's are the bin before's,
    bit for bit, the two gains tie, and the kernel picks the CPU plain
    version's (lower) bin, with the CPU's gains bit for bit."""
    rng = np.random.default_rng(B * C)
    run = -(-B // 32)
    h = rng.normal(size=(6, 4, B, C)).astype(np.float32)
    h[..., -1] = rng.integers(1, 9, (6, 4, B))
    h[:, :, np.arange(run, B - 1, run)] = 0.0
    hist = torch.from_numpy(h).to(dev)
    mask = torch.ones(4, device=dev)
    before = split_kernel.WIDE_KERNEL.launches
    for min_data in (1.0, 100.0):
        gain, idx = split_kernel.split_scan(hist, 1.0, min_data, mask)
        pg, pi = ref.split_scan_ref(hist.cpu(), 1.0, min_data, mask.cpu())
        assert torch.equal(idx.cpu(), pi)
        assert torch.equal(gain.cpu(), pg)
        g2, i2 = split_kernel.split_scan(hist, 1.0, min_data, mask)
        assert torch.equal(gain, g2) and torch.equal(idx, i2)
    assert split_kernel.WIDE_KERNEL.launches == before + 4


def test_split_scan_wide_fractional_counts(dev):
    """Weighted rows (GOSS's 8.0, SGB's 0/1, and non-dyadic weights) make
    fractional counts in the count channel: the wide kernel sums them bin
    by bin in double as the CPU does, and ``min_data`` cuts where the
    CPU's does: the CPU's indices and gains, bit for bit."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=(4, 5, 256, 65)).astype(np.float32)
    h[..., -1] = (rng.integers(0, 4, (4, 5, 256))
                  * rng.choice([0.0, 1.0, 8.0, 2.6666667], (4, 5, 256))
                  ).astype(np.float32)
    hist = torch.from_numpy(h).to(dev)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    for min_data in (1.0, 37.3, 400.0):
        gain, idx = split_kernel.split_scan(hist, 1.0, min_data, mask)
        pg, pi = ref.split_scan_ref(hist.cpu(), 1.0, min_data, mask.cpu())
        assert torch.equal(idx.cpu(), pi)
        assert torch.equal(gain.cpu(), pg)


@pytest.mark.parametrize("C,wide", [(2, False), (32, False), (33, True),
                                    (1024, True)])
def test_split_scan_wrapper_counts_each_path(dev, C, wide):
    """Up to 32 channels go to ``KERNEL``, more to ``WIDE_KERNEL``; each
    launch adds one to that kernel's count only."""
    hist = torch.randn((2, 3, 8, C), device=dev)
    hist[..., -1] = 4.0
    mask = torch.ones(3, device=dev)
    narrow, wide_n = (split_kernel.KERNEL.launches,
                      split_kernel.WIDE_KERNEL.launches)
    gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
    pg, pi = ref.split_scan_ref(hist.cpu(), 1.0, 1.0, mask.cpu())
    assert torch.equal(idx.cpu(), pi)
    torch.testing.assert_close(gain.cpu(), pg, rtol=1e-5, atol=0)
    assert split_kernel.KERNEL.launches == narrow + (not wide)
    assert split_kernel.WIDE_KERNEL.launches == wide_n + wide
    with pytest.raises(ValueError):
        split_kernel.split_scan(torch.zeros((1, 3, 8, 1025), device=dev),
                                1.0, 1.0, mask)
    with pytest.raises(ValueError):                # the wide path's bins
        split_kernel.split_scan(torch.zeros((1, 3, 257, 65), device=dev),
                                1.0, 1.0, mask)


# B3/B5 cases: (n, D, W, T, depth, layout, M, cols), the forest from
# `test_torch_traverse.random_forest` ("heap" of that depth, "pointer":
# leaf-wise trees with N = 255 walking deeper than 6, "compact": the node
# axis padded to a multiple of 8) and ``cols`` "random" windows,
# "straddle" (every window [40, 80) across the 64-column tiles' edge) or
# "ova" (width 1 at column t % D: the one-vs-all layout).
TRAVERSE_CASES = [
    (1000, 512, 512, 5, 6, "heap", 9, "random"),
    (333, 700, 1, 7, 3, "heap", 9, "random"),
    (50, 3, 3, 2, 1, "heap", 9, "random"),
    (256, 512, 512, 100, 6, "heap", 100, "random"),     # the serving window
    (1000, 512, 512, 37, 6, "heap", 9, "random"),       # T off the groups
    (20_000, 512, 512, 10, 6, "heap", 100, "random"),   # the large tile
    (1001, 300, 300, 9, 6, "heap", 9, "random"),        # n, D off the tiles
    (777, 200, 40, 12, 6, "heap", 9, "straddle"),       # W < D across tiles
    (300, 512, 1, 600, 6, "heap", 9, "ova"),            # T past one list
    (500, 96, 96, 6, 0, "pointer", 9, "random"),        # leaf-wise, N = 255
    (123, 64, 64, 5, 6, "compact", 9, "random"),        # compacted nodes
    (40, 64, 64, 5, 6, "heap", 7000, "random"),         # codes not staged
    (9000, 512, 512, 3, 6, "heap", 3000, "random"),     # 48 KB of codes
    (300, 130, 130, 4, 6, "heap", 9, "random"),         # rows off vectors
]


def _traverse_case(dev, n, D, W, T, depth, layout, M, cols, seed,
                   dtype=None):
    """``(codes, feat, thr, left, right, leaf, scale, out_col, F0,
    depth)`` on the card for a `TRAVERSE_CASES` entry; ``dtype`` int8 or
    bfloat16 gives B5's storage (``scale`` None for B3)."""
    from test_torch_traverse import quantized, random_forest
    rng = np.random.default_rng(seed)
    f = random_forest(rng, layout, T, W, M, D, depth=depth)
    if layout == "pointer":
        assert f["feat"].shape[1] == 255 and f["depth"] > 6
    if cols == "straddle":
        f["out_col"] = np.full(T, 40, np.int32)
    elif cols == "ova":
        f["out_col"] = (np.arange(T) % D).astype(np.int32)
    scale = None
    if dtype is not None:
        f = quantized(rng, f, dtype)
        scale = torch.from_numpy(f["scale"])[:, None]
    codes = rng.integers(0, 256, (n, M)).astype(np.uint8)
    F0 = rng.normal(size=(n, D)).astype(np.float32)
    on = [torch.as_tensor(a).to(dev) for a in (
        codes, f["feat"], f["thr"], f["left"], f["right"], f["leaf"])]
    return (*on, None if scale is None else scale.to(dev),
            torch.from_numpy(f["out_col"]).to(dev),
            torch.from_numpy(F0).to(dev), f["depth"])


@pytest.mark.parametrize("n,D,W,T,depth,layout,M,cols", TRAVERSE_CASES)
def test_forest_traverse_kernel_bitwise(dev, n, D, W, T, depth, layout, M,
                                        cols):
    """B3 bitwise its plain version on the CPU and equal run to run."""
    (codes, feat, thr, left, right, leaf, _, out_col, F0,
     depth) = _traverse_case(dev, n, D, W, T, depth, layout, M, cols, n + T)
    args = (codes, feat, thr, left, right, leaf, out_col, 0.07)
    out = predict_kernel.forest_traverse(F0.clone(), *args, depth=depth)
    again = predict_kernel.forest_traverse(F0.clone(), *args, depth=depth)
    plain = ref.forest_apply_ref(F0.cpu(), *[a.cpu() if torch.is_tensor(a)
                                             else a for a in args],
                                 depth=depth)
    assert torch.equal(out.cpu(), plain)
    assert torch.equal(out, again)


@pytest.mark.parametrize("n,M,cols", [(256, 100, 64), (256, 7000, 64),
                                      (262_144, 100, 512),
                                      (262_144, 7000, 512)])
def test_forest_traverse_picks_its_tile(dev, n, M, cols):
    """``predict.cu`` gives a 256-row serving window at D = 512 the
    64-column tile, whose grid gives every SM a block, and a large batch
    the 512-column one; it stages the codes where they fit 48 KB; every
    entry point's build fits a block on an SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, k in ((0, predict_kernel.KERNEL),
                    (1, predict_quant_kernel.KERNELS[torch.int8]),
                    (2, predict_quant_kernel.KERNELS[torch.bfloat16])):
        info = predict_kernel.launch_info(k, kind, n, 512, M)
        assert info["cols"] == cols
        assert info["grid"][0] * info["grid"][1] >= sms
        assert info["stage_codes"] == (M == 100)
        assert info["blocks_per_sm"] >= 1


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


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n,D,W,T,depth,layout,M,cols", TRAVERSE_CASES)
def test_forest_traverse_quant_kernel_bitwise(dev, dtype, n, D, W, T, depth,
                                              layout, M, cols):
    """B5 against its plain version on the CPU, and against B3 on the
    dequantized forest, full-width and narrow blocks; equal run to run."""
    (codes, feat, thr, left, right, leaf, scale, out_col, F0,
     depth) = _traverse_case(dev, n, D, W, T, depth, layout, M, cols, n + W,
                             dtype)
    args = (codes, feat, thr, left, right, leaf, scale, out_col, 0.07)
    out = predict_quant_kernel.forest_traverse_quant(F0.clone(), *args,
                                                     depth=depth)
    again = predict_quant_kernel.forest_traverse_quant(F0.clone(), *args,
                                                       depth=depth)
    plain = ref.forest_apply_quant_ref(F0.cpu(), *[
        a.cpu() if torch.is_tensor(a) else a for a in args], depth=depth)
    assert torch.equal(out.cpu(), plain)
    assert torch.equal(out, again)
    deq = leaf.float() * scale[:, :, None]
    twin = predict_kernel.forest_traverse(
        F0.clone(), codes, feat, thr.to(torch.int32), left, right, deq,
        out_col, 0.07, depth=depth)
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


def _shap_forest(rng, T, depth, W, M, zero_cover=0.2):
    """Random heap trees with covers (some leaf covers zero: z = 0 edges),
    as a CPU `PackedForest`."""
    h = 2 ** depth - 1
    feat, thr, left, right, leaf = heap_to_node_arrays(
        torch.from_numpy(rng.integers(0, M, (T, h)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 255, (T, h)).astype(np.int32)),
        torch.from_numpy(rng.normal(size=(T, h + 1, W)).astype(np.float32)))
    leaf_cover = rng.integers(1, 50, (T, h + 1)).astype(np.float32)
    leaf_cover[rng.uniform(size=leaf_cover.shape) < zero_cover] = 0.0
    gain = np.concatenate([rng.random((T, h)), np.zeros((T, h + 1))], 1)
    return FO.PackedForest(
        feat=feat, thr=thr, left=left, right=right, leaf=leaf,
        out_col=torch.zeros(T, dtype=torch.int32),
        base=torch.zeros(W), lr=torch.tensor(0.1),
        cover=FO._heap_cover(torch.from_numpy(leaf_cover)),
        gain=torch.from_numpy(gain.astype(np.float32)),
        node_count=torch.full((T,), 2 * h + 1, dtype=torch.int32),
        depth=depth)


def _shap_on(dev, codes, pack, out_col, lr, d):
    return shap_kernel.tree_shap(
        codes.to(dev), pack.slot_feat.to(dev), pack.slot_lo.to(dev),
        pack.slot_hi.to(dev), pack.slot_z.to(dev), pack.leaf.to(dev),
        out_col.to(dev), lr, n_outputs=d)


@pytest.mark.parametrize("case", ["wide", "narrow", "pruned", "stump",
                                  "wide_features", "deep", "trees100",
                                  "trees100_narrow", "huge_features",
                                  "row_chunks"])
def test_tree_shap_kernel_bitwise(dev, case):
    """B6 against its plain version (on the CPU): odd row counts, output
    widths that are no multiple of the column chunk, z = 0 edges, a narrow
    block at per-tree columns, a pruned and compacted forest, a stump
    forest, more features than a chunk of columns, paths deeper than the
    depths compiled as constants (the tables read in place: they do not fit
    shared memory), the explain path's 100 depth-6 trees over 100 features
    at a row count that is no multiple of a block's rows (also with per-tree
    narrow columns), more features than one pass of the scatter holds in
    registers, and more rows than one pass through the Psi scratch takes;
    two runs bitwise."""
    rng = np.random.default_rng(len(case))
    n, T, depth, M, d = 333, 5, 6, 37, 700
    if case.startswith("trees100"):
        n, T, depth, M, d = 257, 100, 6, 100, 130
    if case == "huge_features":
        n, T, depth, M, d = 41, 3, 4, 3000, 20
    if case == "row_chunks":
        n, T, depth, M, d = 524_300, 2, 2, 3, 3
    W = 1 if case.endswith("narrow") else d
    if case == "stump":
        n, T, depth, M, d, W = 50, 3, 1, 2, 3, 3
    if case == "wide_features":
        n, T, depth, M, d, W = 77, 2, 4, 300, 40, 40
    if case == "deep":
        n, T, depth, M, d, W = 40, 2, 10, 12, 5, 5
    pf = _shap_forest(rng, T, depth, W, M)
    if case.endswith("narrow"):
        pf = pf._replace(out_col=torch.from_numpy(
            rng.integers(0, d, T).astype(np.int32)))
    if case == "pruned":
        pf = FO.compact_forest(FO.prune_forest(pf, 0.5))
        assert pf.n_nodes < 2 ** (depth + 1) - 1
    pack = EX.build_path_pack(pf)
    codes = torch.from_numpy(rng.integers(0, 256, (n, M)).astype(np.uint8))
    plain = shap_kernel.tree_shap(codes, pack.slot_feat, pack.slot_lo,
                                  pack.slot_hi, pack.slot_z, pack.leaf,
                                  pf.out_col, 0.1, n_outputs=d)
    out = _shap_on(dev, codes, pack, pf.out_col, 0.1, d)
    again = _shap_on(dev, codes, pack, pf.out_col, 0.1, d)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), plain)
    # Local accuracy on the card, against the traversal kernel.
    pfd = pf._replace(**{k: v.to(dev) for k, v in pf._asdict().items()
                         if torch.is_tensor(v) and k != "lr"})
    phi, base = EX.shap_values(pfd, codes.to(dev))
    raw = FO.predict_raw(pfd, codes.to(dev))
    assert float((base + phi.sum(1) - raw).abs().max()) <= 1e-4
    L, D = pack.slot_feat.shape[1:]
    info = shap_kernel.launch_info(n, M, d, T, L, D, W)
    per_pass = info["feature_warps"] * info["features_a_warp"]
    assert info["feature_passes"] == -(-M // per_pass), info
    assert info["staged"] == (case != "deep"), info
    assert (info["chunk_rows"] < n) == (case == "row_chunks"), info


def test_tree_shap_wrapper_counts_launches_and_checks_types(dev):
    rng = np.random.default_rng(0)
    pf = _shap_forest(rng, 2, 3, 4, 5)
    pack = EX.build_path_pack(pf)
    codes = torch.from_numpy(rng.integers(0, 256, (9, 5)).astype(np.uint8))
    before = shap_kernel.KERNEL.launches
    _shap_on(dev, codes, pack, pf.out_col, 0.1, 4)
    assert shap_kernel.KERNEL.launches == before + 1
    with pytest.raises(ValueError):             # codes are uint8
        _shap_on(dev, codes.to(torch.int32), pack, pf.out_col, 0.1, 4)
    with pytest.raises(ValueError):             # deeper than the kernel holds
        deep = pack._replace(**{k: getattr(pack, k).repeat(1, 1, 12)
                                for k in ("slot_feat", "slot_lo", "slot_hi",
                                          "slot_z")})
        _shap_on(dev, codes, deep, pf.out_col, 0.1, 4)
    assert shap_kernel.KERNEL.launches == before + 1


def test_explain_surface_on_card_matches_cpu(dev):
    """A model fitted on the card explains as its forest does on the CPU:
    SHAP bitwise (B6 against its plain version), leaf ids and importances
    equal, local accuracy within 1e-4."""
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multiclass", 2000, 10, 6, seed=2, n_informative=10)
    model = SketchBoost(GBDTConfig(n_trees=6, depth=5, sketch_k=3),
                        device=dev).fit(X, y)
    phi, base = model.shap_values(X[:300], check_additivity=True)
    pf_cpu = model.packed._replace(**{
        k: v.cpu() for k, v in model.packed._asdict().items()
        if torch.is_tensor(v)})
    codes = model._bin(X[:300])
    phi_c, base_c = EX.shap_values(pf_cpu, codes.cpu())
    assert torch.equal(phi.cpu(), phi_c) and torch.equal(base.cpu(), base_c)
    assert torch.equal(model.apply(X[:300]).cpu(),
                       EX.apply_forest(pf_cpu, codes.cpu()))
    for kind in EX.IMPORTANCE_KINDS:
        assert torch.equal(model.feature_importances(kind).cpu(),
                           EX.feature_importances(pf_cpu, kind=kind,
                                                  n_features=10))


def _direct_case(dev, n, m, nodes, B, C, seed):
    """Codes, node of each row (every other node left empty when there are
    four or more) and stats on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    used = torch.arange(0, nodes, 2 if nodes >= 4 else 1, device=dev)
    node_pos = used[torch.randint(0, used.numel(), (n,), generator=g,
                                  device=dev)].to(torch.int32)
    stats = torch.randn((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    return codes_t, node_pos, stats


@pytest.mark.parametrize("n,m,nodes,B,C", [
    (1, 3, 1, 256, 6), (1000, 4, 32, 256, 6), (4096, 3, 1, 2, 1),
    (777, 5, 4, 37, 13), (3000, 2, 64, 256, 8), (513, 6, 8, 17, 2),
    (3 * R + 17, 4, 8, 37, 13), (3 * R + 17, 3, 32, 256, 6),
    (R - 3, 2, 4, 16, 70)])
def test_hist_direct_kernel_bitwise(dev, n, m, nodes, B, C):
    """B4 against its plain version, bitwise, on the card and on the CPU
    (each cell adds its rows in row order within a chunk of R rows, chunks
    in order, in both), and bitwise from run to run; 3R + 17 rows take four
    chunks, 70 channels two channel groups of a feature."""
    args = _direct_case(dev, n, m, nodes, B, C, n + C)
    out = hist_kernel.hist_direct(*args, n_nodes=nodes, n_bins=B)
    again = hist_kernel.hist_direct(*args, n_nodes=nodes, n_bins=B)
    plain = ref.histogram_ref(*args, n_nodes=nodes, n_bins=B)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, plain)
    assert torch.equal(out.cpu(), ref.histogram_ref(
        *[a.cpu() for a in args], n_nodes=nodes, n_bins=B))
    if nodes >= 4:
        assert not out[1::2].any()                  # empty nodes stay zero


def test_hist_direct_wrapper_counts_launches_and_checks_types(dev):
    args = _direct_case(dev, 300, 2, 2, 16, 10, 0)
    before = hist_kernel.DIRECT_KERNEL.launches
    hist_kernel.hist_direct(*args, n_nodes=2, n_bins=16)
    assert hist_kernel.DIRECT_KERNEL.launches == before + 1   # all channels
    codes_t, node_pos, stats = args
    for bad in ((codes_t.int(), node_pos, stats),
                (codes_t, node_pos.long(), stats),
                (codes_t, node_pos, stats.double()),
                (codes_t, node_pos[:-1], stats)):
        with pytest.raises(ValueError):
            hist_kernel.hist_direct(*bad, n_nodes=2, n_bins=16)
    assert hist_kernel.DIRECT_KERNEL.launches == before + 1


@pytest.mark.parametrize("cfg", [dict(hist_engine="direct"),
                                 dict(hist_engine="partition"),
                                 dict(sketch_method="truncated_svd"),
                                 dict(sketch_method="random_sampling"),
                                 dict(sketch_method="top_outputs")])
def test_fit_on_card_matches_cpu(dev, cfg):
    """The whole fit on the card against the CPU (plain versions), same
    data and injected draws: predictions within atol 1e-4, same best
    round; the direct engine launches B4 once a level."""
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multiclass", 3000, 12, 8, seed=3, n_informative=12)
    rng = np.random.default_rng(0)
    draws = ([rng.gumbel(size=(3, 8)).astype(np.float32) for _ in range(6)]
             if cfg.get("sketch_method") == "random_sampling" else
             [rng.normal(size=(8, 3)).astype(np.float32) / np.sqrt(3.0)
              for _ in range(6)])
    config = GBDTConfig(n_trees=6, depth=4, sketch_k=3, min_data_in_leaf=20,
                        early_stopping_rounds=2, **cfg)
    before = hist_kernel.DIRECT_KERNEL.launches
    fits = [SketchBoost(config, device=d).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]), sketch_mats=draws)
        for d in (dev, "cpu")]
    if cfg.get("hist_engine") == "direct":
        assert (hist_kernel.DIRECT_KERNEL.launches - before
                == 4 * len(fits[0].history))
    pred = [f.predict_raw(X[2400:]).cpu() for f in fits]
    assert float((pred[0] - pred[1]).abs().max()) <= 1e-4
    assert fits[0].best_round == fits[1].best_round


# B7: (group, causal, window, s, dh), the shape cases of the CPU tests
# (tests/test_torch_lm.py) and the prefill layer's head width at 1,000 rows.
FLASH_CASES = [
    (1, True, None, 64, 32), (1, False, 50, 200, 120),
    (1, True, 16, 257, 256), (2, False, None, 64, 120),
    (2, True, 50, 200, 32), (2, True, None, 257, 120),
    (4, True, 16, 64, 120), (4, False, 16, 200, 256),
    (4, False, None, 257, 32), (8, True, 50, 64, 256),
    (8, False, None, 200, 32), (8, True, 16, 257, 120),
    (4, True, 256, 1000, 120), (4, False, None, 1000, 120),
    # The tensor-core body's edges, from one 64 x 64 tile up: no mask, the
    # causal band, a window that is no multiple of the 64-key tile, GQA;
    # sq no multiple of 64 (nor of the 128-row block); dh 36 (rows not
    # 16-byte aligned), 64, 128 and 256; group 8 over one kv head.
    (1, False, None, 64, 64), (1, True, None, 64, 64),
    (1, True, 100, 300, 64), (4, True, 70, 333, 128),
    (8, True, 130, 190, 36), (2, False, None, 100, 256),
    (8, False, 90, 129, 128), (4, True, None, 65, 36),
]


def bf16_ulps(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element's own magnitude (0 where it is 0)."""
    m, e = torch.frexp(x.float())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,causal,window,s,dh", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, dtype, group, causal,
                                              window, s, dh):
    """B7 against its plain version on the card: float32 within atol 1e-5
    (the order of the sums differs), bfloat16 each output within one bf16
    ulp of its own plain value plus that 1e-5 (products of bf16 inputs are
    exact in float32; only the sums' order and the last rounding differ)."""
    hkv = 8 // group if group < 8 else 1
    g = torch.Generator(device=dev).manual_seed(s * dh + group)
    q, k, v = (torch.randn((2, h, s, dh), generator=g, device=dev).to(dtype)
               for h in (hkv * group, hkv, hkv))
    before = flash_attention.KERNEL.launches
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    assert flash_attention.KERNEL.launches == before + 1
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    limit = 1e-5 if dtype == torch.float32 else bf16_ulps(plain) + 1e-5
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.parametrize("group,causal,window,s,dh", [
    (4, True, 4096, 2000, 120), (1, False, None, 333, 256),
    (8, True, 70, 190, 36)])
def test_flash_attention_bf16_same_run_to_run(dev, group, causal, window, s,
                                              dh):
    """B7's tensor-core body gives the same bits from run to run."""
    hkv = 8 // group
    g = torch.Generator(device=dev).manual_seed(s + dh)
    q, k, v = (torch.randn((1, h, s, dh), generator=g, device=dev).to(
        torch.bfloat16) for h in (hkv * group, hkv, hkv))
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    again = flash_attention.flash_attention(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def test_flash_attention_wrapper_checks_inputs(dev):
    q = torch.randn((1, 4, 16, 32), device=dev)
    k = torch.randn((1, 2, 16, 32), device=dev)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    before = flash_attention.KERNEL.launches
    flash_attention.flash_attention(q, k, k, causal=False, window=3)
    assert flash_attention.KERNEL.launches == before + 1


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-34b",
                                  "musicgen-medium"])
def test_lm_forward_on_card_matches_cpu(dev, arch):
    """A smoke-config model in float32 on the card against the same model
    on the CPU (plain B7): logits within atol 1e-4 + rtol 1e-4, one B7
    launch a layer."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              n_kv_heads=2)
    model = lm.TransformerLM.random(cfg, torch.Generator().manual_seed(1),
                                    device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 80, cfg.d_model)).astype(np.float32)
         if cfg.embed_inputs else
         rng.integers(0, cfg.vocab_size, (2, 80)).astype(np.int32))
    want = model.forward({"inputs": x})
    before = flash_attention.KERNEL.launches
    out = model.to(dev).forward({"inputs": x})
    assert flash_attention.KERNEL.launches == before + cfg.n_layers
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)


# B8: (batch, hkv, group, s, dh, window, ragged).  Every case has fewer
# (batch row, kv head) pairs than one wave of blocks, so those with more
# than 128 keys split the key axis across blocks
# (`decode_attention.splits_for`).  Groups 1-8 and 6 (three chunks of 2
# heads), dh 32/120/256 and 36 (rows not 16-byte aligned in bf16).
DECODE_CASES = [
    (1, 8, 4, 4096, 120, 4096, False), (2, 1, 1, 519, 32, None, True),
    (3, 2, 2, 200, 120, 16, True), (40, 8, 4, 600, 120, 256, True),
    (2, 2, 8, 300, 64, None, True), (2, 1, 6, 130, 36, 50, True),
    (2, 2, 4, 77, 256, None, True), (40, 8, 1, 128, 256, 100, True),
    (1, 2, 4, 8, 120, None, False),
]
DECODE_DTYPES = [(torch.float32, torch.float32),
                 (torch.float32, torch.bfloat16),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("qt,kt", DECODE_DTYPES)
@pytest.mark.parametrize("b,hkv,group,s,dh,window,ragged", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(dev, qt, kt, b, hkv, group, s,
                                               dh, window, ragged):
    """B8 against its plain version on the card, from run to run too: a
    float32 output within atol 1e-5, a bf16 one within one bf16 ulp of its
    own plain value plus 1e-5 (products of bf16 inputs are exact in
    float32; only the sums' order and the last rounding differ)."""
    g = torch.Generator(device=dev).manual_seed(s * dh + group)
    q = torch.randn((b, hkv * group, dh), generator=g, device=dev).to(qt)
    k, v = (torch.randn((b, s, hkv, dh), generator=g, device=dev).to(kt)
            for _ in "kv")
    lengths = (torch.randint(1, s + 1, (b,), generator=g, device=dev,
                             dtype=torch.int32) if ragged else s)
    before = decode_attention.KERNEL.launches
    out = decode_attention.decode_attention(q, k, v, lengths, window=window)
    again = decode_attention.decode_attention(q, k, v, lengths, window=window)
    assert decode_attention.KERNEL.launches == before + 2
    full = (lengths if ragged else
            torch.full((b,), s, dtype=torch.int32, device=dev))
    plain = ref.decode_attention_ref(q, k, v, full, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.dtype == qt and out.shape == q.shape
    limit = 1e-5 if qt == torch.float32 else bf16_ulps(plain) + 1e-5
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


# Ring edges: (batch, hkv, group, s, dh, window, length).  A row of 1,000
# keys in 8 splits of 125: each split's last tile of 32 keys ends mid-tile;
# a window of 77 starts at key 423 and ends after 2 tiles and 13 keys; dh
# 256 takes 16-key tiles; dh 36 stages by ordinary loads.
DECODE_EDGE_CASES = [(1, 2, 4, 1000, 120, None, 1000),
                     (2, 2, 4, 700, 120, 77, 500),
                     (1, 1, 2, 333, 256, 100, 301),
                     (3, 1, 2, 300, 36, 45, 299)]


@pytest.mark.parametrize("qt,kt", DECODE_DTYPES)
@pytest.mark.parametrize("b,hkv,group,s,dh,window,length", DECODE_EDGE_CASES)
def test_decode_attention_ring_edges(dev, qt, kt, b, hkv, group, s, dh,
                                     window, length):
    """B8 where a split's keys end mid-tile and where the window starts
    off the tiles of the cache: held as the other cases, and the same run
    to run."""
    g = torch.Generator(device=dev).manual_seed(length + dh)
    q = torch.randn((b, hkv * group, dh), generator=g, device=dev).to(qt)
    k, v = (torch.randn((b, s, hkv, dh), generator=g, device=dev).to(kt)
            for _ in "kv")
    out = decode_attention.decode_attention(q, k, v, length, window=window)
    again = decode_attention.decode_attention(q, k, v, length, window=window)
    plain = ref.decode_attention_ref(
        q, k, v, torch.full((b,), length, dtype=torch.int32, device=dev),
        window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    limit = 1e-5 if qt == torch.float32 else bf16_ulps(plain) + 1e-5
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


def test_decode_attention_wrapper_checks_inputs(dev):
    q = torch.randn((2, 4, 32), device=dev)
    k = torch.randn((2, 16, 2, 32), device=dev)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        decode_attention.decode_attention(q, k.cpu(), k, 3)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention.decode_attention(
            q, k.transpose(1, 2).contiguous().transpose(1, 2), k, 3)
    with pytest.raises(ValueError, match=r"lengths must lie in \[1, 16\]"):
        decode_attention.decode_attention(
            q, k, k, torch.tensor([3, 17], dtype=torch.int32, device=dev))
    before = decode_attention.KERNEL.launches
    a = decode_attention.decode_attention(q, k, k, 9, window=3)
    b = decode_attention.decode_attention(
        q, k, k, torch.tensor([9, 9], dtype=torch.int32, device=dev),
        window=3)
    assert decode_attention.KERNEL.launches == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "musicgen-medium"])
def test_lm_decode_on_card_matches_cpu(dev, arch):
    """A smoke-config model in float32 decodes 40 tokens on the card (a
    16-slot ring for h2o-danube, float32 cache) against the same model on
    the CPU (plain B8): logits within atol 1e-4 + rtol 1e-4, one B8 launch
    a layer a step."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              n_kv_heads=2)
    model = lm.TransformerLM.random(cfg, torch.Generator().manual_seed(1),
                                    device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
         if cfg.embed_inputs else
         rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32))
    caches = [model.init_cache(2, 64, dtype=torch.float32)]
    want = [model.decode_step(caches[0], x[:, i])[0] for i in range(40)]
    model = model.to(dev)
    caches.append(model.init_cache(2, 64, dtype=torch.float32))
    before = decode_attention.KERNEL.launches
    for i in range(40):
        out, _ = model.decode_step(caches[1], x[:, i])
        torch.testing.assert_close(out.cpu(), want[i], atol=1e-4, rtol=1e-4)
    assert decode_attention.KERNEL.launches == before + 40 * cfg.n_layers


# B7 at the shapes the MoE, SSM-hybrid and VLM families add: (b, hq, hkv,
# sq, sk, dh, causal).  The VLM's cross-attention: non-causal, sq != sk,
# sk below and above sq, no multiple of the 64-key tile (1,600 = 25 x 64
# is one); zamba2's shared block: 32 heads over 32 kv heads (group 1) at
# dh 64, one wgmma atom; MoE/VLM self-attention: dh 128, GQA 4.
FAMILY_FLASH_CASES = [
    (2, 8, 2, 300, 1600, 128, False), (1, 32, 8, 777, 100, 128, False),
    (2, 4, 1, 64, 1601, 128, False), (1, 8, 2, 50, 75, 64, False),
    (1, 32, 32, 1000, 1000, 64, True), (2, 32, 32, 190, 190, 64, True),
    (1, 32, 8, 513, 513, 128, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,causal", FAMILY_FLASH_CASES)
def test_flash_attention_family_shapes(dev, dtype, b, hq, hkv, sq, sk, dh,
                                       causal):
    """B7 at the new families' shapes against its plain version, held as
    the other B7 cases, and the same run to run."""
    g = torch.Generator(device=dev).manual_seed(sq * sk + dh)
    q = torch.randn((b, hq, sq, dh), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, hkv, sk, dh), generator=g, device=dev).to(dtype)
            for _ in "kv")
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    again = flash_attention.flash_attention(q, k, v, causal=causal)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    limit = 1e-5 if dtype == torch.float32 else bf16_ulps(plain) + 1e-5
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


# B8 at the new families' shapes: (b, hkv, group, s, dh, length).
# zamba2's shared-attention cache: no ring, 32 kv heads of 64, full and
# part-filled; the VLM's image cache: every one of its 1,600 slots.
FAMILY_DECODE_CASES = [(1, 32, 1, 32768, 64, 32768),
                       (1, 32, 1, 32768, 64, 20001),
                       (4, 32, 1, 4096, 64, 4095),
                       (8, 8, 4, 1600, 128, 1600)]


@pytest.mark.parametrize("qt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,group,s,dh,length", FAMILY_DECODE_CASES)
def test_decode_attention_family_shapes(dev, qt, b, hkv, group, s, dh,
                                        length):
    """B8 over a bf16 cache at the new families' shapes, no window,
    against its plain version, held as the other B8 cases, and the same
    run to run."""
    g = torch.Generator(device=dev).manual_seed(s + length)
    q = torch.randn((b, hkv * group, dh), generator=g, device=dev).to(qt)
    k, v = (torch.randn((b, s, hkv, dh), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in "kv")
    out = decode_attention.decode_attention(q, k, v, length)
    again = decode_attention.decode_attention(q, k, v, length)
    plain = ref.decode_attention_ref(
        q, k, v, torch.full((b,), length, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    limit = 1e-5 if qt == torch.float32 else bf16_ulps(plain) + 1e-5
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.parametrize("mode", ["einsum", "gather"])
@pytest.mark.parametrize("b,s,cf", [(1, 2048, 2.0), (128, 1, 2.0),
                                    (2, 512, 0.5)])
def test_moe_layer_on_card_matches_cpu(dev, mode, b, s, cf):
    """One MoE layer at phi-3.5-moe's widths (16 experts of d_ff 6,400
    over d_model 4,096, top-2, router groups of 1,024) in float32: the same
    experts, slots and drops on the card as on the CPU for the same input,
    outputs within atol 1e-4 + rtol 1e-4 (prefill, decode's one group of
    128 tokens, and a capacity that drops)."""
    from repro_torch.models import moe
    d, f, e = 4096, 6400, 16
    g = torch.Generator().manual_seed(b + s)
    p = {k: torch.randn(decl.shape, generator=g) / decl.shape[-2] ** 0.5
         for k, decl in moe.moe_decls(d, f, e, "swiglu").items()}
    x = torch.randn((b, s, d), generator=g)
    kw = dict(n_experts=e, top_k=2, capacity_factor=cf, router_group=1024)
    plans = [moe.moe_plan(x.to(dv), p["router"].to(dv), **kw)
             for dv in ("cpu", dev)]
    for key in ("gidx", "slot", "in_cap"):
        assert torch.equal(plans[0][key], plans[1][key].cpu()), key
    want = moe.moe_apply(p, x, act="swiglu", dispatch_mode=mode, **kw)
    out = moe.moe_apply({k: t.to(dev) for k, t in p.items()}, x.to(dev),
                        act="swiglu", dispatch_mode=mode, **kw)
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)


def test_mamba2_block_on_card_matches_cpu(dev):
    """One Mamba2 block at mamba2-370m's widths (d_model 1,024, 32 heads of
    64, state 128, chunk 256) in float32 over 1,000 tokens (chunks halved
    to 8), then 16 decode steps from the block's own zeroed cache: card
    within atol 1e-4 + rtol 1e-4 of the CPU."""
    from repro_torch.models import ssm
    d, di, n, h, hd, k = 1024, 2048, 128, 32, 64, 4
    g = torch.Generator().manual_seed(7)
    p = {}
    for name, decl in ssm.ssm_decls(d, di, n, h, k).items():
        scale = 0.3 if decl.init == "small_normal" else \
            1 / decl.shape[0] ** 0.5
        p[name] = torch.randn(decl.shape, generator=g) * scale
    p["A_log"] = p["A_log"].abs()
    x = torch.randn((2, 1000, d), generator=g)
    kw = dict(n_state=n, n_heads=h, head_dim=hd)
    want = ssm.ssm_apply(p, x, d_conv=k, chunk=256, **kw)
    pd = {key: t.to(dev) for key, t in p.items()}
    out = ssm.ssm_apply(pd, x.to(dev), d_conv=k, chunk=256, **kw)
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)
    caches = [ssm.ssm_cache(2, h, hd, n, k, di, torch.float32, device=dv)
              for dv in ("cpu", dev)]
    for t in range(16):
        a, _ = ssm.ssm_decode(p, x[:, t], caches[0], **kw)
        c, _ = ssm.ssm_decode(pd, x[:, t].to(dev), caches[1], **kw)
        torch.testing.assert_close(c.cpu(), a, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches[1]["state"].cpu(), caches[0]["state"],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "grok-1-314b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "llama-3.2-vision-11b"])
def test_lm_families_on_card_match_cpu(dev, arch):
    """A smoke-config model of each new family in float32 (a VLM's gates
    and image cache nonzero) on the card against the same model on the
    CPU: forward logits and 12 decode steps within atol 1e-4 + rtol 1e-4;
    B7 once a self-attention layer and site a forward, B8 once a layer and
    site a step (none for mamba2)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    g = torch.Generator().manual_seed(1)
    params = lm.init(cfg, g, device="cpu")
    for cp in params.get("cross", []):
        cp["gate"].normal_(generator=g)
    rng = np.random.default_rng(0)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 80)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    attn_layers = 0 if cfg.family in ("ssm", "hybrid") else cfg.n_layers
    n_attn = attn_layers + lm.n_sites(cfg)
    want = lm.forward(params, cfg, batch)
    on_card = {k: t.to(dev) for k, t in lm._flatten(params).items()}
    params_dev = lm._unflatten(on_card)
    before = flash_attention.KERNEL.launches
    out = lm.forward(params_dev, cfg, batch)
    assert flash_attention.KERNEL.launches == before + n_attn
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)
    caches = [lm.init_cache(cfg, 2, 32, dtype=torch.float32, device=dv)
              for dv in ("cpu", dev)]
    if "image_kv" in caches[0]:
        for name in ("k", "v"):
            caches[0]["image_kv"][name].normal_(generator=g)
            caches[1]["image_kv"][name].copy_(caches[0]["image_kv"][name])
    before = decode_attention.KERNEL.launches
    for i in range(12):
        a, _ = lm.decode_step(params, cfg, caches[0], batch["inputs"][:, i])
        c, _ = lm.decode_step(params_dev, cfg, caches[1],
                              batch["inputs"][:, i])
        torch.testing.assert_close(c.cpu(), a, atol=1e-4, rtol=1e-4)
    assert decode_attention.KERNEL.launches == before + 12 * n_attn


# B1-bf16 at several node layouts (the cases of the B1 test above).
@pytest.mark.parametrize("n,m,B,C,levels", [(3000, 5, 256, 6, 3),
                                            (2500, 3, 37, 11, 4),
                                            (700, 2, 16, 2, 5),
                                            (3 * R + 17, 4, 256, 6, 3)])
def test_hist_nodes_bf16_kernel(dev, n, m, B, C, levels):
    """B1-bf16 is fp32 B1 on the bf16-rounded statistics, bit for bit, the
    same run to run, and bitwise its plain version on the CPU (the same
    sums in the same order; the plain version's ``index_add_``), the count
    channel too."""
    g = torch.Generator(device=dev).manual_seed(n + 1)
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.randn((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    state = H.init_level_state(n, device=dev)
    for lvl in range(levels):
        if lvl:
            state = H.advance_level_state(
                state, torch.rand(n, generator=g, device=dev) < 0.3)
        built = (H.smaller_children(state.counts)[1] if lvl
                 else torch.ones(1, dtype=torch.bool, device=dev))
        bc = torch.where(built, state.counts, 0).to(torch.int32)
        stats_p = stats[state.order.long()].to(torch.bfloat16).contiguous()
        args = (codes_t, state.order, stats_p, state.counts, bc)
        out = hist_kernel.hist_nodes(*args, n_bins=B, hist_dtype="bfloat16")
        again = hist_kernel.hist_nodes(*args, n_bins=B, hist_dtype="bfloat16")
        fp32 = hist_kernel.hist_nodes(codes_t, state.order, stats_p.float(),
                                      state.counts, bc, n_bins=B)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert torch.equal(out, fp32)
        plain = ref.hist_nodes_ref(*[a.cpu() for a in args], n_bins=B,
                                   hist_dtype="bfloat16")
        assert torch.equal(out.cpu(), plain), float(
            (out.cpu() - plain).abs().max())
        assert torch.equal(out[..., -1].cpu(), plain[..., -1])


def test_hist_nodes_bf16_wrapper_counts_launches_and_checks_types(dev):
    n, m, C = 600, 3, 10
    codes_t = torch.randint(0, 16, (m, n), device=dev,
                            dtype=torch.int32).to(torch.uint8)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    counts = torch.full((1,), n, dtype=torch.int32, device=dev)
    stats = torch.randn((n, C), device=dev)
    b1, b1_bf16 = hist_kernel.KERNEL.launches, hist_kernel.KERNEL_BF16.launches
    hist_kernel.hist_nodes(codes_t, order, stats.to(torch.bfloat16), counts,
                           counts, n_bins=16, hist_dtype="bfloat16")
    assert hist_kernel.KERNEL_BF16.launches == b1_bf16 + 1    # all channels
    assert hist_kernel.KERNEL.launches == b1
    with pytest.raises(ValueError, match="bfloat16"):
        hist_kernel.hist_nodes(codes_t, order, stats, counts, counts,
                               n_bins=16, hist_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        hist_kernel.hist_nodes(codes_t, order, stats.to(torch.bfloat16),
                               counts, counts, n_bins=16)
    with pytest.raises(ValueError, match="unknown hist_dtype"):
        hist_kernel.hist_nodes(codes_t, order, stats, counts, counts,
                               n_bins=16, hist_dtype="float16")


def test_hist_nodes_refuses_an_order_longer_than_its_rows(dev):
    """An ``order`` longer than the rows of ``codes_t`` is a partition of
    several trees (each entry naming a row < n): B1 takes it, and the
    entries past the node segments change nothing.  One whose ``stats_p``
    differs in length raises before B1 would read past its ends."""
    n, m, C = 600, 3, 4
    codes_t = torch.randint(0, 16, (m, n), device=dev,
                            dtype=torch.int32).to(torch.uint8)
    counts = torch.full((1,), n, dtype=torch.int32, device=dev)
    order = torch.arange(n + 1, dtype=torch.int32, device=dev) % n
    stats = torch.randn((n + 1, C), device=dev)
    assert torch.equal(
        hist_kernel.hist_nodes(codes_t, order, stats, counts, counts,
                               n_bins=16),
        hist_kernel.hist_nodes(codes_t, order[:n], stats[:n].contiguous(),
                               counts, counts, n_bins=16))
    with pytest.raises(ValueError, match="stats_p"):
        hist_kernel.hist_nodes(codes_t, order[:n], stats, counts, counts,
                               n_bins=16)


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
def test_node_histogram_on_card_matches_cpu(dev, hist_dtype):
    """One node's build (the leaf-wise grower's) on the card against the
    CPU: rtol 1e-6, count channel bitwise."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(5)
    n, m, B, C = 5000, 4, 256, 6
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.randn((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    rows = torch.nonzero(torch.rand(n, generator=g, device=dev) < 0.4)[:, 0]
    rows = rows.to(torch.int32)
    stats = ops.stats_for(stats, hist_dtype)
    out = ops.node_histogram(codes_t, rows, stats, n_bins=B,
                             hist_dtype=hist_dtype)
    cpu = ops.node_histogram(codes_t.cpu(), rows.cpu(), stats.cpu(),
                             n_bins=B, hist_dtype=hist_dtype)
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(out[..., -1].cpu(), cpu[..., -1])


@pytest.mark.parametrize("cfg", [dict(growth="leafwise", max_leaves=11),
                                 dict(growth="leafwise", max_leaves=11,
                                      hist_dtype="bfloat16"),
                                 dict(hist_dtype="bfloat16")])
def test_leafwise_and_bf16_fit_on_card_matches_cpu(dev, cfg):
    """Leaf-wise and bf16 fits on the card against the CPU, same data and
    injected Pi: predictions within atol 1e-4, same best round and node
    counts; bf16 fits launch B1-bf16 and not fp32 B1; staged prediction on
    the card ends bitwise at ``predict_raw``."""
    from repro_torch.core import forest as FO
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multiclass", 3000, 12, 8, seed=3, n_informative=12)
    rng = np.random.default_rng(0)
    draws = [rng.normal(size=(8, 3)).astype(np.float32) / np.sqrt(3.0)
             for _ in range(6)]
    config = GBDTConfig(n_trees=6, depth=4, sketch_k=3, min_data_in_leaf=20,
                        early_stopping_rounds=2, **cfg)
    b1, b1_bf16 = hist_kernel.KERNEL.launches, hist_kernel.KERNEL_BF16.launches
    card = SketchBoost(config, device=dev).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]), sketch_mats=draws)
    bf16 = cfg.get("hist_dtype") == "bfloat16"
    assert (hist_kernel.KERNEL_BF16.launches > b1_bf16) == bf16
    assert (hist_kernel.KERNEL.launches > b1) == (not bf16)
    cpu = SketchBoost(config, device="cpu").fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]), sketch_mats=draws)
    pred = card.predict_raw(X[2400:])
    assert float((pred.cpu() - cpu.predict_raw(X[2400:])).abs().max()) <= 1e-4
    assert card.best_round == cpu.best_round
    assert torch.equal(card.packed.node_count.cpu(), cpu.packed.node_count)
    staged = FO.predict_staged(card.packed, card._bin(X[2400:]))
    assert torch.equal(staged[-1], pred)


@pytest.mark.parametrize("C", [1, 6, 13, 513])
def test_hist_kernels_take_all_channels_in_one_launch(dev, C):
    """One launch a call at any channel count, over two tiles: B1 (three
    nodes, the middle one empty) within rtol 1e-6 of its plain version on
    the CPU with the count channel bitwise, B4 bitwise its plain version;
    both the same from run to run, and the empty node all zeros."""
    g = torch.Generator(device=dev).manual_seed(C)
    n, m, B = R + 300, 3, 32
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.randn((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    node = torch.randint(0, 2, (n,), generator=g, device=dev,
                         dtype=torch.int32) * 2
    order = torch.sort(node, stable=True).indices.to(torch.int32)
    counts = torch.bincount(node, minlength=3).to(torch.int32)
    args = (codes_t, order, stats[order.long()].contiguous(), counts, counts)
    b1, b4 = hist_kernel.KERNEL.launches, hist_kernel.DIRECT_KERNEL.launches
    out = hist_kernel.hist_nodes(*args, n_bins=B)
    assert hist_kernel.KERNEL.launches == b1 + 1
    assert torch.equal(out, hist_kernel.hist_nodes(*args, n_bins=B))
    plain = ref.hist_nodes_ref(*[a.cpu() for a in args], n_bins=B)
    np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(out[..., -1].cpu(), plain[..., -1])
    assert not out[1].any()
    direct = hist_kernel.hist_direct(codes_t, node, stats, n_nodes=3,
                                     n_bins=B)
    assert hist_kernel.DIRECT_KERNEL.launches == b4 + 1
    assert torch.equal(direct, hist_kernel.hist_direct(
        codes_t, node, stats, n_nodes=3, n_bins=B))
    assert torch.equal(direct, ref.histogram_ref(codes_t, node, stats,
                                                 n_nodes=3, n_bins=B))
    assert not direct[1].any()


def test_one_node_build_of_a_million_rows(dev):
    """The leaf-wise grower's one-node build over about 943k of 2^20 rows
    (58 tiles, the size of level 1 of the main path): one B1 launch, the
    same from run to run, within rtol 1e-6 of the CPU with the count channel
    bitwise; a build count of zero leaves every cell zero."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(11)
    n, m, B, C = 1 << 20, 4, 256, 6
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.randn((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    rows = torch.nonzero(torch.rand(n, generator=g, device=dev) < 0.9)[:, 0]
    rows = rows.to(torch.int32)
    before = hist_kernel.KERNEL.launches
    out = ops.node_histogram(codes_t, rows, stats, n_bins=B)
    assert hist_kernel.KERNEL.launches == before + 1
    assert torch.equal(out, ops.node_histogram(codes_t, rows, stats,
                                               n_bins=B))
    cpu = ops.node_histogram(codes_t.cpu(), rows.cpu(), stats.cpu(),
                             n_bins=B)
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(out[..., -1].cpu(), cpu[..., -1])
    one = torch.full((1,), rows.numel(), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(one)
    none = hist_kernel.hist_nodes(codes_t, rows, stats[rows.long()], one,
                                  zero, n_bins=B)
    assert none.shape == (1, m, B, C) and not none.any()


# -- one-vs-all: a group of trees in one partition ------------------------------

@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,levels", [(3000, 3), (R + 700, 2)])
def test_hist_nodes_over_trees_is_per_tree(dev, hist_dtype, n, levels):
    """B1 and B1-bf16 over a partition of 3 trees (S = 3n > n, node ids
    tree-major, subtract build counts): one launch equals the per-tree
    launches concatenated and the plain version on the CPU, bit for
    bit."""
    g = torch.Generator(device=dev).manual_seed(n + levels)
    trees, m, B = 3, 5, 256
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    state = H.init_level_state(n, device=dev, trees=trees)
    for _ in range(levels):
        bits = torch.rand(trees * n, generator=g, device=dev) < 0.4
        state = H.advance_level_state(state, bits, permuted=True)
    _, is_built = H.smaller_children(state.counts)
    build = torch.where(is_built, state.counts, 0).to(torch.int32)
    stats_p = torch.stack([torch.randn(trees * n, generator=g, device=dev),
                           torch.ones(trees * n, device=dev)], 1)
    stats_p = stats_p.to(ref.stats_dtype(hist_dtype)).contiguous()
    kw = dict(n_bins=B, hist_dtype=hist_dtype)
    args = (codes_t, state.order, stats_p, state.counts, build)
    whole = hist_kernel.hist_nodes(*args, **kw)
    per = 2 ** levels
    parts = [hist_kernel.hist_nodes(
        codes_t, state.order[t * n:(t + 1) * n],
        stats_p[t * n:(t + 1) * n], state.counts[t * per:(t + 1) * per],
        build[t * per:(t + 1) * per], **kw) for t in range(trees)]
    assert torch.equal(whole, torch.cat(parts))
    plain = ref.hist_nodes_ref(*[a.cpu() for a in args], **kw)
    assert torch.equal(whole.cpu(), plain)


def test_segment_sums_on_card_match_cpu(dev):
    """The one-vs-all leaf pass's segment sums: the same on the card as on
    the CPU and run to run, each segment's sum its own rows' alone."""
    g = torch.Generator(device=dev).manual_seed(5)
    lengths = torch.tensor([0, 7, 70_000, 1, 256, 0, 513, 300_001],
                           device=dev)
    vals = torch.randn((int(lengths.sum()), 2), generator=g, device=dev)
    out = H.segment_sums(vals, lengths)
    assert torch.equal(out, H.segment_sums(vals, lengths))
    assert torch.equal(out.cpu(), H.segment_sums(vals.cpu(), lengths.cpu()))


@pytest.mark.parametrize("cfg", [
    dict(), dict(hist_engine="partition"), dict(hist_engine="direct"),
    dict(growth="leafwise", max_leaves=12),
    dict(hist_dtype="bfloat16"),
    dict(growth="leafwise", max_leaves=12, hist_dtype="bfloat16")])
def test_one_vs_all_fit_on_card_matches_cpu(dev, cfg, monkeypatch):
    """A one-vs-all fit on the card against the CPU, in groups of 3 of the
    8 trees: predictions within atol 1e-4, the same best round and node
    counts; a level-wise round launches B1 and B2 once a level for each
    group (the direct engine B4 once a level for each tree), a leaf-wise
    round at most ``max_leaves`` times a group; a second fit on the card
    is the same bit for bit.  Regression targets: a multiclass or
    multilabel tree's first gradients take two values, so splits tie in
    exact arithmetic, and B2 (gains within rtol 1e-5 of its plain
    version) may break such a tie otherwise than the CPU (ROADMAP §C)."""
    from repro_torch.core import tree as TT
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multitask_mse", 3000, 12, 8, seed=3,
                        n_informative=12)
    monkeypatch.setattr(TT, "OVA_GROUP_ENTRIES", 2400 * 3)
    config = GBDTConfig(loss="multitask_mse", strategy="one_vs_all",
                        n_trees=5, depth=4, min_data_in_leaf=20,
                        early_stopping_rounds=2, **cfg)
    b1 = (hist_kernel.KERNEL_BF16 if cfg.get("hist_dtype") == "bfloat16"
          else hist_kernel.KERNEL)
    kernels = (b1, split_kernel.KERNEL, hist_kernel.DIRECT_KERNEL)
    before = [k.launches for k in kernels]
    fits = [SketchBoost(config, device=d).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]))
        for d in (dev, "cpu")]
    launches = [k.launches - b for k, b in zip(kernels, before)]
    rounds = len(fits[0].history)
    if cfg.get("growth") == "leafwise":
        assert 0 < launches[0] <= 12 * 3 * rounds
    elif cfg.get("hist_engine") == "direct":
        assert launches[2] == 4 * 8 * rounds and launches[0] == 0
    else:
        assert launches[0] == 4 * 3 * rounds
        assert launches[1] == 4 * 3 * rounds
    pred = [f.predict_raw(X[2400:]).cpu() for f in fits]
    assert float((pred[0] - pred[1]).abs().max()) <= 1e-4
    assert fits[0].best_round == fits[1].best_round
    assert torch.equal(fits[0].packed.node_count.cpu(),
                       fits[1].packed.node_count)
    again = SketchBoost(config, device=dev).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]))
    assert torch.equal(again.predict_raw(X[2400:]).cpu(), pred[0])


@pytest.mark.parametrize("d", [8, 40])
def test_full_fit_on_card_matches_cpu(dev, d):
    """SketchBoost Full (``sketch_method="none"``: the split scan reads d +
    1 channels, B2's wide entry point at d = 40) on the card against the
    CPU: predictions within atol 1e-4 and the same best round, as the
    one-vs-all checks; a second card fit is the same bit for bit."""
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multitask_mse", 3000, 12, d, seed=3,
                        n_informative=12)
    config = GBDTConfig(loss="multitask_mse", sketch_method="none",
                        n_trees=5, depth=4, min_data_in_leaf=20,
                        early_stopping_rounds=2)
    before = split_kernel.WIDE_KERNEL.launches
    fits = [SketchBoost(config, device=dv).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]))
        for dv in (dev, "cpu")]
    wide = split_kernel.WIDE_KERNEL.launches - before
    assert wide == (4 * len(fits[0].history) if d + 1 > 32 else 0)
    pred = [f.predict_raw(X[2400:]).cpu() for f in fits]
    assert float((pred[0] - pred[1]).abs().max()) <= 1e-4
    assert fits[0].best_round == fits[1].best_round
    again = SketchBoost(config, device=dev).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]))
    assert torch.equal(again.predict_raw(X[2400:]).cpu(), pred[0])


SAMPLED_CASES = [
    dict(subsample=0.5), dict(goss_a=0.2, goss_b=0.1), dict(colsample=0.8),
    dict(goss_a=0.2, goss_b=0.1, colsample=0.8, growth="leafwise",
         max_leaves=12),
    dict(goss_a=0.2, goss_b=0.1, hist_engine="direct"),
    dict(goss_a=0.2, goss_b=0.1, hist_dtype="bfloat16"),
    dict(goss_a=0.2, goss_b=0.1, strategy="one_vs_all"),
    dict(guard_policy="skip_round"), dict(guard_policy="clip")]


def _sampled_draws(n_rounds, n, m, d, k, seed=0):
    """Injected draws for a fit: Pi (d, k), row and feature uniforms."""
    rng = np.random.default_rng(seed)
    return dict(
        sketch_mats=[rng.normal(size=(d, k)).astype(np.float32)
                     / np.sqrt(k) for _ in range(n_rounds)],
        sample_draws=[rng.random(n).astype(np.float32)
                      for _ in range(n_rounds)],
        feature_draws=[rng.random(m).astype(np.float32)
                       for _ in range(n_rounds)])


@pytest.mark.parametrize("cfg", SAMPLED_CASES)
def test_sampled_and_guarded_fit_on_card_matches_cpu(dev, cfg):
    """Row and column sampling (and the guards, with NaN targets from round
    1) on the card against the CPU with the same injected draws:
    predictions within atol 1e-4, the same best round, node counts and
    weighted covers; regression targets, as the one-vs-all checks."""
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    from repro_torch.runtime.chaos import NaNAtRow
    X, y = make_tabular("multitask_mse", 3000, 12, 8, seed=3,
                        n_informative=12)
    config = GBDTConfig(loss="multitask_mse", n_trees=5, depth=4,
                        sketch_k=3, min_data_in_leaf=20,
                        early_stopping_rounds=2, **cfg)
    draws = _sampled_draws(5, 2400, 12, 8, 3)
    guard = "guard_policy" in cfg
    fits = [SketchBoost(config, device=dv).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]),
        check_input=not guard,
        chaos=NaNAtRow(1, rows=[0, 9]) if guard else None, **draws)
        for dv in (dev, "cpu")]
    pred = [f.predict_raw(X[2400:]).cpu() for f in fits]
    assert torch.isfinite(pred[0]).all()
    assert float((pred[0] - pred[1]).abs().max()) <= 1e-4
    assert fits[0].best_round == fits[1].best_round
    a, b = fits[0].packed, fits[1].packed
    assert torch.equal(a.node_count.cpu(), b.node_count)
    torch.testing.assert_close(a.cover.cpu(), b.cover, rtol=1e-6, atol=0)


@pytest.mark.parametrize("cfg", [
    dict(goss_a=0.2, goss_b=0.1, colsample=0.8),
    dict(subsample=0.7, growth="leafwise", max_leaves=12),
    dict(strategy="one_vs_all", goss_a=0.2, goss_b=0.1),
    dict(sketch_method="random_sampling", colsample=0.8)])
def test_kill_and_resume_on_card_is_bitwise(dev, cfg, tmp_path):
    """Killed at round 3 with a checkpoint at 2 and resumed on the card,
    with every draw from the fit's CUDA generator: the forest, the packed
    model, the history and the last step's training scores are the
    uninterrupted fit's, bit for bit."""
    import dataclasses
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    from repro_torch.io import checkpoint as CK
    from repro_torch.runtime.chaos import ChaosKill, KillAtRound
    X, y = make_tabular("multiclass", 3000, 12, 6, seed=3, n_informative=12)
    base = GBDTConfig(n_trees=5, depth=4, sketch_k=3, min_data_in_leaf=20,
                      **cfg)

    def fit(c, chaos=None):
        return SketchBoost(c, device=dev).fit(
            X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]), chaos=chaos)

    full = fit(dataclasses.replace(base, save_every=5,
                                   ckpt_dir=str(tmp_path / "full")))
    ck = dataclasses.replace(base, save_every=2,
                             ckpt_dir=str(tmp_path / "cut"))
    with pytest.raises(ChaosKill):
        fit(ck, KillAtRound(3))
    resumed = fit(dataclasses.replace(ck, resume_from=str(tmp_path / "cut"),
                                      save_every=5))
    for f in full.packed._fields:
        x, z = getattr(full.packed, f), getattr(resumed.packed, f)
        assert (torch.equal(x, z) if torch.is_tensor(x) else x == z), f
    strip = [[{k: v for k, v in r.items() if k != "train_time_s"}
              for r in m.history] for m in (full, resumed)]
    assert strip[0] == strip[1]
    a = CK.load_boost_checkpoint(str(tmp_path / "full"), device=dev)
    b = CK.load_boost_checkpoint(str(tmp_path / "cut"), device=dev)
    assert a.round == b.round == 5
    assert torch.equal(a.F, b.F) and torch.equal(a.Fv, b.Fv)


@pytest.mark.parametrize("cfg", [
    dict(goss_a=0.2, goss_b=0.1, colsample=0.8),
    dict(strategy="one_vs_all", subsample=0.7),
    dict(growth="leafwise", max_leaves=12, goss_a=0.2, goss_b=0.1)])
def test_sampled_fit_runs_under_deterministic_algorithms(dev, cfg):
    """Every PyTorch op of a sampled fit with an eval set has a
    deterministic implementation on the card: the fit runs under
    ``torch.use_deterministic_algorithms(True)``, which raises at any op
    without one (a scatter-add by atomics, say), and gives the same model
    as without it."""
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multiclass", 3000, 12, 6, seed=3, n_informative=12)
    config = GBDTConfig(n_trees=3, depth=4, sketch_k=3, min_data_in_leaf=20,
                        **cfg)

    def fit():
        return SketchBoost(config, device=dev).fit(
            X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]))

    free = fit()
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = fit()
    finally:
        torch.use_deterministic_algorithms(before)
    assert torch.equal(free.predict_raw(X[2400:]), det.predict_raw(X[2400:]))


# -- the level step split for the distributed grower -----------------------------

@pytest.mark.parametrize("n,m,B,C,levels", [(3000, 5, 256, 6, 4),
                                            (3 * R + 17, 3, 64, 9, 3),
                                            (2000, 4, 256, 513, 3)])
def test_build_then_scan_is_the_fused_level_call(dev, n, m, B, C, levels):
    """`ops.build_level` then `ops.combine_scan` (what a distributed grower
    all-reduces between) on the card against the plain level step on the
    CPU, with sibling subtraction at every level: B1's plain version, the
    built halves interleaved with ``prev - built``, then B2's plain
    version.  The histograms are bitwise; the split scan as B2's own
    checks hold it (the index equal, the gain within rtol 1e-5)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(n)
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.rand((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    state = H.init_level_state(n, device=dev)
    mask = torch.ones(m, dtype=torch.float32)
    prev = prev_ref = None
    for lvl in range(levels):
        if lvl:
            state = H.advance_level_state(
                state, torch.rand(n, generator=g, device=dev) < 0.3)
        stats_p = stats[state.order.long()].contiguous()
        side = H.smaller_children(state.counts)[0] if lvl else None
        built = ops.build_level(codes_t, stats_p, state.order, state.counts,
                                side, n_bins=B)
        gain, idx, prev = ops.combine_scan(built, side, prev, 1.0, 1.0)
        counts = state.counts.cpu()
        bc = counts
        if side is not None:
            bc = torch.where(H.smaller_children(counts)[1], counts, 0)
        plain = ref.hist_nodes_ref(codes_t.cpu(), state.order.cpu(),
                                   stats_p.cpu(), counts,
                                   bc.to(torch.int32), n_bins=B)
        if side is not None:
            s_c = side.cpu()
            pairs = plain.reshape((-1, 2) + plain.shape[1:])
            half = torch.where(s_c.reshape(-1, 1, 1, 1) == 0, pairs[:, 0],
                               pairs[:, 1])
            plain = H.interleave_children(s_c, half, prev_ref - half)
        prev_ref = plain
        pg, pi = ref.split_scan_ref(plain, 1.0, 1.0, mask)
        assert torch.equal(prev.cpu(), plain)
        assert torch.equal(idx.cpu(), pi)
        torch.testing.assert_close(gain.cpu(), pg, rtol=1e-5, atol=0)


def test_build_level_of_a_shard_whose_built_child_is_all_its_rows(dev):
    """Under sharding the built child is the globally smaller one, which on
    a rank may hold every row of its parent: B1 (its tile budget ``S / R +
    n_nodes``) builds it, bitwise its plain version, and the other child is
    never read."""
    from repro_torch.kernels import ops
    n, m, B, C = 3 * R + 17, 3, 256, 6
    g = torch.Generator(device=dev).manual_seed(7)
    codes_t = torch.randint(0, B, (m, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    stats = torch.rand((n, C), generator=g, device=dev)
    stats[:, -1] = 1.0
    state = H.init_level_state(n, device=dev)
    # Level 1: every row goes left and the left child is built; level 2:
    # the left parent's rows split, its larger child built.
    state = H.advance_level_state(state, torch.zeros(n, dtype=torch.bool,
                                                     device=dev))
    sides = [torch.zeros(1, dtype=torch.int32, device=dev)]
    bits = torch.rand(n, generator=g, device=dev) < 0.8
    for lvl, side in ((1, sides[0]), (2, None)):
        if lvl == 2:
            state = H.advance_level_state(state, bits)
            c = state.counts.cpu()
            side = torch.tensor([int(c[1] > c[0]), 0], dtype=torch.int32,
                                device=dev)
        stats_p = stats[state.order.long()].contiguous()
        built = ops.build_level(codes_t, stats_p, state.order, state.counts,
                                side, n_bins=B)
        child = torch.arange(state.counts.shape[0], device=dev)
        is_built = (child % 2) == side.long()[child // 2]
        bc = torch.where(is_built, state.counts, 0).to(torch.int32)
        plain = ref.hist_nodes_ref(codes_t.cpu(), state.order.cpu(),
                                   stats_p.cpu(), state.counts.cpu(),
                                   bc.cpu(), n_bins=B)
        want = plain[is_built.cpu()]
        assert torch.equal(built.cpu(), want)
        assert float(built[0, 0, :, -1].sum()) == float(
            bc[is_built].max())


# B7's backward at phase 3's shapes of `chip_smoke.py` (b, hq, hkv, sq, sk,
# dh, causal, window, dtype), and ragged ones: sq and sk not multiples of
# the 64-row tile, sq != sk, dh above 128 (32-row tiles).  The bf16 cases
# after them are the tensor-core body's edges (dh <= 128): sq and sk of 77,
# 1,000 and 1,600, dh 36 (rows not 16-byte aligned), 64, 120 and 128, GQA
# groups 1 and 4, a causal window under one 64-row tile, no mask, the
# cross-attention's sq != sk and sq > sk; and bf16 above dh 128 (the CUDA
# cores' body, chosen by shape).
FLASH_BWD_CASES = {
    "danube_layer": (2, 32, 8, 4096, 4096, 120, True, 4096, "bfloat16"),
    "zamba2_mha_dh64": (1, 32, 32, 4096, 4096, 64, True, None, "bfloat16"),
    "vlm_cross_1600": (1, 32, 8, 4096, 1600, 128, False, None, "bfloat16"),
    "f32_sq_over_window": (1, 8, 2, 1000, 1000, 128, True, 256, "float32"),
    "ragged_causal": (2, 4, 1, 70, 70, 120, True, 30, "float32"),
    "ragged_cross": (1, 6, 3, 65, 100, 24, False, None, "bfloat16"),
    "sq_over_sk": (1, 4, 2, 77, 50, 64, True, 40, "float32"),
    "dh200": (1, 2, 1, 97, 97, 200, True, None, "float32"),
    "dh256_bf16": (1, 4, 2, 130, 130, 256, True, 64, "bfloat16"),
    "tc_mha_no_mask_77": (2, 4, 4, 77, 77, 64, False, None, "bfloat16"),
    "tc_gqa4_window_under_tile": (1, 8, 2, 1000, 1000, 120, True, 40,
                                  "bfloat16"),
    "tc_gqa4_causal_1600": (1, 8, 2, 1600, 1600, 128, True, None,
                            "bfloat16"),
    "tc_cross_1000_over_1600": (1, 4, 1, 1000, 1600, 128, False, None,
                                "bfloat16"),
    "tc_causal_sq_over_sk": (1, 4, 2, 77, 50, 64, True, 40, "bfloat16"),
    "tc_dh36_unaligned": (1, 4, 2, 130, 130, 36, True, None, "bfloat16"),
    "tc_dh120_gqa1": (1, 2, 2, 1000, 1000, 120, True, None, "bfloat16"),
    "bf16_dh200_gqa4": (1, 4, 1, 77, 77, 200, True, 30, "bfloat16"),
}


def flash_bwd_limit(plain: torch.Tensor, dtype: torch.dtype):
    """float32: 1e-5 of the largest magnitude (the sums run in another
    order); bfloat16: one bf16 ulp of each element's own plain value plus
    that (the float32 sums differ before the one rounding)."""
    atol = 1e-5 * float(plain.float().abs().max())
    return atol if dtype == torch.float32 else bf16_ulps(plain) + atol


@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_flash_attention_bwd_kernel_matches_plain(dev, case):
    """The backward kernel against `ref.flash_attention_bwd_ref` on the
    card, from the forward kernel's own output and lse; the same bits from
    run to run (no atomics); one launch a call."""
    b, hq, hkv, sq, sk, dh, causal, window, dt = FLASH_BWD_CASES[case]
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(sq + dh)
    q, do = (torch.randn((b, hq, sq, dh), generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, flash_attention.flash_attention(q, k, v, **kw))
    _, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, plain_lse, atol=1e-5, rtol=1e-6)
    before = flash_attention.BWD_KERNEL.launches
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert flash_attention.BWD_KERNEL.launches == before + 2
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, c, p in zip("qkv", got, again, plain):
        assert a.dtype == dtype and a.shape == p.shape
        assert torch.equal(a, c), f"d{name} differs run to run"
        diff = (a.float() - p.float()).abs()
        limit = flash_bwd_limit(p, dtype)
        assert bool((diff <= limit).all()), (name, float(diff.max()))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
def test_flash_attention_autograd_matches_plain_autograd(dev, dtype, tol):
    """`FlashAttention` under autograd on the card (one forward and one
    backward launch) against autograd of the plain forward on the card
    (GQA 4, causal, a window of 40, 200 rows, dh 120), each gradient within
    ``tol`` of its largest magnitude.  The two take D = rowsum(dO O) from
    different O: the kernel from the bf16 output the forward returned,
    autograd from the float32 softmax before its rounding; hence 1e-2 in
    bf16 (a few bf16 roundings) and 1e-4 in float32."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((1, h, 200, 120), generator=g, device=dev)
               .to(dtype) for h in (8, 2, 2))
    do = torch.randn((1, 8, 200, 120), generator=g, device=dev).to(dtype)
    kw = dict(causal=True, window=40)

    def grads(fn):
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*xs, **kw), xs, do)
    fwd, bwd = (flash_attention.KERNEL.launches,
                flash_attention.BWD_KERNEL.launches)
    got = grads(flash_attention.flash_attention)
    assert (flash_attention.KERNEL.launches - fwd,
            flash_attention.BWD_KERNEL.launches - bwd) == (1, 1)
    want = grads(ref.flash_attention_ref)
    torch.cuda.synchronize()
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)


def test_flash_attention_bwd_wrapper_checks_inputs(dev):
    q = torch.randn((1, 4, 16, 32), device=dev)
    k = torch.randn((1, 2, 16, 32), device=dev)
    o, lse = flash_attention.flash_attention_lse(q, k, k)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention.flash_attention_bwd(q, k, k, o, lse, q.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_bwd(
            q, k, k, o, lse, q.transpose(2, 3).contiguous().transpose(2, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradients_reach_the_projections_on_the_card(dev, dtype):
    """`layers.attention_apply` under autograd on the card: B7 runs as
    `FlashAttention` (one forward and one backward launch), and wq, wk and
    wv get the CPU's gradients (float32 within 1e-4 of each leaf's largest
    magnitude; bf16 within 2e-2 of it)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    p = {n: torch.tensor(rng.normal(size=s).astype(np.float32) / 8)
         for n, s in (("wq", (64, 128)), ("wk", (64, 64)), ("wv", (64, 64)),
                      ("wo", (128, 64)))}
    x = torch.tensor(rng.normal(size=(2, 90, 64)).astype(np.float32))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=32, rope_theta=1e4,
              window=40)

    def grads(device):
        pd = {n: t.to(device, dtype).detach().requires_grad_()
              for n, t in p.items()}
        y = L.attention_apply(pd, x.to(device, dtype), **kw)
        (y.float().square().sum()).backward()
        return {n: t.grad.float().cpu() for n, t in pd.items()}

    want = grads("cpu")
    fwd, bwd = (flash_attention.KERNEL.launches,
                flash_attention.BWD_KERNEL.launches)
    got = grads(dev)
    assert flash_attention.KERNEL.launches == fwd + 1
    assert flash_attention.BWD_KERNEL.launches == bwd + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for n in ("wq", "wk", "wv", "wo"):
        assert float(got[n].abs().max()) > 0, n
        err = float((got[n] - want[n]).abs().max())
        assert err <= tol * float(want[n].abs().max()), (n, err)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-1.2b",
                                  "llama-3.2-vision-11b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """A float32 smoke model on the card against the CPU: `lm.lm_loss`
    within 1e-5 relative and each gradient leaf within 1e-4 of its largest
    magnitude; then one AdamW train step, its loss and grad norm within
    1e-5 relative, with remat running B7's forward twice a plain layer's
    attention (once a site's) and its backward once each.  (The
    parameters after an AdamW step are held in phase 14 (b) of
    ``chip_smoke.py``: the first step moves a weight by about lr *
    sign(g), unresolved where g is near 0.)"""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_lib
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    tc = train_lib.TrainConfig(opt=opt.OptConfig(warmup_steps=1))
    rng = np.random.default_rng(0)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 80)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 80))}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    p0 = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")

    def run(device):
        params = opt.tree_map(lambda t: t.to(device, copy=True), p0)
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        leaves = opt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm.lm_loss(params, cfg, b)
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        fwd, bwd = (flash_attention.KERNEL.launches,
                    flash_attention.BWD_KERNEL.launches)
        state = opt.opt_init(params, tc.opt)
        _, _, m = train_lib.make_train_step(cfg, tc)(params, state, b, 3)
        launches = (flash_attention.KERNEL.launches - fwd,
                    flash_attention.BWD_KERNEL.launches - bwd)
        return (float(loss.detach()), grads,
                {k: float(v) for k, v in m.items()}, launches)

    want_l, want_g, want_m, _ = run("cpu")
    got_l, got_g, got_m, (fwd, bwd) = run(dev)
    n_attn = (lm.n_sites(cfg) if cfg.family in ("hybrid",)
              else 0 if cfg.family == "ssm" else cfg.n_layers)
    n_cross = lm.n_sites(cfg) if cfg.family == "vlm" else 0
    # remat recomputes the plain layers' attention, not the sites'
    recomputed = n_attn if cfg.family != "hybrid" else 0
    assert (fwd, bwd) == (n_attn + n_cross + recomputed, n_attn + n_cross)
    assert abs(got_l - want_l) <= 1e-5 * abs(want_l)
    for a, c in zip(want_g, got_g):
        err = float((c - a).abs().max())
        assert err <= 1e-4 * float(a.abs().max()), err
    for k in ("loss", "grad_norm"):
        assert abs(got_m[k] - want_m[k]) <= 1e-5 * abs(want_m[k]), k
