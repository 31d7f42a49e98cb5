"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA card with the CUDA toolkit and
skip elsewhere.  Run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import histogram as H
from repro_torch.core.tree import heap_to_node_arrays
from repro_torch.kernels import hist_kernel, predict_kernel, ref, split_kernel

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
