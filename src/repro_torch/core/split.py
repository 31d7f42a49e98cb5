"""Split scoring and best-split search (paper eq. (4)).

Port of the JAX package's ``core/split.py``.  ``gain = 0.5 * (S(R_l) +
S(R_r) - S(R_p))`` with ``S(R) = ||sum_R g||^2 / (|R| + lambda)``; the last
bin, ``min_data`` violations and masked features are illegal (-inf).  The
arg-max keeps the first maximum over the flattened (feature, bin) axis.

Each ``||.||^2`` sums the channels' squares in float64 and rounds once to
float32 (`_sq_sum`): the float32 result then does not depend on the order
of the sum (but in the rare case that two orders' float64 sums straddle a
float32 rounding boundary), so the card's split scan (B2, which sums them
in its own order, in float64 too) gives the plain version's gains bit for
bit at any channel count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Splits(NamedTuple):
    feat: torch.Tensor     # (nodes,) int32 feature index
    thr: torch.Tensor      # (nodes,) int32 threshold bin (left if code <= thr)
    gain: torch.Tensor     # (nodes,) float32 information gain
    is_leaf: torch.Tensor  # (nodes,) bool, no positive-gain split found


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis in float64, rounded once to
    float32."""
    xd = x.to(torch.float64)
    return xd.square_().sum(-1).to(torch.float32)


def split_scores(hist: torch.Tensor, lam: float, min_data: float,
                 feature_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nodes, m, B, k+1) histograms -> (nodes, m, B) gains, -inf where
    illegal.  Channels [0:k] are gradient sums, [-1] counts."""
    csum = torch.cumsum(hist, dim=2)
    total = csum[:, :, -1:, :]
    gl, cl = csum[..., :-1], csum[..., -1]
    gr = total[..., :-1] - gl
    cr = total[..., -1] - cl
    s_left = _sq_sum(gl) / (cl + lam)
    s_right = _sq_sum(gr) / (cr + lam)
    s_parent = _sq_sum(total[..., :-1]) / (total[..., -1] + lam)
    gain = 0.5 * (s_left + s_right - s_parent)
    B = hist.shape[2]
    legal = (torch.arange(B, device=hist.device) < B - 1)[None, None, :]
    legal = legal & (cl >= min_data) & (cr >= min_data)
    if feature_mask is not None:
        legal = legal & (feature_mask[None, :, None] > 0)
    return torch.where(legal, gain, torch.tensor(float("-inf"),
                                                 device=hist.device))


def splits_from_flat(best_gain: torch.Tensor, best_idx: torch.Tensor, *,
                     n_bins: int, min_gain: float = 0.0) -> Splits:
    """`Splits` from per-node ``(best_gain, feature * n_bins + bin)``.

    Nodes with no positive-gain candidate become pass-through leaves:
    feat 0, thr ``n_bins - 1`` routes every row left.
    """
    feat = (best_idx // n_bins).to(torch.int32)
    thr = (best_idx % n_bins).to(torch.int32)
    is_leaf = ~(best_gain > min_gain)
    feat = torch.where(is_leaf, 0, feat).to(torch.int32)
    thr = torch.where(is_leaf, n_bins - 1, thr).to(torch.int32)
    gain = torch.where(is_leaf, 0.0, best_gain)
    return Splits(feat=feat, thr=thr, gain=gain, is_leaf=is_leaf)


def flat_argmax(gain: torch.Tensor):
    """(nodes, m, B) gains -> per-node ``(best_gain, feature * B + bin)``,
    keeping the first maximum over the flattened axis (as ``jnp.argmax``)."""
    flat = gain.reshape(gain.shape[0], -1)
    idx = flat.argmax(dim=1)
    return flat.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def best_splits(gain: torch.Tensor, min_gain: float = 0.0) -> Splits:
    """Arg-max split per node from the (nodes, m, B) gain tensor."""
    best, idx = flat_argmax(gain)
    return splits_from_flat(best, idx, n_bins=gain.shape[2],
                            min_gain=min_gain)
