"""Non-finite guards: keep one NaN row from ruining a 500-round fit.

Port of the JAX package's ``core/guards.py``.  `boosting.boost_round`
routes its gradients, hessians and sketched statistics through here under
``GBDTConfig.guard_policy``:

  * ``"off"``         — no checks.
  * ``"raise"``       — nothing is sanitized, so non-finite gradients reach
                        the training scores F; the fit reads F back once a
                        round and raises `NonFiniteError` naming the round.
  * ``"skip_round"``  — the round's tree is grown from sanitized statistics
                        and its leaf values and gains are multiplied by 0
                        when ANY input was non-finite: F is unchanged and
                        training goes on.
  * ``"clip"``        — NaN -> 0, +/-inf -> +/-``guard_clip``, and every
                        value clamped to ``[-guard_clip, guard_clip]``;
                        training goes on with the repaired tensors.

Under every policy ``hessian_floor > 0`` floors the per-row hessians
before the leaf pass (leaf values are ``-g / (h + lambda)``).  The sketched
statistics are checked again after `sketch.build_sketch`, since a
projection can overflow on its own.

The flag of a round is a 0-d bool tensor on the fit's device: nothing here
reads the card back, except `check_scores_host`, which the ``"raise"``
policy calls once a round.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

GUARD_POLICIES = ("off", "raise", "skip_round", "clip")


class NonFiniteError(FloatingPointError):
    """Raised by the ``"raise"`` policy when non-finite gradients or
    hessians reached the training scores, naming the round."""

    def __init__(self, round_idx: int, where: str = "training scores"):
        self.round = int(round_idx)
        super().__init__(
            f"non-finite values detected in {where} at boosting round "
            f"{self.round} under guard_policy='raise'; inspect the "
            "targets/loss for NaN/inf at this round, or rerun with "
            "guard_policy='skip_round' (drop the bad round) or 'clip' "
            "(repair the gradients) to train through it")


def nonfinite_any(x: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: does ``x`` hold NaN or +/-inf?"""
    return ~torch.isfinite(x).all()


def sanitize(x: torch.Tensor, clip: float) -> torch.Tensor:
    """NaN -> 0, +/-inf -> +/-clip, finite values clamped to [-clip,
    clip]."""
    return torch.nan_to_num(x, nan=0.0, posinf=clip,
                            neginf=-clip).clamp_(-clip, clip)


def guard_grad_hess(G: torch.Tensor, H: torch.Tensor, policy: str,
                    clip: float, hessian_floor: float
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """The gradient/hessian guard: ``(G, H, bad)``, ``bad`` a 0-d bool
    tensor, or None where the policy detects nothing.  Under
    ``skip_round``/``clip`` G and H come back sanitized and H clamped to
    >= 0 (a diagonal hessian is never negative: a negative one is
    corruption); under ``off``/``raise`` they pass through.  The hessian
    floor applies under every policy."""
    bad = None
    if policy in ("skip_round", "clip"):
        bad = nonfinite_any(G) | nonfinite_any(H)
        G = sanitize(G, clip)
        H = sanitize(H, clip).clamp_(min=0.0)
    if hessian_floor > 0.0:
        H = torch.clamp(H, min=hessian_floor)
    return G, H, bad


def guard_stats(stats: torch.Tensor, policy: str, clip: float,
                bad: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Guard the sketched split statistics (the histogram inputs)."""
    if policy in ("skip_round", "clip"):
        flag = nonfinite_any(stats)
        bad = flag if bad is None else (bad | flag)
        stats = sanitize(stats, clip)
    return stats, bad


def skip_scale(bad: Optional[torch.Tensor], policy: str,
               device=None) -> torch.Tensor:
    """The round's multiplier for leaf values and gains: 0 where the round
    is skipped, else 1 (a device tensor; no host read)."""
    one = torch.ones((), dtype=torch.float32,
                     device=device if bad is None else bad.device)
    if policy != "skip_round" or bad is None:
        return one
    return torch.where(bad, torch.zeros_like(one), one)


def check_scores_host(F: torch.Tensor, round_idx: int) -> None:
    """The ``raise`` policy's check, one host read: non-finite training
    scores mean a poisoned round at or before ``round_idx``."""
    if not bool(torch.isfinite(F).all()):
        raise NonFiniteError(round_idx)
