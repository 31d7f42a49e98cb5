"""Multioutput losses: value, gradient and diagonal Hessian (paper eq. (2)).

Port of the JAX package's ``core/losses.py``.  ``grad_hess`` returns
per-sample, per-output derivatives with respect to the raw scores ``F``.
Multiclass labels may be class ids ``(n,)`` or one-hot rows ``(n, d)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch


class Loss(NamedTuple):
    name: str
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    grad_hess: Callable[[torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, torch.Tensor]]
    transform: Callable[[torch.Tensor], torch.Tensor]


def _softmax_ce_value(F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(F.to(torch.float32), dim=-1)
    if Y.ndim == 1:
        return -logp.gather(1, Y.long()[:, None]).mean()
    return -(Y * logp).sum(-1).mean()


def _softmax_ce_gh(F: torch.Tensor, Y: torch.Tensor):
    # G = P - onehot(Y) is formed in place on P: subtracting 0 elsewhere is
    # exact, so the bits equal the reference's ``P - Y`` with half the
    # memory at full width.
    P = torch.softmax(F.to(torch.float32), dim=-1)
    H = P * (1.0 - P)
    if Y.ndim == 1:
        G = P
        G[torch.arange(G.shape[0], device=G.device), Y.long()] -= 1.0
    else:
        G = P - Y
    return G, H


def _bce_value(F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    F = F.to(torch.float32)
    return (torch.clamp(F, min=0) - F * Y
            + torch.log1p(torch.exp(-F.abs()))).mean()


def _bce_gh(F: torch.Tensor, Y: torch.Tensor):
    P = torch.sigmoid(F.to(torch.float32))
    return P - Y, P * (1.0 - P)


def _mse_value(F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.square(F.to(torch.float32) - Y).mean()


def _mse_gh(F: torch.Tensor, Y: torch.Tensor):
    G = F.to(torch.float32) - Y
    return G, torch.ones_like(G)


MULTICLASS = Loss("multiclass", _softmax_ce_value, _softmax_ce_gh,
                  lambda F: torch.softmax(F, dim=-1))
MULTILABEL = Loss("multilabel", _bce_value, _bce_gh, torch.sigmoid)
MULTITASK_MSE = Loss("multitask_mse", _mse_value, _mse_gh, lambda F: F)

LOSSES = {l.name: l for l in (MULTICLASS, MULTILABEL, MULTITASK_MSE)}


def get_loss(name: str) -> Loss:
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
