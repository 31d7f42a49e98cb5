"""Deterministic fault injection for tests and drills.

Port of the JAX package's ``runtime/chaos.py``, on torch tensors.  Every
injection is host-side and round-addressed: it fires when a training loop
reaches a declared round boundary (or a server's `VirtualClock` is driven
past a declared time), never from wall-clock time or signals, so a chaos
test replays the same way under a fixed seed.

The loops (`core.boosting.SketchBoost.fit`, `runtime.fault.RestartableLoop`)
duck-type these hooks, so an injection needs no common base class:

  * ``check_round(r)``       — raise to simulate a crash (`KillAtRound`,
                               `DropHost`).
  * ``mutate_targets(Y, r)`` — corrupt the training targets from round
                               ``r`` on (`NaNAtRow`); the corruption
                               persists, like a bad row in a storage shard.
  * ``extra_time(r)``        — virtual seconds added to the observed step
                               time (`DelayShard`), feeding
                               `fault.StragglerWatchdog` without sleeping.
  * ``round``                — the trigger boundary.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


class ChaosKill(RuntimeError):
    """A simulated process kill at a round boundary."""

    def __init__(self, round_idx: int):
        self.round = int(round_idx)
        super().__init__(f"chaos: killed at round {self.round}")


class HostLost(RuntimeError):
    """A simulated host loss (the elastic-restart trigger)."""

    def __init__(self, round_idx: int, host: int = 0):
        self.round = int(round_idx)
        self.host = int(host)
        super().__init__(
            f"chaos: host {self.host} lost at round {self.round}")


class KillAtRound:
    """Raise `ChaosKill` when training reaches round ``round`` (rounds
    ``0 .. round - 1`` done).  Fires once: a resumed run driving the same
    object sails past the trigger."""

    def __init__(self, round: int):
        self.round = int(round)
        self.fired = False

    def check_round(self, round_idx: int) -> None:
        if not self.fired and round_idx >= self.round:
            self.fired = True
            raise ChaosKill(round_idx)


class DropHost:
    """Raise `HostLost` at round ``round``; the caller resumes from the
    last checkpoint.  Fires once, like `KillAtRound`."""

    def __init__(self, round: int, host: int = 0):
        self.round = int(round)
        self.host = int(host)
        self.fired = False

    def check_round(self, round_idx: int) -> None:
        if not self.fired and round_idx >= self.round:
            self.fired = True
            raise HostLost(round_idx, self.host)


class NaNAtRow:
    """Overwrite target rows (or some of their outputs) with NaN from round
    ``round`` on: a corrupt record reaching the training set mid-run, for
    the non-finite guards (``cfg.guard_policy``).  Applied once; the loop
    carries the corrupted targets forward."""

    def __init__(self, round: int, rows: Iterable[int],
                 outputs: Optional[Iterable[int]] = None):
        self.round = int(round)
        self.rows = tuple(int(r) for r in rows)
        self.outputs = None if outputs is None else tuple(
            int(c) for c in outputs)
        self.applied = False

    def mutate_targets(self, Y: torch.Tensor, round_idx: int) -> torch.Tensor:
        if self.applied or round_idx < self.round:
            return Y
        self.applied = True
        if not Y.dtype.is_floating_point:
            raise ValueError(
                "NaNAtRow corrupts float targets; integer class labels "
                f"(dtype {Y.dtype}) cannot hold NaN — use a dense-target "
                "loss (multilabel / multitask_mse) for NaN-injection tests")
        Y = Y.clone()
        rows = torch.tensor(self.rows, dtype=torch.long, device=Y.device)
        if self.outputs is None:
            Y[rows] = float("nan")
        else:
            cols = torch.tensor(self.outputs, dtype=torch.long,
                                device=Y.device)
            Y[rows[:, None], cols[None, :]] = float("nan")
        return Y


class DelayShard:
    """Report ``extra_s`` virtual seconds of step time at the trigger
    rounds (``round``, then every ``every`` rounds when ``every > 0``):
    drives `fault.StragglerWatchdog` deterministically, without
    sleeping."""

    def __init__(self, round: int, extra_s: float, every: int = 0):
        self.round = int(round)
        self.extra_s = float(extra_s)
        self.every = int(every)

    def extra_time(self, round_idx: int) -> float:
        if round_idx == self.round:
            return self.extra_s
        if (self.every > 0 and round_idx > self.round
                and (round_idx - self.round) % self.every == 0):
            return self.extra_s
        return 0.0


class VirtualClock:
    """Injectable monotonic clock for serving tests: deadlines and queue age
    advance only when the test says so."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def time(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# -- loop-facing helpers (used by runtime.fault) -------------------------------

def as_chaos_list(chaos) -> Tuple[object, ...]:
    if chaos is None:
        return ()
    if isinstance(chaos, (list, tuple)):
        return tuple(chaos)
    return (chaos,)


def check_round_all(chaos: Sequence[object], round_idx: int) -> None:
    for c in chaos:
        check = getattr(c, "check_round", None)
        if check is not None:
            check(round_idx)


def total_extra_time(chaos: Sequence[object], round_idx: int) -> float:
    total = 0.0
    for c in chaos:
        extra = getattr(c, "extra_time", None)
        if extra is not None:
            total += float(extra(round_idx))
    return total


def nan_at_rows(X: np.ndarray, rows: Iterable[int],
                cols: Optional[Iterable[int]] = None) -> np.ndarray:
    """Host-side feature corruption (NaN = missing): a poisoned copy."""
    X = np.array(X, np.float32, copy=True)
    r = np.asarray(tuple(rows), np.int64)
    if cols is None:
        X[r] = np.nan
    else:
        X[np.ix_(r, np.asarray(tuple(cols), np.int64))] = np.nan
    return X
