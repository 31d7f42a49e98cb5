"""Fault tolerance: a restartable training driver and a straggler watchdog.

Port of the JAX package's ``runtime/fault.py``.  `RestartableLoop` owns the
checkpoint/restore cycle: on start it resumes from the latest valid
checkpoint (atomic manifests make it valid), saves every ``save_every``
steps, and reports per-step straggler flags.  Persistence is pluggable
(``save_fn``/``restore_fn``).  ``shardings`` re-lays a restored state onto
this rank's mesh (`elastic.remesh`): checkpoints are mesh-agnostic host
arrays, so a loop resumes on a smaller mesh than the one that wrote it.

`StragglerWatchdog` tracks step times and flags steps beyond ``threshold``
x the trailing median; `chaos.DelayShard` drives it with virtual seconds.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.io.checkpoint import CheckpointManager
from repro_torch.runtime import chaos as CH
from repro_torch.runtime import elastic as E

Tree = Any


class StragglerWatchdog:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times: collections.deque = collections.deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0

    def observe(self, step_time: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if step_time > self.threshold * med:
                is_straggler = True
                self.flagged += 1
        self.times.append(step_time)
        return is_straggler


class RestartableLoop:
    """Generic checkpoint/restart training loop.

    ``state`` is any nest of dicts, lists and tuples of tensors and
    scalars; ``step_fn(state, batch) -> (state, metrics)`` must be
    deterministic given (state, batch) so that restart-and-replay
    reproduces the same trajectory.  By default the state round-trips
    through a `CheckpointManager` under ``ckpt_dir`` (restored into the
    structure of the initial state, onto ``device``); a caller can
    delegate with ``save_fn(step, state)`` / ``restore_fn() -> (state,
    start_step) | None``.  ``chaos`` takes `runtime.chaos` injections:
    kill-style hooks fire at step boundaries, `DelayShard` adds virtual
    time to the watchdog's observations.  ``shardings`` (an
    `elastic.Layout` or a nest of them matching the state) lays a restored
    state out on a mesh: the manager's restore takes it, and a
    ``restore_fn``'s state goes through `elastic.remesh`.
    """

    def __init__(self, ckpt_dir: str, step_fn: Callable, *,
                 save_every: int = 50, keep_n: int = 3,
                 async_save: bool = True,
                 save_fn: Optional[Callable[[int, Tree], None]] = None,
                 restore_fn: Optional[Callable[[], Any]] = None,
                 shardings: Any = None, chaos: Any = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 device=None):
        self.mgr = (CheckpointManager(ckpt_dir, keep_n=keep_n,
                                      async_save=async_save)
                    if ckpt_dir else None)
        self.step_fn = step_fn
        self.save_every = save_every
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.shardings = shardings
        self.chaos = CH.as_chaos_list(chaos)
        self.watchdog = watchdog or StragglerWatchdog()
        self.device = device

    def _save(self, step: int, state: Tree) -> None:
        if self.save_fn is not None:
            self.save_fn(step, state)
        elif self.mgr is not None:
            self.mgr.save(step, state)

    def resume_or_init(self, init_state: Tree):
        if self.restore_fn is not None:
            restored = self.restore_fn()
            if restored is None:
                return init_state, 0
            state, start = restored
            if self.shardings is not None:
                state = E.remesh(state, self.shardings, device=self.device)
            return state, start
        if self.mgr is None or self.mgr.latest_step() is None:
            return init_state, 0
        state, step = self.mgr.restore(init_state, shardings=self.shardings,
                                       device=self.device)
        return state, step + 1

    def run(self, init_state: Tree, batches: Optional[Iterator] = None,
            n_steps: int = 0,
            on_metrics: Optional[Callable[[int, Dict], None]] = None):
        """Run up to ``n_steps`` steps with checkpoint/restart.

        ``batches=None`` feeds ``step_fn`` the step INDEX as its batch:
        the round-driven mode (a resumed loop must not replay consumed
        batches, which an iterator cannot express).
        """
        state, start = self.resume_or_init(init_state)
        step = start
        while step < n_steps:
            CH.check_round_all(self.chaos, step)
            if batches is None:
                batch = step
            else:
                try:
                    batch = next(batches)
                except StopIteration:
                    break
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            dt = (time.perf_counter() - t0
                  + CH.total_extra_time(self.chaos, step))
            metrics = dict(metrics or {})
            metrics["step_time_s"] = dt
            metrics["straggler"] = self.watchdog.observe(dt)
            if on_metrics:
                on_metrics(step, metrics)
            if self.save_every and (step + 1) % self.save_every == 0:
                self._save(step, state)
            step += 1
        if step > start:
            self._save(step - 1, state)
        if self.mgr is not None:
            self.mgr.wait()
        return state, step
