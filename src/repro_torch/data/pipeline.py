"""Synthetic data: tabular (paper App. B.7 protocol, Guyon 2003 scheme)
and an LM token stream, and a sharded prefetcher that moves host batches
to the device.

A copy of the numpy generators of the JAX package's ``data/pipeline.py``,
so that the two packages see identical inputs from one seed.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


def make_tabular(task: str, n: int, m: int, d: int, *, seed: int = 0,
                 n_informative: Optional[int] = None, noise: float = 0.5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Guyon-style synthetic dataset.

    Features: ``n_informative`` i.i.d. normals, 2x linear combinations of
    them, remainder pure noise.  Targets from a random linear map + noise:
      multiclass  -> argmax over d logits (labels (n,))
      multilabel  -> sign over d logits   (labels (n, d) in {0,1})
      multitask   -> the d logits         (targets (n, d))
    """
    rng = np.random.default_rng(seed)
    ni = n_informative or max(m // 10, 2)
    nc = min(2 * ni, max(m - ni, 0))
    base = rng.normal(size=(n, ni)).astype(np.float32)
    combo = base @ rng.normal(size=(ni, nc)).astype(np.float32)
    rest = rng.normal(size=(n, max(m - ni - nc, 0))).astype(np.float32)
    X = np.concatenate([base, combo, rest], axis=1)[:, :m]
    W = rng.normal(size=(ni, d)).astype(np.float32)
    logits = base @ W + noise * rng.normal(size=(n, d)).astype(np.float32)
    if task == "multiclass":
        y = logits.argmax(1).astype(np.int32)
    elif task == "multilabel":
        y = (logits > 0).astype(np.float32)
    elif task == "multitask_mse":
        y = logits.astype(np.float32)
    else:
        raise ValueError(task)
    return X, y


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    cut = int(len(X) * (1 - test_frac))
    tr, te = idx[:cut], idx[cut:]
    return X[tr], X[te], y[tr], y[te]


def lm_batches(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
               embed_dim: int = 0, image_tokens: int = 0,
               d_model: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite Zipf-token batches (plus stub embeddings for audio/vlm)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    p = 1.0 / ranks
    p /= p.sum()
    while True:
        toks = rng.choice(vocab_size, size=(batch, seq + 1), p=p)
        out: Dict[str, np.ndarray] = {
            "labels": toks[:, 1:].astype(np.int32),
        }
        if embed_dim:
            out["inputs"] = rng.normal(
                size=(batch, seq, embed_dim)).astype(np.float32)
        else:
            out["inputs"] = toks[:, :-1].astype(np.int32)
        if image_tokens:
            out["image_embeds"] = rng.normal(
                size=(batch, image_tokens, d_model)).astype(np.float32)
        yield out


# ---------------------------------------------------------------------------
# Sharded prefetching iterator
# ---------------------------------------------------------------------------

_END = object()       # the host iterator is exhausted


class ShardedPrefetcher:
    """Wraps a host-batch iterator: selects this rank's shard of each
    global batch (rows ``[n // count * index, n // count * (index + 1))``
    of every array) and moves it to ``device`` on a background thread,
    keeping up to ``depth`` batches in flight.

    On a CUDA device the copies go from pinned host memory, non-blocking,
    on a side stream; the consumer's stream waits for a batch's copies
    when `__next__` hands it over.  ``process_index`` and
    ``process_count`` default to the ``torch.distributed`` rank and world
    size when a world is up, else 0 and 1.  ``device`` follows the device
    rule (CUDA unless named).  An exception in the worker is raised by
    the consumer's next `__next__`; a finite host iterator ends the
    prefetcher's iteration after its last batch."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], *, device=None,
                 depth: int = 2, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        up = dist.is_available() and dist.is_initialized()
        self.it = it
        self.device = resolve_device(device)
        self.pi = (process_index if process_index is not None
                   else dist.get_rank() if up else 0)
        self.pc = (process_count if process_count is not None
                   else dist.get_world_size() if up else 1)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _move(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _worker(self):
        try:
            for host_batch in self.it:
                if self._stop:
                    return
                shard = {}
                for k, v in host_batch.items():
                    n = v.shape[0]
                    lo = (n // self.pc) * self.pi
                    part = v[lo:lo + n // self.pc] if self.pc > 1 else v
                    shard[k] = part
                if self._stream is None:
                    item = ({k: self._move(v) for k, v in shard.items()},
                            None)
                else:
                    with torch.cuda.stream(self._stream):
                        moved = {k: self._move(v) for k, v in shard.items()}
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    item = (moved, done)
                if not self._put(item):
                    return
            self._put(_END)
        except Exception as e:                     # surface in the consumer
            self._put(e)

    def _put(self, item) -> bool:
        """Puts ``item``, waiting while the queue is full; False, with the
        item dropped, once `close` is called."""
        while not self._stop:
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self.q.get()
        if item is _END:
            self.q.put(_END)                       # and for any later call
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self):
        """Stops the worker, waits for it, and drops the batches in
        flight; a later `__next__` raises StopIteration."""
        self._stop = True
        self._thread.join()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.q.put(_END)
