"""Deterministic synthetic data pipeline (the JAX package's
``data/pipeline.py``).

Produces a reproducible token stream (a numpy generator keyed by (seed,
step)) with background prefetch.  :func:`synth_batch` is a copy of the
reference's, so a batch is bitwise the reference's for every family key;
the prefetching :class:`DataIterator` yields tensors on the caller's
device.  Modality frontends are stubs: whisper gets precomputed frame
embeddings, paligemma gets patch embeddings.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


def batch_struct(cfg, batch: int, seq: int) -> dict:
    """(shape, dtype) of every leaf of one training batch."""
    out = {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
        "loss_mask": ((batch, seq), torch.float32),
    }
    if cfg.family == "vlm":
        out["prefix_embeds"] = ((batch, cfg.num_prefix, cfg.d_model),
                                torch.float32)
    if cfg.family == "encdec":
        out["enc_frames"] = ((batch, cfg.enc_len, cfg.d_model),
                             torch.float32)
    return out


def synth_batch(cfg, batch: int, seq: int, step: int, seed: int = 0) -> dict:
    """Deterministic batch (numpy arrays) for a global step."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    # markov-ish token stream: makes loss decrease measurably on tiny runs
    base = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1),
                        dtype=np.int32)
    rep = rng.random((batch, seq + 1)) < 0.5
    for j in range(1, seq + 1):
        base[:, j] = np.where(rep[:, j],
                              (base[:, j - 1] + 1) % cfg.vocab_size,
                              base[:, j])
    out = {
        "tokens": base[:, :-1],
        "labels": base[:, 1:].copy(),
        "loss_mask": np.ones((batch, seq), np.float32),
    }
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.num_prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_frames"] = rng.standard_normal(
            (batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


class DataIterator:
    """Prefetching iterator yielding batches of tensors on ``device``.
    A worker thread makes the numpy batches ahead; :meth:`close` stops and
    joins it.  An error in the worker is raised by ``next``."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2, device="cuda"):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = resolve_device(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                item = (step, synth_batch(self.cfg, self.batch, self.seq,
                                          step, self.seed))
            except Exception as e:   # handed to the consumer by __next__
                item = (step, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        step, b = self._q.get()
        if isinstance(b, Exception):
            raise b
        self.step = step + 1
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in b.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
