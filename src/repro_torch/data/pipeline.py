"""Deterministic synthetic token pipeline with prefetch.

Port of :mod:`repro.data.pipeline`, bit for bit.  Every batch is a pure
function of (seed, step), through the port's copy of the counter hash
(:mod:`repro_torch.core.rng`): after a restore at step k the pipeline at step
k + 1 gives the same tokens, labels and frames as an uninterrupted run, and
as the JAX package's pipeline.  Batches are numpy arrays on the host; the
training step moves them to its device.

Tokens follow a skewed (Zipf-ish) distribution with a deterministic
next-token structure so small models can measurably learn; labels are the
next-token shift.  ``global_batch_for`` (each device's shard of a sharded
batch) needs a device mesh, which the port does not have yet (ROADMAP.md,
item 9c).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import rng as crng

_MASK = 0xFFFFFFFF


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames_dim: int = 0  # > 0: also emit frame embeddings (the enc-dec stub)


def _hash(*parts) -> np.ndarray:
    """``crng.hash_u32`` of integer numpy parts (uint32 values), as int64 numpy."""
    return crng.hash_u32(*(torch.from_numpy(np.asarray(p, np.int64)) for p in parts)).numpy()


def _tokens_for(cfg: DataConfig, step: int, rows: np.ndarray) -> np.ndarray:
    """(len(rows), seq_len) int32 tokens for the given global row indices."""
    s = np.arange(cfg.seq_len, dtype=np.int64)[None, :]
    # the JAX package's uint32 arithmetic: row * 1_000_003 + step, mod 2^32
    r = (rows.astype(np.int64)[:, None] * 1_000_003 + (step & _MASK)) & _MASK
    h = _hash(cfg.seed & _MASK, r, s)
    # Zipf-ish skew: square the uniform so low ids dominate, then add a
    # learnable structure: every 4th token is a function of the previous one.
    u = (h.astype(np.float64) / 2**32) ** 2
    tok = (u * cfg.vocab).astype(np.int64)
    for j in range(1, cfg.seq_len, 4):
        tok[:, j] = (tok[:, j - 1] * 31 + 7) % cfg.vocab
    return tok.astype(np.int32)


def host_batch(cfg: DataConfig, step: int) -> dict:
    """The whole global batch: tokens and labels (B, S) int32 [+ frames
    (B, S, frames_dim) float32 in [-1, 1)]."""
    rows = np.arange(cfg.global_batch)
    tok = _tokens_for(cfg, step, rows)
    labels = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    out = {"tokens": tok, "labels": labels}
    if cfg.frames_dim:
        h = _hash((cfg.seed + 1) & _MASK, rows[:, None, None],
                  np.arange(cfg.seq_len)[None, :, None],
                  np.arange(cfg.frames_dim)[None, None, :])
        out["frames"] = (h.astype(np.float32) / 2**31 - 1.0).astype(np.float32)
    return out


class Prefetcher:
    """One-batch-ahead prefetch on a background thread (``close`` stops it)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, make=host_batch):
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def work():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(make(cfg, step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def next(self) -> dict:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5.0)
