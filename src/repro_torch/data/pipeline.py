"""Deterministic synthetic token pipeline with prefetch.

Port of :mod:`repro.data.pipeline`, bit for bit.  Every batch is a pure
function of (seed, step), through the port's copy of the counter hash
(:mod:`repro_torch.core.rng`): after a restore at step k the pipeline at step
k + 1 gives the same tokens, labels and frames as an uninterrupted run, and
as the JAX package's pipeline.  Batches are numpy arrays on the host; the
training step moves them to its device.

Tokens follow a skewed (Zipf-ish) distribution with a deterministic
next-token structure so small models can measurably learn; labels are the
next-token shift.  :func:`global_batch_for` gives the batch on a device
grid: each tile's rows generated from the counter hash for those rows
alone, with no gather.
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


def global_batch_for(cfg: DataConfig, step: int, grid, spec) -> dict:
    """The global batch laid out on a device grid by ``spec`` (a partition
    spec over the grid's axes for (batch, seq), e.g. ``Spec("data", None)``):
    per-tile ``tokens`` and ``labels`` (``collectives.Sharded``, int32, each
    on its tile's device), each tile's rows and positions generated from the
    counter hash for those rows alone -- no tile reads another's, no host
    holds the whole batch.  With ``cfg.frames_dim`` also ``frames`` (B, S,
    frames_dim) float32, laid out by ``spec`` on (batch, seq), the feature
    dim whole.  The tiles put together are :func:`host_batch`'s arrays, bit
    for bit."""
    from repro_torch.core.collectives import Sharded, entry_axes
    from repro_torch.models.common import sanitize_spec
    from repro_torch.launch.mesh import as_grid

    g = as_grid(grid)
    shape = (cfg.global_batch, cfg.seq_len)
    sp = tuple(sanitize_spec(spec, shape, g))
    ax = [entry_axes(e) for e in sp]
    n = [shape[d] // int(np.prod([g.shape[a] for a in ax[d]])) for d in range(2)]
    toks, labs, frames = [], [], []
    for t, dev in enumerate(g.devices):
        r0, c0 = g.position(t, ax[0]) * n[0], g.position(t, ax[1]) * n[1]
        tok = _tokens_for(cfg, step, np.arange(r0, r0 + n[0]))
        lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
        toks.append(torch.from_numpy(tok[:, c0:c0 + n[1]].copy()).to(dev))
        labs.append(torch.from_numpy(lab[:, c0:c0 + n[1]].copy()).to(dev))
        if cfg.frames_dim:
            h = _hash((cfg.seed + 1) & _MASK, np.arange(r0, r0 + n[0])[:, None, None],
                      np.arange(c0, c0 + n[1])[None, :, None],
                      np.arange(cfg.frames_dim)[None, None, :])
            frames.append(torch.from_numpy(
                (h.astype(np.float32) / 2**31 - 1.0).astype(np.float32)).to(dev))
    out = {"tokens": Sharded(toks, sp, shape), "labels": Sharded(labs, sp, shape)}
    if cfg.frames_dim:
        out["frames"] = Sharded(frames, (*sp, None), (*shape, cfg.frames_dim))
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
