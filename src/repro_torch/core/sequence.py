"""Sequence engine: amortized CADDeLaG over a stream of T graph snapshots.

Port of :mod:`repro.core.sequence`.  Each snapshot's chain operator and
embedding are built exactly once and reused as the left endpoint of the next
transition; only two snapshots are live at a time.  A snapshot is a device
tensor or a store-backed snapshot handle (streamed, never resident).  An
out-of-core operator's scratch P1 / P2 are removed as the operator leaves
the two-snapshot window.  With ``donate=True`` the outgoing snapshot's
device memory (its adjacency, embedding and chain matrices) is freed as soon
as its last transition is scored -- callers must not touch a donated
snapshot again.  With an ``emb_store`` attached, each snapshot's embedding
is published to it (a host copy, before scoring) for the query read path.

With ``cfg.incremental_chain`` the detector keeps one base chain (a full
build with its levels retained) and serves later snapshots by low-rank delta
updates against it (:mod:`repro_torch.core.delta_chain`), rebuilding only
when the sketched drift passes ``cfg.delta_budget``; :meth:`finalize`
releases the base.

The sequence-wide top-k is merged on the host from each transition's
top-k, ties to the lower candidate index as ``lax.top_k`` breaks them.

On a device grid (``ctx``) each snapshot is cut into the grid's tiles (a
snapshot handle's panels stream onto them) and every path runs tile by
tile: resident or out of core, full builds or delta updates; the scores,
and the embedding published from them, live on the home device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import chain
from repro_torch.core.chain import ChainOperator
from repro_torch.core.cad import CADResult, node_anomaly_scores, top_anomalies
from repro_torch.core.delta_chain import BaseChain, build_base_chain, try_delta_update
from repro_torch.core.distmatrix import DistContext, DistMatrix, grid_or_none, on_grid
from repro_torch.core.embedding import CommuteConfig, Embedding, commute_time_embedding
from repro_torch.core.tiles import is_streamable
from repro_torch.device import resolve_device, synchronize
from repro_torch.obs import REGISTRY, phase, trace


@dataclass
class SequenceResult:
    """Per-transition results plus the sequence-wide top-k (host numpy)."""

    transitions: list[CADResult]  # transitions[t] scores snapshot t -> t+1
    global_top_idx: np.ndarray
    global_top_val: np.ndarray
    global_top_step: np.ndarray  # transition index of each entry
    n_snapshots: int
    chain_builds: int
    transition_seconds: list[float] = field(default_factory=list)
    # Registry counter deltas per scored transition; warmup_metrics is the
    # first push (embedding build only).
    transition_metrics: list[dict] = field(default_factory=list)
    warmup_metrics: dict | None = None


def _free(t) -> None:
    """Release a tensor's (or every tile's) memory now, whoever else still holds it.

    Memory PyTorch did not allocate (a tensor over a numpy array) belongs to
    its owner and is left alone.
    """
    if isinstance(t, DistMatrix):
        t.free()
        return
    storage = t.untyped_storage()
    if storage.resizable():
        storage.resize_(0)


class SequenceDetector:
    """Streaming CADDeLaG over T snapshots with one chain build per snapshot.

    ``det = SequenceDetector(cfg, top_k=20); res = det.run(snapshots)``, or
    ``push`` each snapshot and ``finalize``.  With ``ctx`` (a device grid)
    the grid's home device takes the place of ``device``.
    """

    def __init__(
        self,
        cfg: CommuteConfig | None = None,
        *,
        top_k: int = 10,
        donate: bool = False,
        device: str | torch.device = "cuda",
        emb_store=None,
        ctx: DistContext | None = None,
    ):
        self.cfg = cfg or CommuteConfig()
        self.top_k = top_k
        self.donate = donate
        self.ctx = grid_or_none(ctx)
        self.device = resolve_device(device if ctx is None else ctx.home)
        # Duck-typed (put_embedding): the core imports no store.
        self.emb_store = emb_store
        self._prev: tuple[torch.Tensor, Embedding] | None = None
        self._base: BaseChain | None = None  # incremental-chain base (cfg.incremental_chain)
        self._t = 0
        self._transitions: list[CADResult] = []
        self._seconds: list[float] = []
        self._metrics: list[dict] = []
        self._warmup_metrics: dict | None = None
        self._builds0 = chain.chain_build_count()
        self._g_val: np.ndarray | None = None
        self._g_idx: np.ndarray | None = None
        self._g_step: np.ndarray | None = None

    def _merge_topk(self, idx: torch.Tensor, val: torch.Tensor, step: int) -> None:
        """Merge one transition's top-k into the running global top-k, on host."""
        idx = idx.cpu().numpy()
        val = val.cpu().numpy()
        step_arr = np.full_like(idx, step)
        if self._g_val is None:
            cand_val, cand_idx, cand_step = val, idx, step_arr
        else:
            cand_val = np.concatenate([self._g_val, val])
            cand_idx = np.concatenate([self._g_idx, idx])
            cand_step = np.concatenate([self._g_step, step_arr])
        pos = np.argsort(-cand_val, kind="stable")[: self.top_k]
        self._g_val = cand_val[pos]
        self._g_idx = cand_idx[pos]
        self._g_step = cand_step[pos]

    def _release(self, a, emb: Embedding) -> None:
        """Retire the outgoing snapshot: its out-of-core scratch always, its
        device buffers with ``donate=True`` (store handles are the user's
        data and are left alone).  An operator on a shared base chain keeps
        its P1 / P2: they are the base's, which may still serve later
        transitions, and ``BaseChain.release`` owns them."""
        if emb.op is not None:
            emb.op.release_scratch()  # no-op on a shared base
        if not self.donate:
            return
        bufs = [a, emb.z]
        if emb.op is not None and not emb.op.shared_base:
            bufs += [emb.op.p1, emb.op.p2]
        for buf in bufs:
            if isinstance(buf, (torch.Tensor, DistMatrix)):
                _free(buf)

    def _incremental_op(self, a) -> ChainOperator:
        """The chain operator of ``a`` in incremental mode.

        A delta update against the base chain when there is one and the drift
        monitor accepts it; otherwise (no base yet, or drift over budget) a
        full build that becomes the new base.  Timed under the same
        ``phase("chain")`` counter as a full build, annotated with the mode.
        """
        with phase("chain", n=int(a.shape[0]), d=self.cfg.d, oocore=self.cfg.oocore,
                   incremental=True) as sp:
            if self._base is not None:
                op = try_delta_update(self._base, a, self.cfg)
                if op is not None:
                    sp.annotate(mode="delta")
                    return op
                self._base.release()  # drift over budget: retire it, then rebuild
                self._base = None
            self._base = build_base_chain(a, self.cfg, device=self.device, ctx=self.ctx)
            sp.annotate(mode="rebuild")
            op = self._base.op
            sp.fence(op.vol)
        return op

    def _publish(self, emb: Embedding) -> None:
        """Publish snapshot t's embedding to the attached store as ``tNNNN``.

        The artifact is a host copy of (z, vol, deg), so readers never alias
        device buffers that ``donate=True`` frees; the store commits it only
        once every panel is written.  Resident and out-of-core operators
        both carry ``deg`` on the card (on a grid, Z and ``deg`` live on its
        home device).
        """
        with phase("publish", t=self._t, n=int(emb.z.shape[0])):
            self.emb_store.put_embedding(
                f"t{self._t:04d}", emb.z.cpu().numpy(), float(emb.vol), emb.op.deg.cpu().numpy()
            )

    def push(self, a) -> CADResult | None:
        """Consume snapshot t (a tensor or a snapshot handle); returns the
        CADResult of transition (t-1, t), None at t=0."""
        t0 = time.perf_counter()
        m0 = REGISTRY.snapshot()
        if self.ctx is not None:
            a = on_grid(self.ctx, a)
        elif isinstance(a, DistMatrix):
            raise ValueError("a DistMatrix snapshot needs SequenceDetector(ctx=) of its grid")
        elif not is_streamable(a):
            a = a.to(self.device)
        with trace.span("sequence.push", t=self._t) as push_sp:
            warm_from = (
                self._prev[1].z if (self.cfg.warm_start and self._prev is not None) else None
            )
            op_in = self._incremental_op(a) if self.cfg.incremental_chain else None
            emb = commute_time_embedding(a, self.cfg, op=op_in, warm_from=warm_from,
                                         device=self.device, ctx=self.ctx)
            if self.emb_store is not None:
                self._publish(emb)
            out = None
            if self._prev is not None:
                a_prev, e_prev = self._prev
                scores = node_anomaly_scores(a_prev, a, e_prev, emb,
                                             prefetch_depth=self.cfg.prefetch_depth, ctx=self.ctx)
                idx, vals = top_anomalies(scores, self.top_k)
                out = CADResult(scores=scores, top_idx=idx, top_val=vals,
                                solve_reports=(e_prev.report, emb.report))
                self._merge_topk(idx, vals, self._t - 1)  # host copy: waits for the scores
                synchronize(scores)
                self._transitions.append(out)
                self._seconds.append(time.perf_counter() - t0)
                self._metrics.append(REGISTRY.delta(m0))
                self._release(a_prev, e_prev)
            else:
                self._warmup_metrics = REGISTRY.delta(m0)
            push_sp.annotate(scored=out is not None)
        self._prev = (a, emb)
        self._t += 1
        return out

    def finalize(self) -> SequenceResult:
        """Package per-transition results and the sequence-wide top-k.

        T=1 gives an empty result; T=0 (nothing pushed) raises.
        """
        if self._t == 0:
            raise ValueError(
                "finalize() on an empty sequence: 0 snapshots were pushed "
                "(scoring transitions needs at least 2)"
            )
        if self._base is not None:
            # Retire the base chain: its retained levels (and, out of core,
            # their scratch snapshots) die here; the scores are on hand.
            self._base.release()
            self._base = None
        empty = not self._transitions
        return SequenceResult(
            transitions=self._transitions,
            global_top_idx=np.zeros(0, np.int64) if empty else self._g_idx,
            global_top_val=np.zeros(0, np.float32) if empty else self._g_val,
            global_top_step=np.zeros(0, np.int64) if empty else self._g_step,
            n_snapshots=self._t,
            chain_builds=chain.chain_build_count() - self._builds0,
            transition_seconds=self._seconds,
            transition_metrics=self._metrics,
            warmup_metrics=self._warmup_metrics,
        )

    def run(self, snapshots: Iterable) -> SequenceResult:
        """Consume an iterator of T snapshots, score all T-1 transitions."""
        for a in snapshots:
            self.push(a)
        return self.finalize()


def detect_sequence_anomalies(
    snapshots: Iterable[torch.Tensor],
    cfg: CommuteConfig | None = None,
    *,
    top_k: int = 10,
    donate: bool = False,
    device: str | torch.device = "cuda",
    emb_store=None,
    ctx: DistContext | None = None,
) -> SequenceResult:
    """One-shot convenience wrapper around :class:`SequenceDetector`."""
    return SequenceDetector(cfg, top_k=top_k, donate=donate, device=device,
                            emb_store=emb_store, ctx=ctx).run(snapshots)
