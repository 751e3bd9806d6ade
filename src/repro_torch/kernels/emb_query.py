"""The query read path's fused distance / top-k merge (``csrc/emb_query.cu``).

Counterpart of :mod:`repro.kernels.emb_query`: a whole-store query merges
every streamed Z row panel into a running per-query top-k.  :class:`PanelTopk`
is that merger: it checks the query's arguments once, owns the running
(q, topk) state, and launches one kernel per panel with only the panel's
own arguments.  :func:`panel_topk_update` is the one-panel call on top of it.
A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.panel_topk_update`); a CUDA tensor launches
the kernel or raises.

Unlike the TPU kernel, a position selected once is never selected again:
with topk larger than the finite candidates the empty slots stay (worst,
-1) instead of repeating an id (see ``csrc/emb_query.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset (see kernels.reset_launch_counts)
launches = 0

K_MAX = 256  # widest sketch the kernel takes (the query row sits in shared memory)
CAND_MAX = 8192  # most candidates (topk + panel rows) one launch sorts in shared memory


def topk_init(nq: int, topk: int, *, largest: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The seed running state: worst-possible values, id -1 (empty slots)."""
    worst = float("-inf") if largest else float("inf")
    return (
        torch.full((nq, topk), worst, dtype=torch.float32, device=device),
        torch.full((nq, topk), -1, dtype=torch.int32, device=device),
    )


class _TopkPlan(ctypes.Structure):
    """The kernel's ``TopkPlan`` (``csrc/emb_query.cu``), field for field."""

    _fields_ = [
        ("vals", ctypes.c_void_p * 2),
        ("ids", ctypes.c_void_p * 2),
        ("zq", ctypes.c_void_p),
        ("idq", ctypes.c_void_p),
        ("idp", ctypes.c_void_p),
        ("ex", ctypes.c_void_p),
        ("stream", ctypes.c_void_p),
        ("vol", ctypes.c_float),
        ("idp_row0", ctypes.c_int),
        ("nq", ctypes.c_int),
        ("k", ctypes.c_int),
        ("topk", ctypes.c_int),
        ("corrected", ctypes.c_int),
        ("largest", ctypes.c_int),
        ("cur", ctypes.c_int),
    ]


class PanelTopk:
    """Merges Z row panels into one running per-query top-k.

    ``zq`` (q, k) fp32 are the query rows; ``inv_deg_q`` (q, 1) and
    ``inv_deg`` (1, N) fp32 the correction terms (read only when
    ``corrected``), ``inv_deg[:, i]`` belonging to global row
    ``inv_deg_row0 + i``; ``vol`` the graph volume (read only when not
    ``corrected``); ``exclude`` (q, 1) int32 a global id per query scored
    worst (-1 for none); ``panel_rows`` the most rows a panel may have.
    ``state`` is the running (vals, ids) to start from (left unchanged;
    :func:`topk_init`'s by default).  Everything is checked here, once;
    :meth:`update` takes a panel, :meth:`result` reads the state.  On the
    card a merge launches on the stream current at construction.
    """

    def __init__(self, zq, inv_deg_q, inv_deg, exclude, vol: float, *, topk: int,
                 panel_rows: int, corrected: bool = False, largest: bool = True,
                 inv_deg_row0: int = 0, state=None):
        q, kdim = zq.shape
        borrowed = state is not None
        run_vals, run_idx = state if borrowed else topk_init(q, topk, largest=largest,
                                                             device=zq.device)
        if tuple(run_vals.shape) != (q, topk) or tuple(run_idx.shape) != (q, topk):
            raise ValueError(f"panel_topk_update: running state must be {(q, topk)}, got "
                             f"{tuple(run_vals.shape)}/{tuple(run_idx.shape)}")
        if tuple(inv_deg_q.shape) != (q, 1) or inv_deg.ndim != 2 or inv_deg.shape[0] != 1:
            raise ValueError(f"panel_topk_update: inv_deg blocks must be {(q, 1)}/(1, rows), got "
                             f"{tuple(inv_deg_q.shape)}/{tuple(inv_deg.shape)}")
        if tuple(exclude.shape) != (q, 1):
            raise ValueError(f"panel_topk_update: exclude must be {(q, 1)}, got "
                             f"{tuple(exclude.shape)}")
        if any(t.dtype != torch.float32 for t in (run_vals, zq, inv_deg_q, inv_deg)):
            raise TypeError("panel_topk_update: run_vals, zq and inv_deg must be float32")
        if run_idx.dtype != torch.int32 or exclude.dtype != torch.int32:
            raise TypeError("panel_topk_update: run_idx and exclude must be int32")
        tensors = (run_vals, run_idx, zq, inv_deg_q, inv_deg, exclude)
        _build.refuse_grad("panel_topk_update", *tensors)
        if any(t.device != zq.device for t in tensors):
            raise ValueError("panel_topk_update: operands on different devices")
        self.device, self.q, self.k = zq.device, q, kdim
        self.panel_rows = panel_rows
        self._zq, self._idq, self._inv, self._ex = zq, inv_deg_q, inv_deg, exclude
        self._inv_row0, self._vol = inv_deg_row0, vol
        self._kw = dict(topk=topk, corrected=corrected, largest=largest)
        self._state = (run_vals, run_idx)
        if zq.device.type == "cpu":
            return
        if zq.device.type != "cuda":
            raise ValueError(f"panel_topk_update: unsupported device {zq.device}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("panel_topk_update: operands must be contiguous")
        if not 1 <= kdim <= K_MAX:
            raise ValueError(f"panel_topk_update: sketch width k={kdim} outside 1..{K_MAX}")
        if topk < 1 or topk + panel_rows > CAND_MAX:
            raise ValueError(f"panel_topk_update: topk={topk} must be >= 1 and topk + panel rows "
                             f"({topk + panel_rows}) at most {CAND_MAX}")
        # two state slots used in turn; a caller's state is slot 0 until a
        # merge would write it, when a buffer of our own takes its place
        self._slots = [(run_vals, run_idx), (torch.empty_like(run_vals), torch.empty_like(run_idx))]
        self._borrowed = borrowed
        plan = _TopkPlan()
        for i, (v, ids) in enumerate(self._slots):
            plan.vals[i], plan.ids[i] = v.data_ptr(), ids.data_ptr()
        plan.zq, plan.idq, plan.idp, plan.ex = (t.data_ptr() for t in (zq, inv_deg_q, inv_deg,
                                                                      exclude))
        plan.stream = _build.stream_handle(zq)
        plan.vol, plan.idp_row0 = float(vol), int(inv_deg_row0)
        plan.nq, plan.k, plan.topk = q, kdim, topk
        plan.corrected, plan.largest = int(corrected), int(largest)
        plan.cur = 0
        self._plan = plan
        self._plan_ptr = ctypes.addressof(plan)
        self._step = _build.library().rt_panel_topk_step

    def update(self, z_panel: torch.Tensor, row0: int) -> None:
        """Merge one (ph, k) panel, fp32 or bf16 bit patterns carried as
        int16, of global rows ``row0 .. row0 + ph``."""
        global launches
        _build.refuse_grad("panel_topk_update", z_panel)
        ph = z_panel.shape[0]
        lo = row0 - self._inv_row0
        if (z_panel.ndim != 2 or z_panel.shape[1] != self.k or ph > self.panel_rows or lo < 0
                or lo + ph > self._inv.shape[1]):
            raise ValueError(f"panel_topk_update: panel {tuple(z_panel.shape)} at row {row0} "
                             f"does not fit (k={self.k}, at most {self.panel_rows} rows, inv_deg "
                             f"of rows {self._inv_row0}..{self._inv_row0 + self._inv.shape[1]})")
        bits = z_panel.dtype == torch.int16
        if not bits and z_panel.dtype != torch.float32:
            raise TypeError(f"panel_topk_update: z_panel must be float32 or int16 bf16 bits, got "
                            f"{z_panel.dtype}")
        if z_panel.device != self.device:
            raise ValueError("panel_topk_update: operands on different devices")
        if self.device.type == "cpu":
            self._state = ref.panel_topk_update(
                *self._state, self._zq, z_panel, self._idq, self._inv[:, lo : lo + ph], self._vol,
                row0, self._ex, **self._kw)
            return
        if not z_panel.is_contiguous():
            raise ValueError("panel_topk_update: operands must be contiguous")
        if self.q == 0:
            return
        plan = self._plan
        if self._borrowed and plan.cur == 1:  # this merge writes slot 0
            v, ids = self._slots[1]
            self._slots[0] = (torch.empty_like(v), torch.empty_like(ids))
            plan.vals[0], plan.ids[0] = self._slots[0][0].data_ptr(), self._slots[0][1].data_ptr()
            self._borrowed = False
        with _build.on_device(z_panel):
            err = self._step(self._plan_ptr, z_panel.data_ptr(), int(bits), int(row0), ph)
        _build.check(err, "panel_topk_update")
        launches += 1

    def result(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The running (vals, ids): ids are global node ids, -1 in unfilled slots."""
        if self.device.type == "cpu":
            return self._state
        return self._slots[self._plan.cur]


def panel_topk_update(
    run_vals: torch.Tensor,
    run_idx: torch.Tensor,
    zq: torch.Tensor,
    z_panel: torch.Tensor,
    inv_deg_q: torch.Tensor,
    inv_deg_panel: torch.Tensor,
    vol: float,
    row0: int,
    exclude: torch.Tensor,
    *,
    topk: int,
    corrected: bool = False,
    largest: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge one Z row panel into the running per-query top-k.

    ``run_vals`` (q, topk) fp32 / ``run_idx`` (q, topk) int32 are the state;
    ``zq`` (q, k) fp32 the query rows; ``z_panel`` (ph, k) fp32 or bf16 bit
    patterns carried as int16; ``inv_deg_q`` (q, 1) / ``inv_deg_panel``
    (1, ph) fp32 the correction terms (read only when ``corrected``);
    ``vol`` the graph volume (read only when not ``corrected``) and ``row0``
    the panel's global row origin, both host scalars; ``exclude`` (q, 1)
    int32 a global id per query scored worst (-1 for none).  Returns the
    merged (vals, ids), new tensors; ids are global node ids, -1 in unfilled
    slots.
    """
    q, kdim = zq.shape
    ph, k2 = z_panel.shape
    if kdim != k2:
        raise ValueError(f"panel_topk_update: query dim mismatch: {tuple(zq.shape)} vs panel "
                         f"{tuple(z_panel.shape)}")
    if tuple(inv_deg_panel.shape) != (1, ph):
        raise ValueError(f"panel_topk_update: inv_deg_panel must be {(1, ph)}, got "
                         f"{tuple(inv_deg_panel.shape)}")
    merger = PanelTopk(zq, inv_deg_q, inv_deg_panel, exclude, vol, topk=topk, panel_rows=ph,
                       corrected=corrected, largest=largest, inv_deg_row0=row0,
                       state=(run_vals, run_idx))
    merger.update(z_panel, row0)
    return merger.result()
