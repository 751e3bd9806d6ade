"""The query read path's fused distance / top-k merge (``csrc/emb_query.cu``).

Counterpart of :mod:`repro.kernels.emb_query`: one call merges one streamed
Z row panel into the running per-query top-k, so a whole-store query is
:func:`topk_init`, one :func:`panel_topk_update` per panel, and a read-back
of the (q, topk) state.  A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.panel_topk_update`); a CUDA tensor launches
the kernel or raises.

Unlike the TPU kernel, a position selected once is never selected again:
with topk larger than the finite candidates the empty slots stay (worst,
-1) instead of repeating an id (see ``csrc/emb_query.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)

K_MAX = 256  # widest sketch the kernel takes (the query row sits in shared memory)
CAND_MAX = 8192  # most candidates (topk + panel rows) one launch sorts in shared memory


def topk_init(nq: int, topk: int, *, largest: bool, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The seed running state: worst-possible values, id -1 (empty slots)."""
    worst = float("-inf") if largest else float("inf")
    return (
        torch.full((nq, topk), worst, dtype=torch.float32, device=device),
        torch.full((nq, topk), -1, dtype=torch.int32, device=device),
    )


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
    merged (vals, ids); ids are global node ids, -1 in unfilled slots.
    """
    global launches
    q, kdim = zq.shape
    ph, k2 = z_panel.shape
    if kdim != k2:
        raise ValueError(f"panel_topk_update: query dim mismatch: {tuple(zq.shape)} vs panel "
                         f"{tuple(z_panel.shape)}")
    if tuple(run_vals.shape) != (q, topk) or tuple(run_idx.shape) != (q, topk):
        raise ValueError(f"panel_topk_update: running state must be {(q, topk)}, got "
                         f"{tuple(run_vals.shape)}/{tuple(run_idx.shape)}")
    if tuple(inv_deg_q.shape) != (q, 1) or tuple(inv_deg_panel.shape) != (1, ph):
        raise ValueError(f"panel_topk_update: inv_deg blocks must be {(q, 1)}/{(1, ph)}, got "
                         f"{tuple(inv_deg_q.shape)}/{tuple(inv_deg_panel.shape)}")
    if tuple(exclude.shape) != (q, 1):
        raise ValueError(f"panel_topk_update: exclude must be {(q, 1)}, got {tuple(exclude.shape)}")
    if z_panel.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"panel_topk_update: z_panel must be float32 or int16 bf16 bits, got "
                        f"{z_panel.dtype}")
    if any(t.dtype != torch.float32 for t in (run_vals, zq, inv_deg_q, inv_deg_panel)):
        raise TypeError("panel_topk_update: run_vals, zq and inv_deg must be float32")
    if run_idx.dtype != torch.int32 or exclude.dtype != torch.int32:
        raise TypeError("panel_topk_update: run_idx and exclude must be int32")
    tensors = (run_vals, run_idx, zq, z_panel, inv_deg_q, inv_deg_panel, exclude)
    if any(t.device != zq.device for t in tensors):
        raise ValueError("panel_topk_update: operands on different devices")
    if zq.device.type == "cpu":
        return ref.panel_topk_update(run_vals, run_idx, zq, z_panel, inv_deg_q, inv_deg_panel,
                                     vol, row0, exclude, topk=topk, corrected=corrected,
                                     largest=largest)
    if zq.device.type != "cuda":
        raise ValueError(f"panel_topk_update: unsupported device {zq.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("panel_topk_update: operands must be contiguous")
    if not 1 <= kdim <= K_MAX:
        raise ValueError(f"panel_topk_update: sketch width k={kdim} outside 1..{K_MAX}")
    if topk < 1 or topk + ph > CAND_MAX:
        raise ValueError(f"panel_topk_update: topk={topk} must be >= 1 and topk + panel rows "
                         f"({topk + ph}) at most {CAND_MAX}")
    out_v = torch.empty((q, topk), dtype=torch.float32, device=zq.device)
    out_i = torch.empty((q, topk), dtype=torch.int32, device=zq.device)
    if q == 0:
        return out_v, out_i
    lib = _build.library()
    err = lib.rt_panel_topk_update(
        run_vals.data_ptr(), run_idx.data_ptr(), zq.data_ptr(), z_panel.data_ptr(),
        int(z_panel.dtype == torch.int16), inv_deg_q.data_ptr(), inv_deg_panel.data_ptr(),
        float(vol), int(row0), exclude.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        q, ph, kdim, topk, int(corrected), int(largest), _build.stream_handle(zq),
    )
    _build.check(err, "panel_topk_update")
    launches += 1
    return out_v, out_i
