"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

* ``block_matmul`` -- ``csrc/block_matmul.cu``, replaces the Pallas
  ``repro/kernels/block_matmul.py``;
* ``edge_projection`` -- ``csrc/edge_projection.cu``, replaces
  ``repro/kernels/edge_projection.py``;
* ``cad_score`` -- ``csrc/cad_score.cu``, replaces ``repro/kernels/cad_score.py``;
* ``stream_gemm`` -- ``csrc/stream_gemm.cu`` (its tensor-core route on
  ``csrc/tf32x3.cuh``, shared with ``block_matmul``), replaces ``stream_gemm``
  and ``fused_panel_matvec`` of ``repro/kernels/stream_gemm.py``
  (``stream_gemm_tc`` counts the tensor-core route of ``stream_gemm``, the
  rest took the skinny one);
* ``emb_query`` -- ``csrc/emb_query.cu``, replaces ``panel_topk_update`` of
  ``repro/kernels/emb_query.py``;
* ``wkv`` -- ``csrc/wkv.cu``, replaces ``repro/kernels/wkv.py``;
* ``flash_attention`` -- ``csrc/flash_attention.cu``, replaces
  ``repro/kernels/flash_attention.py`` (two routes; ``flash_attention_wgmma``
  counts the tensor-core one, ``flash_attention`` both).

Each wrapper counts its launches in a plain integer; :func:`launch_counts`
reads them and :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

from repro_torch.kernels import block_matmul as _bm
from repro_torch.kernels import cad_score as _cad
from repro_torch.kernels import edge_projection as _ep
from repro_torch.kernels import emb_query as _eq
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import stream_gemm as _sg
from repro_torch.kernels import wkv as _wkv

# name -> (module, its counter attribute)
_COUNTERS = {
    "block_matmul": (_bm, "launches"),
    "edge_projection": (_ep, "launches"),
    "cad_scores": (_cad, "launches"),
    "stream_gemm": (_sg, "gemm_launches"),
    "stream_gemm_tc": (_sg, "tc_launches"),
    "fused_panel_matvec": (_sg, "matvec_launches"),
    "panel_topk_update": (_eq, "launches"),
    "wkv": (_wkv, "launches"),
    "flash_attention": (_fa, "launches"),
    "flash_attention_wgmma": (_fa, "wgmma_launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
