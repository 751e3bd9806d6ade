"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

* ``block_matmul`` -- ``csrc/block_matmul.cu``, replaces the Pallas
  ``repro/kernels/block_matmul.py``;
* ``edge_projection`` -- ``csrc/edge_projection.cu``, replaces
  ``repro/kernels/edge_projection.py``;
* ``cad_score`` -- ``csrc/cad_score.cu``, replaces ``repro/kernels/cad_score.py``.

Each wrapper counts its launches in a plain integer; :func:`launch_counts`
reads them and :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

from repro_torch.kernels import block_matmul as _bm
from repro_torch.kernels import cad_score as _cad
from repro_torch.kernels import edge_projection as _ep

_MODULES = {"block_matmul": _bm, "edge_projection": _ep, "cad_scores": _cad}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
