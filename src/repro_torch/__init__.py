"""CADDeLaG on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

Module names follow the JAX package so each counterpart is easy to find
(``repro_torch.core.chain`` <-> ``repro.core.chain``).  The hot kernels are
hand-written CUDA C++ under ``repro_torch/kernels/csrc``; each has a plain
PyTorch version in :mod:`repro_torch.kernels.ref` that runs for CPU tensors.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
