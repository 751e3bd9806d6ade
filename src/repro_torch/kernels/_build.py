"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use every source is compiled with ``nvcc`` for ``sm_90a`` -- one
``nvcc`` process per source, all started together -- and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library is cached under ``build/repro_torch_kernels/`` (or
``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of the sources and flags, so a
later process reuses it and an edited source rebuilds.  Nothing is built at
import time: the CPU tests import every module without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("block_matmul.cu", "edge_projection.cu", "cad_score.cu", "stream_gemm.cu",
           "emb_query.cu", "wkv.cu", "flash_attention.cu")
HEADERS = ("common.cuh", "hopper.cuh", "tf32x3.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "rt_block_matmul_f32": (_P, _P, _P, _I, _I, _I, _P, _L, _I, _P),
    "rt_block_matmul_bf16": (_P, _P, _P, _I, _I, _I, _P, _L, _I, _P),
    "rt_split_tf32": (_P, _P, _P, _I, _I, _P),
    "rt_edge_projection": (_P, _P, _P, _I, _I, _I, _I, _U, _I, _F, _P),
    "rt_rademacher_field": (_P, _I, _I, _I, _I, _U, _I, _P),
    "rt_cad_scores": (_P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _I, _I, _I, _P),
    "rt_cad_scores_k_max": (),
    "rt_stream_gemm_tc": (_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P, _L, _P),
    "rt_stream_gemm_skinny": (_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _L, _P),
    "rt_fused_panel_matvec": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _P),
    "rt_panel_topk_step": (_P, _P, _I, _I, _I),
    "rt_wkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "rt_flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}
# entry points that return a size (long long): the scratch a launch takes
SIZES = {
    "rt_edge_projection_scratch_elems": (_I, _I, _I, _I),
    "rt_cad_scores_scratch_elems": (_I, _I, _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}  # path, seconds, cached, ptxas log of the loaded library's build


def ptxas_usage(log: str, kernel: str) -> dict | None:
    """Registers and spill bytes that ptxas reported for the first entry
    function whose mangled name contains ``kernel`` (e.g.
    ``"flash_kernel_wgmmaILi224E"``), from a build log; None when the log
    does not hold it."""
    import re

    for part in log.split("Compiling entry function '")[1:]:
        if kernel not in part.split("'", 1)[0]:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        stores = re.search(r"(\d+) bytes spill stores", part)
        loads = re.search(r"(\d+) bytes spill loads", part)
        if regs and stores and loads:
            return {"registers": int(regs.group(1)), "spill_stores": int(stores.group(1)),
                    "spill_loads": int(loads.group(1))}
    return None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source in parallel, link one .so at ``out``; returns the log."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[str(obj) for _, obj, _ in procs], "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)  # atomic: concurrent builders never see a torn file
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"librepro_torch_kernels_{_digest()}.so"
        log_path = so.with_suffix(".log")  # the build's ptxas report, kept for a cached load
        t0 = time.perf_counter()
        cached = so.exists()
        if cached:
            log = log_path.read_text() if log_path.exists() else ""
        else:
            log = _compile(so)
            log_path.write_text(log)
        lib = ctypes.CDLL(str(so))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        for name, args in SIZES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_longlong
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0,
                          cached=cached, log=log)
        _lib = lib
        return lib


# Devices whose tensors take a kernel's plain version (``kernels/ref.py``):
# the CPU, and the shape-only ``meta`` device of the dry run, where nothing
# is computed.  A CUDA tensor launches the kernel or raises; nothing else runs.
PLAIN_DEVICES = ("cpu", "meta")


def plain(t) -> bool:
    """Whether the tensor ``t`` takes its kernel's plain version."""
    return t.device.type in PLAIN_DEVICES


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t):
    """Make ``t``'s card the CUDA runtime's current device for a launch.

    The entry points launch on the current device and read its attributes
    (SM count, shared-memory limits), so a wrapper enters this around every
    launch: an operand on ``cuda:1`` while ``cuda:0`` is current then runs
    on its own card.
    """
    import torch

    return torch.cuda.device(t.device)


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and an operand requires grad.

    No kernel has a backward of its own: a gradient through one goes by its
    ``torch.autograd.Function`` (``flash_attention.FlashAttentionFn``,
    ``wkv.WKVFn``), whose forward runs with grad mode off.  A wrapper called
    directly on such an operand would return a tensor cut from the graph, so
    the gradient would stop there without a word.
    """
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an operand requires grad and the kernel has no backward; differentiate "
            f"through its autograd.Function, or call it under torch.no_grad()")
