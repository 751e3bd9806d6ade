"""Time flash_attention's SIMT kernel at one head dim in its two instances.

``flash_kernel`` is compiled for D = 64, 128 and 224 and once with D read at
run time (``FA_CMAX`` = 16 output columns a thread, masked past D).  This
script builds a second library from ``csrc/flash_attention.cu`` with one
more entry that always launches the run-time instance, and times it against
the SIMT entry's own dispatch (``rt_flash_attention``; the wrapper sends
bf16 at D = 224 to the tensor-core route instead) on the same bf16 causal
inputs (zamba2's shared block by default: q/k/v (4 x 32, 1024, 224)), in the
order A B B A with CUDA events.  It prints both outputs' difference, each instance's registers and
spills from ptxas, the card's name and power limit, and a JSON line.

    python3 scripts/flash_runtime_d.py [--d 224] [--reps 20] [--out FILE]

Needs a card and nvcc; the build goes under the kernels' build directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ENTRY = """
extern "C" int rt_flash_attention_runtime_d(const void* q, const void* k, const void* v,
                                            void* o, int bhq, int s_len, int t_len, int d,
                                            int groups, int causal, int q_offset, float scale,
                                            int bf16, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16, 0>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset,
                                    scale, stream);
  return launch<float, 0>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset, scale,
                          stream);
}
"""


def build_variant(_build) -> tuple[ctypes.CDLL, str]:
    """flash_attention.cu plus ENTRY, as one shared library; (library, ptxas log)."""
    out = _build.build_dir() / "flash_runtime_d"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention_runtime_d.cu"
    src.write_text((_build.CSRC / "flash_attention.cu").read_text() + ENTRY)
    so = out / "libflash_runtime_d.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), str(src),
           "-o", str(so)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    for name in ("rt_flash_attention", "rt_flash_attention_runtime_d"):
        getattr(lib, name).argtypes = list(_build.SIGNATURES["rt_flash_attention"])
        getattr(lib, name).restype = ctypes.c_int
    return lib, proc.stdout


def ptxas_usage(log: str, d: int) -> dict:
    """Registers and spill stores of the bf16 ``flash_kernel`` instances at DC = d and 0."""
    found = {}
    blocks = re.split(r"(?=ptxas info\s+: Compiling entry function)", log)
    for dc in (d, 0):
        for b in blocks:
            head = re.search(r"Compiling entry function '(\S+)'", b)
            if head and "flash_kernel" in head.group(1) and "wgmma" not in head.group(1) \
                    and re.search(rf"Li{dc}E", head.group(1)) and "bfloat16" in head.group(1):
                regs = re.search(r"Used (\d+) registers", b)
                spill = re.search(r"(\d+) bytes spill stores", b)
                found[f"DC={dc}"] = {"registers": int(regs.group(1)) if regs else None,
                                     "spill_store_bytes": int(spill.group(1)) if spill else None}
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=224)
    ap.add_argument("--bh", type=int, default=128)
    ap.add_argument("--s", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_runtime_d: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    lib, log = build_variant(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(args.bh, args.s, args.d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out_dc, out_rt = torch.empty_like(q), torch.empty_like(q)

    def simt(entry, out):  # the SIMT kernel (bf16 at D = 224 takes wgmma in the wrapper)
        _build.check(entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), args.bh,
                           args.s, args.s, args.d, 1, 1, 0, 1.0 / args.d ** 0.5, 1,
                           _build.stream_handle(q)), "flash_attention SIMT")
        return out

    def dispatch():
        return simt(lib.rt_flash_attention, out_dc)

    def runtime_d():
        return simt(lib.rt_flash_attention_runtime_d, out_rt)

    def ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    a = dispatch().clone()
    b = runtime_d().clone()
    plain = ref.flash_attention(q, k, v).float()
    times = {"dispatch": [], "runtime_d": []}
    for name in ("dispatch", "runtime_d", "runtime_d", "dispatch"):
        times[name].append(ms(dispatch if name == "dispatch" else runtime_d))
    res = {
        "card": card, "shape": f"q/k/v ({args.bh},{args.s},{args.d}) bf16 causal, groups 1",
        "dispatch_instance": f"DC={args.d}" if args.d in (64, 128, 224) else "DC=0",
        "dispatch_ms": times["dispatch"], "runtime_d_ms": times["runtime_d"],
        "outputs_bitwise_equal": bool(torch.equal(a, b)),
        "max_abs_diff": float((a.float() - b.float()).abs().max()),
        "dispatch_err_vs_plain": float((a.float() - plain).abs().max()),
        "runtime_d_err_vs_plain": float((b.float() - plain).abs().max()),
        "max_abs_plain": float(plain.abs().max()),
        "ptxas": ptxas_usage(log, args.d),
    }
    print(f"[flash_runtime_d] {card}: {res['shape']}: dispatch ({res['dispatch_instance']}) "
          f"{times['dispatch']} ms, run-time D instance {times['runtime_d']} ms; outputs "
          f"bitwise equal {res['outputs_bitwise_equal']} (max |diff| {res['max_abs_diff']:.3e}); "
          f"ptxas {res['ptxas']}")
    text = json.dumps(res)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
