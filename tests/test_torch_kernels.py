"""The port's kernel plain versions against the Pallas kernels and repro.kernels.ref.

The Pallas kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them; tolerances are that file's.  The CUDA kernels themselves run only
on the card (chip_smoke.py and tests/test_torch_cuda.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels, resolve_device
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import cad_score as cad
from repro_torch.kernels import edge_projection as ep
from repro_torch.kernels import emb_query as eq
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stream_gemm as sg
from repro_torch.kernels import wkv

ROOT = Path(__file__).resolve().parents[1]


def _arr(rng, shape, positive=False):
    x = rng.normal(size=shape).astype(np.float32)
    return np.abs(x) if positive else x


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128), (120, 72, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matmul_plain_matches_pallas(m, k, n, dtype):
    rng = np.random.default_rng(42)
    a, b = _arr(rng, (m, k)), _arr(rng, (k, n))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    want = np.asarray(jops.block_matmul(ja, jb, bm=128, bk=128, bn=128, out_dtype=jnp.float32))
    want_ref = np.asarray(jref.block_matmul(ja, jb, out_dtype=jnp.float32))
    tdt = getattr(torch, dtype)
    # the same (bf16-rounded) inputs on both sides
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tdt)
    got = bm.block_matmul(ta, tb, out_dtype=torch.float32).numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("n,k", [(128, 4), (192, 15), (96, 17), (130, 33), (100, 40)])
def test_edge_projection_plain_matches_pallas(n, k):
    a = _arr(np.random.default_rng(n), (n, n), positive=True)
    want = np.asarray(jops.edge_projection(jnp.asarray(a), seed=3, k=k, bm=64, bn=64))
    want_ref = np.asarray(jref.edge_projection(jnp.asarray(a), seed=3, k=k))
    got = ep.edge_projection(torch.from_numpy(a), seed=3, k=k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("r0,h", [(0, 40), (63, 30), (120, 10)])
def test_edge_projection_plain_panel_matches_pallas_rows(r0, h):
    """A row panel at global row r0 of a non-symmetric A (signed, numpy seed):
    the plain version hashes its global rows, so it gives the same rows of the
    JAX function's whole-matrix result."""
    n, k = 130, 17
    a = _arr(np.random.default_rng(5), (n, n))
    assert not np.array_equal(a, a.T)
    want = np.asarray(jops.edge_projection(jnp.asarray(a), seed=3, k=k, bm=64, bn=64))[r0 : r0 + h]
    want_ref = np.asarray(jref.edge_projection(jnp.asarray(a), seed=3, k=k))[r0 : r0 + h]
    got = ep.edge_projection(torch.from_numpy(a[r0 : r0 + h].copy()), seed=3, k=k, row0=r0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-4)


def test_edge_projection_plain_row_chunks_agree(monkeypatch):
    """Working in row chunks (as on the card at n=10512) gives the same result."""
    a = torch.from_numpy(_arr(np.random.default_rng(0), (80, 80), positive=True))
    whole = tref.edge_projection(a, seed=9, k=6)
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 80 * 6 * 7)  # 7-row chunks
    np.testing.assert_array_equal(tref.edge_projection(a, seed=9, k=6).numpy(), whole.numpy())


@pytest.mark.parametrize("n,k", [(128, 8), (96, 17)])
def test_cad_scores_plain_matches_pallas(n, k):
    rng = np.random.default_rng(7)
    a1, a2 = _arr(rng, (n, n), positive=True), _arr(rng, (n, n), positive=True)
    z1, z2 = _arr(rng, (n, k)), _arr(rng, (n, k))
    v1, v2 = 10.0, 12.5
    jargs = [jnp.asarray(x) for x in (a1, a2, z1, z2)]
    want = np.asarray(jops.cad_scores(*jargs, jnp.float32(v1), jnp.float32(v2), bm=64, bn=64))
    want_ref = np.asarray(jref.cad_scores(*jargs, jnp.float32(v1), jnp.float32(v2)))
    targs = [torch.from_numpy(x) for x in (a1, a2, z1, z2)]
    got = cad.cad_scores(*targs, torch.tensor(v1), torch.tensor(v2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-2)


def test_cad_scores_tile_rectangular():
    """The rectangular tile form sums the same rows as the square scorer."""
    rng = np.random.default_rng(3)
    n, k = 64, 9
    a1, a2 = (torch.from_numpy(_arr(rng, (n, n), positive=True)) for _ in range(2))
    z1, z2 = (torch.from_numpy(_arr(rng, (n, k))) for _ in range(2))
    full = cad.cad_scores(a1, a2, z1, z2, 3.0, 4.0)
    part = cad.cad_scores_tile(a1[16:40], a2[16:40], z1[16:40], z1, z2[16:40], z2, 3.0, 4.0)
    np.testing.assert_allclose(part.numpy(), full[16:40].numpy(), rtol=1e-6, atol=1e-4)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(_arr(rng, (32, 32), positive=True))
    z = torch.from_numpy(_arr(rng, (32, 5)))
    bm.block_matmul(a, a)
    ep.edge_projection(a, seed=0, k=5)
    cad.cad_scores(a, a, z, z, 1.0, 1.0)
    sg.stream_gemm(a, z, z)
    sg.fused_panel_matvec(a, z, z, z)
    vals, ids = eq.topk_init(1, 4, largest=True, device="cpu")
    eq.panel_topk_update(vals, ids, z[:1], z, torch.zeros((1, 1)), torch.zeros((1, 32)), 1.0, 0,
                         torch.full((1, 1), -1, dtype=torch.int32), topk=4)
    r = torch.from_numpy(_arr(rng, (2, 8, 4)))
    wkv.wkv(r, r, r, -torch.ones_like(r), torch.zeros((2, 4)))
    flash.flash_attention(r, r[:1], r[:1], groups=2)
    flash.flash_attention(r.bfloat16(), r[:1].bfloat16(), r[:1].bfloat16(), groups=2)
    bm.split_tf32(a)
    assert kernels.launch_counts() == {"block_matmul": 0, "edge_projection": 0, "cad_scores": 0,
                                       "stream_gemm": 0, "stream_gemm_tc": 0,
                                       "fused_panel_matvec": 0, "panel_topk_update": 0,
                                       "wkv": 0, "flash_attention": 0,
                                       "flash_attention_wgmma": 0}


def _tf32_grid(kind: str) -> np.ndarray:
    """fp32 values of one class, from numpy seed 0, both signs."""
    rng = np.random.default_rng(0)
    if kind == "normal":
        x = rng.normal(size=4000) * np.exp2(rng.integers(-100, 100, size=4000))
    elif kind == "subnormal":
        x = rng.integers(1, 1 << 23, size=4000).astype(np.uint32).view(np.float32)
    elif kind == "zeros and powers of two":
        x = np.concatenate([[0.0], np.exp2(np.arange(-149, 128, dtype=np.float64))])
    else:  # a set rounding bit and nothing below it: the tie, and its neighbours
        base = rng.integers(0, 1 << 10, size=1000).astype(np.uint32) << 13
        exp = rng.integers(1, 254, size=1000).astype(np.uint32) << 23
        tie = exp | base | 0x1000
        x = np.concatenate([tie, tie - 1, tie + 1]).view(np.float32)
    x = x.astype(np.float32)
    return np.concatenate([x, -x])


def _tf32_rna_oracle(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64 arithmetic
    (TF32's quantum: 2^(e-11) for x = m 2^e, m in [0.5, 1); 2^-136 below 2^-126)."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)
    q = np.exp2(np.maximum(e - 11, -136).astype(np.float64))
    r = np.floor(np.abs(x64) / q + 0.5) * q
    return np.copysign(r, x64).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "subnormal", "zeros and powers of two", "ties"])
def test_split_tf32_plain_version(kind):
    """ref.split_tf32: the TF32 parts of x, on the float's bits, against a
    float64 oracle; x = hi + lo within 2^-22 |x| (half a TF32 subnormal step,
    2^-137, where lo or x fall below the normal range)."""
    x = _tf32_grid(kind)
    hi, lo = (t.numpy() for t in tref.split_tf32(torch.from_numpy(x)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any(), "13 low mantissa bits must be zero"
    want_hi = _tf32_rna_oracle(x)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    rest = x.astype(np.float64) - hi.astype(np.float64)  # exact in fp32 as well
    np.testing.assert_array_equal(lo.view(np.uint32),
                                  _tf32_rna_oracle(rest.astype(np.float32)).view(np.uint32))
    err = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    bound = np.maximum(2.0**-22 * np.abs(x.astype(np.float64)), 2.0**-137)
    assert (err <= bound).all()
    if kind == "zeros and powers of two":  # exact in TF32 down to its smallest step, 2^-136
        exact = (np.abs(x) >= 2.0**-136) | (x == 0)
        np.testing.assert_array_equal(hi[exact].view(np.uint32), x[exact].view(np.uint32))
        assert not lo[exact].any()


def test_three_tf32_products_reach_fp32_accuracy():
    """The fp32 route's arithmetic on the CPU: A_lo B_hi + A_hi B_lo + A_hi B_hi
    (each product exact in float64) is within 2^-20 of the float64 product,
    relative to sum |a||b|, where the high parts alone miss by ~2^-11."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_arr(rng, (96, 200)))
    b = torch.from_numpy(_arr(rng, (200, 64)))
    (ah, al), (bh, bl) = tref.split_tf32(a), tref.split_tf32(b)
    d = [t.double() for t in (a, b, ah, al, bh, bl)]
    exact = d[0] @ d[1]
    scale = d[0].abs() @ d[1].abs()
    three = d[3] @ d[4] + d[2] @ d[5] + d[2] @ d[4]
    assert float(((three - exact).abs() / scale).max()) <= 2.0**-20
    assert float(((d[2] @ d[4] - exact).abs() / scale).max()) > 2.0**-16


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((8, 8))
    with pytest.raises(ValueError):
        bm.block_matmul(a, torch.zeros((7, 8)))
    with pytest.raises(TypeError):
        bm.block_matmul(a, a.double())
    with pytest.raises(ValueError):
        bm.split_tf32(a.double())
    with pytest.raises(TypeError):
        ep.edge_projection(a.double(), seed=0, k=3)
    with pytest.raises(ValueError):
        cad.cad_scores(a, a, torch.zeros((8, 3)), torch.zeros((8, 4)), 1.0, 1.0)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    from repro_torch.core import detect_anomalies

    a = torch.zeros((8, 8))
    with pytest.raises(RuntimeError):
        detect_anomalies(a, a)


def test_port_imports_without_jax():
    """Every repro_torch module imports with jax and the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'repro_torch.kernels.cad_score' in mods\n"
        "assert 'repro_torch.launch.caddelag_run' in mods\n"
        "assert {'repro_torch.store.pipeline', 'repro_torch.core.oochain',\n"
        "        'repro_torch.kernels.stream_gemm'} <= set(mods)\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20

