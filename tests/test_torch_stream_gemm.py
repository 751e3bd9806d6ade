"""The plain versions of ``stream_gemm`` and ``fused_panel_matvec`` against the
Pallas kernels, run in interpret mode on the CPU as tests/test_stream_gemm.py
runs them, with that file's tolerances (allclose rtol 1e-5 / atol 1e-5; the
deflation identity at 1e-4).  The CUDA kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_gemm import fused_panel_matvec as j_fused
from repro.kernels.stream_gemm import stream_gemm as j_gemm
from repro.store.tilestore import _bf16_u16_to_f32, _f32_to_bf16_u16
from repro_torch import kernels
from repro_torch.kernels import edge_projection as ep
from repro_torch.kernels import ref
from repro_torch.kernels import stream_gemm as sg


def _rng(seed):
    return np.random.default_rng(seed)


def _bits(x: np.ndarray) -> np.ndarray:
    return _f32_to_bf16_u16(x)


def _t(x: np.ndarray) -> torch.Tensor:
    """numpy -> torch; uint16 bf16 bits travel as int16, as in the pipeline."""
    x = np.array(x)
    return torch.from_numpy(x.view(np.int16) if x.dtype == np.uint16 else x)


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert kernels.launch_counts()["stream_gemm"] == 0  # CPU tensors never launch
    kernels.reset_launch_counts()


@pytest.mark.parametrize("form", ["init+", "init-", "no_init", "no_init-", "a_bits", "b_bits",
                                  "both_bits"])
def test_stream_gemm_plain_matches_pallas(form):
    r = _rng(len(form))
    m, k, n = 48, 64, 40
    a = r.normal(size=(m, k)).astype(np.float32)
    b = r.normal(size=(k, n)).astype(np.float32)
    init = r.normal(size=(m, n)).astype(np.float32) if form.startswith("init") else None
    sign = -1.0 if form.endswith("-") else 1.0
    if form in ("a_bits", "both_bits"):
        a = _bits(a)
    if form in ("b_bits", "both_bits"):
        b = _bits(b)
    want = np.asarray(j_gemm(jnp.asarray(a), jnp.asarray(b),
                             None if init is None else jnp.asarray(init), sign=sign,
                             bm=16, bk=32, bn=8))
    got = sg.stream_gemm(_t(a), _t(b), None if init is None else _t(init), sign=sign).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_stream_gemm_out_may_be_init(sign):
    """The chain's in-place K step: ``out=init`` gives the out-of-place result."""
    r = _rng(7)
    a, b, init = (_t(r.normal(size=s).astype(np.float32)) for s in ((24, 32), (32, 40), (24, 40)))
    want = sg.stream_gemm(a, b, init, sign=sign)
    acc = init.clone()
    got = sg.stream_gemm(a, b, acc, sign=sign, out=acc)
    assert got is acc
    assert torch.equal(acc, want)
    with pytest.raises(ValueError, match="out"):
        sg.stream_gemm(a, b, init, out=torch.zeros((24, 39)))


def test_in_kernel_decode_is_bitwise_the_host_codec():
    r = _rng(5)
    a_bits = _bits(r.normal(size=(32, 64)).astype(np.float32))
    b = r.normal(size=(64, 16)).astype(np.float32)
    np.testing.assert_array_equal(ref.decode_bits(_t(a_bits)).numpy(), _bf16_u16_to_f32(a_bits))
    got = sg.stream_gemm(_t(a_bits), _t(b)).numpy()
    want = sg.stream_gemm(_t(_bf16_u16_to_f32(a_bits)), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("encoded", [False, True])
def test_fused_panel_matvec_plain_matches_pallas(encoded):
    r = _rng(6)
    ph, n, q = 32, 64, 5
    p = r.normal(size=(ph, n)).astype(np.float32)
    if encoded:
        p = _bits(p)
    y = r.normal(size=(n, q)).astype(np.float32)
    chi_p = r.normal(size=(ph, q)).astype(np.float32)
    y_p = y[:ph]
    jgy, jcs, jss = (np.asarray(x) for x in j_fused(
        jnp.asarray(p), jnp.asarray(y), jnp.asarray(chi_p), jnp.asarray(y_p), bm=16, bk=32))
    gy, cs, ss = (x.numpy() for x in sg.fused_panel_matvec(_t(p), _t(y), _t(chi_p), _t(y_p)))
    assert gy.shape == (ph, q) and cs.shape == (1, q) and ss.shape == (1, 1)
    np.testing.assert_allclose(gy, jgy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cs, jcs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ss, jss, rtol=1e-5, atol=1e-5)
    # the deflation identity the streamed solver relies on:
    #   ||delta - colmean(delta)||_F^2 = ss - sum_c cs_c^2 / n_rows
    mv = _bf16_u16_to_f32(p).astype(np.float64) if encoded else p.astype(np.float64)
    delta = chi_p - mv @ y.astype(np.float64)
    defl = ((delta - delta.mean(0, keepdims=True)) ** 2).sum()
    cs64 = cs.astype(np.float64)[0]
    np.testing.assert_allclose(float(ss[0, 0]) - (cs64 ** 2).sum() / ph, defl, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("encoded", [False, True])
def test_fused_panel_matvec_plain_matches_pallas_at_q32(encoded):
    """The widest q the card takes, at a K that neither 64 (the skinny route's
    slab) nor 256 (the Pallas default tile) divides, the Pallas kernel walking
    K in five steps."""
    r = _rng(32)
    ph, n, q = 40, 200, 32
    p = r.normal(size=(ph, n)).astype(np.float32)
    if encoded:
        p = _bits(p)
    y = r.normal(size=(n, q)).astype(np.float32)
    chi_p = r.normal(size=(ph, q)).astype(np.float32)
    y_p = y[7 : 7 + ph]
    jgy, jcs, jss = (np.asarray(x) for x in j_fused(
        jnp.asarray(p), jnp.asarray(y), jnp.asarray(chi_p), jnp.asarray(y_p), bm=8, bk=40))
    gy, cs, ss = (x.numpy() for x in sg.fused_panel_matvec(_t(p), _t(y), _t(chi_p), _t(y_p)))
    np.testing.assert_allclose(gy, jgy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cs, jcs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ss, jss, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ph,k,q,want", [
    (1314, 10512, 17, 24 * 1314 * 17 + 165 * 18),  # the streamed solve's panel: 24 k splits
    (37, 1000, 32, 16 * 37 * 32 + 5 * 33),
    (1, 5, 1, 1 * 1 * 1 + 1 * 2),
    (130, 4100, 20, 65 * 130 * 20 + 17 * 21),  # 65 one-slab splits, a ragged last block
])
def test_matvec_scratch_elems(ph, k, q, want):
    """The skinny product's split partials, then 8-row blocks' column sums and
    sums of squares."""
    assert sg.matvec_scratch_elems(ph, k, q) == want


def test_stream_wrappers_reject_bad_inputs():
    a = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="inner dims"):
        sg.stream_gemm(a, torch.zeros((7, 8)))
    with pytest.raises(TypeError):
        sg.stream_gemm(a.double(), a)
    with pytest.raises(ValueError, match="init"):
        sg.stream_gemm(a, a, torch.zeros((8, 7)))
    with pytest.raises(ValueError, match="sign"):
        sg.stream_gemm(a, a, sign=2.0)
    with pytest.raises(ValueError, match="chi/y panels"):
        sg.fused_panel_matvec(a, torch.zeros((8, 3)), torch.zeros((8, 2)), torch.zeros((8, 3)))


@pytest.mark.parametrize("row0", [0, 24, 40])
def test_edge_projection_row0_is_the_panel_of_the_whole(row0):
    """A row panel projected at its global rows equals those rows of the whole."""
    a = torch.from_numpy(np.abs(_rng(row0).normal(size=(64, 64))).astype(np.float32))
    whole = ep.edge_projection(a, seed=11, k=7)
    panel = ep.edge_projection(a[row0:row0 + 24].contiguous(), seed=11, k=7, row0=row0)
    np.testing.assert_array_equal(panel.numpy(), whole[row0:row0 + 24].numpy())


# ---------------------------------------------------------------------------
# the card's routes, as pure functions of the shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,route", [(1, "skinny"), (17, "skinny"), (32, "skinny"), (33, "tc"),
                                     (257, "tc"), (10512, "tc")])
def test_route_is_a_fixed_dispatch_on_n(n, route):
    assert sg.route_for(n) == route


@pytest.mark.parametrize("m,n,k,a_bits,b_bits,want", [
    (1314, 10512, 1314, False, False, (2 * 1314 + 2 * 10512) * 1344),  # the K step: 127 MB
    (1314, 10512, 1314, True, False, (1314 + 2 * 10512) * 1344),  # bits: no lo part
    (1314, 10512, 1314, False, True, (2 * 1314 + 10512) * 1344),
    (1314, 10512, 1314, True, True, (1314 + 10512) * 1344),
    (40, 33, 0, False, False, (2 * 40 + 2 * 33) * 32),  # k pads to one K tile, even k = 0
    (1314, 17, 10512, False, False, 24 * 1314 * 17),  # the chi build: 24 k splits
    (3, 1, 1, True, True, 1 * 3 * 1),
])
def test_scratch_elems(m, n, k, a_bits, b_bits, want):
    assert sg.scratch_elems(m, n, k, a_bits=a_bits, b_bits=b_bits) == want


@pytest.mark.parametrize("m,k", [(1314, 10512), (1, 1), (5, 0), (300, 1000), (64, 64 * 600),
                                 (10512, 10512)])
def test_skinny_plan_covers_k_once_in_whole_slabs(m, k):
    splits, per = sg.skinny_plan(m, k)
    slabs = max(-(-k // 64), 1)
    assert per >= 1 and (splits - 1) * per < slabs <= splits * per  # no empty split
    row_blocks = -(-m // 64)
    assert splits == 1 or row_blocks * (splits - 1) < 4 * 132  # no more splits than it needs
    assert sg.skinny_plan(m, k) == (splits, per)  # a function of the shapes alone


def test_stream_gemm_checks_scratch():
    a, b, init = torch.zeros((8, 40)), torch.ones((40, 48)), torch.ones((8, 48))
    need = sg.scratch_elems(8, 48, 40)
    got = sg.stream_gemm(a, b, init, scratch=torch.empty(need))  # exactly enough
    assert torch.equal(got, init)
    for bad in (torch.empty(need - 1), torch.empty(need, dtype=torch.float64),
                torch.empty(2 * need)[::2], torch.empty(need, device="meta")):
        with pytest.raises(ValueError, match="scratch"):
            sg.stream_gemm(a, b, init, scratch=bad)


def _three_tf32(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor, sign: float) -> torch.Tensor:
    """The tensor-core route's arithmetic in plain torch: A_lo B_hi + A_hi B_lo +
    A_hi B_hi over each 32-deep stage (products exact in float64, the stage's
    partial rounded to fp32), the partials added into an fp32 total, then
    init +- the total."""
    (ah, al), (bh, bl) = ref.split_tf32(a), ref.split_tf32(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for s in range(0, a.shape[1], 32):
        sl = slice(s, s + 32)
        part = (al[:, sl].double() @ bh[sl].double() + ah[:, sl].double() @ bl[sl].double()
                + ah[:, sl].double() @ bh[sl].double())
        acc = acc + part.float()
    return init - acc if sign < 0 else init + acc


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_three_tf32_k_step_is_no_farther_from_float64_than_fp32(sign):
    """The chain's K step cut to 96 rows and 64 columns, (96 x 1314) @ (1314 x 64)
    plus init, uniform [-1, 1): 3xTF32 with 32-deep partials is no farther from
    the float64 result than the fp32 plain version."""
    r = _rng(12)
    a, b, init = (_t(r.uniform(-1.0, 1.0, size=s).astype(np.float32))
                  for s in ((96, 1314), (1314, 64), (96, 64)))
    exact = init.double() + sign * (a.double() @ b.double())
    err_tc = float((_three_tf32(a, b, init, sign).double() - exact).abs().max())
    err_fp32 = float((ref.stream_gemm(a, b, init, sign=sign).double() - exact).abs().max())
    assert err_tc <= err_fp32, (err_tc, err_fp32)
