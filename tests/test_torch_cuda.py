"""On-card tests of the port's CUDA kernels (``cuda`` marker; skip without a card).

This file imports neither JAX nor the JAX package, so it runs on the card's
machine too:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
inputs; tolerances are tests/test_kernels.py's, and for outputs stored in
bf16 two bf16 steps (2^-7) of the largest plain value, since kernel and
plain version round their fp32 sums to bf16 independently.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import cad_score as cad
from repro_torch.kernels import edge_projection as ep
from repro_torch.kernels import emb_query as eq
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref
from repro_torch.kernels import stream_gemm as sg
from repro_torch.kernels import wkv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from repro_torch import resolve_device

    kernels.reset_launch_counts()
    return resolve_device("cuda")


def _arr(rng, shape, dev, positive=False):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(np.abs(x) if positive else x).to(dev)


# shapes whose row strides break TMA's 16-byte rule or that end inside a tile,
# and k < 8 (one k step of the tensor cores)
_BM_SHAPES = [(1, 1, 1), (7, 5, 9), (40, 3, 50), (129, 130, 131), (300, 77, 170),
              (1000, 777, 1030)]


@pytest.mark.parametrize("m,k,n", _BM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_matmul_kernel(dev, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a, b = _arr(rng, (m, k), dev).to(dtype), _arr(rng, (k, n), dev).to(dtype)
    got = bm.block_matmul(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, ref.block_matmul(a, b, out_dtype=torch.float32),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(got, bm.block_matmul(a, b, out_dtype=torch.float32))
    assert kernels.launch_counts()["block_matmul"] == 2


@pytest.mark.parametrize("n", [1, 7, 129, 300, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_matmul_kernel_b_is_a(dev, n, dtype):
    """The chain's T T: one split pass writes both layouts; the same bits as two."""
    a = _arr(np.random.default_rng(n), (n, n), dev).to(dtype)
    got = bm.block_matmul(a, a, out_dtype=torch.float32)
    torch.testing.assert_close(got, ref.block_matmul(a, a, out_dtype=torch.float32),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(got, bm.block_matmul(a, a.clone(), out_dtype=torch.float32))
    assert kernels.launch_counts()["block_matmul"] == 2


def _tf32_cases(dev):
    """Normal values over a wide range, subnormals, +-0, powers of two and the
    rounding ties of TF32 (bit 12 set, nothing below), numpy seed 0."""
    rng = np.random.default_rng(0)
    normal = (rng.normal(size=4096) * np.exp2(rng.integers(-100, 100, size=4096))).astype(np.float32)
    sub = rng.integers(1, 1 << 23, size=1024).astype(np.uint32).view(np.float32)
    pw = np.exp2(np.arange(-149, 128, dtype=np.float64)).astype(np.float32)
    tie = ((rng.integers(1, 254, size=1024).astype(np.uint32) << 23)
           | (rng.integers(0, 1 << 10, size=1024).astype(np.uint32) << 13) | 0x1000)
    x = np.concatenate([normal, sub, pw, [0.0], tie.view(np.float32)]).astype(np.float32)
    x = np.concatenate([x, -x])
    x = np.resize(x, (x.size // 97 + 1) * 97).reshape(-1, 97)  # a ragged width
    return torch.from_numpy(x).to(dev)


def test_split_tf32_kernel_is_bitwise_the_plain_version(dev):
    x = _tf32_cases(dev)
    hi, lo = bm.split_tf32(x)
    want_hi, want_lo = ref.split_tf32(x)
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))
    assert kernels.launch_counts()["block_matmul"] == 0  # the check pass is not a GEMM


def test_block_matmul_float64_accuracy(dev):
    """n=2048, uniform [-1, 1): max |C - float64 product| no worse than twice
    torch.matmul's in fp32 (TF32 off)."""
    g = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.rand((2048, 2048), generator=g, device=dev) * 2 - 1 for _ in range(2))
    exact = a.double() @ b.double()
    err_kernel = float((bm.block_matmul(a, b).double() - exact).abs().max())
    err_torch = float((torch.matmul(a, b).double() - exact).abs().max())
    assert err_kernel <= 2.0 * err_torch, (err_kernel, err_torch)


@pytest.mark.parametrize("n,k", [(257, 17), (100, 40)])
def test_edge_projection_kernel(dev, n, k):
    a = _arr(np.random.default_rng(n), (n, n), dev, positive=True)
    torch.testing.assert_close(ep.edge_projection(a, seed=7, k=k),
                               ref.edge_projection(a, seed=7, k=k), rtol=1e-5, atol=1e-4)
    assert kernels.launch_counts()["edge_projection"] == 1


def test_in_kernel_rademacher_field_is_bitwise(dev):
    from repro_torch.core import rng

    for seed in (0, 2**31, 2**32 - 1):
        q = ep.rademacher_field(seed, range(90, 130), range(100, 140), 17)
        want = rng.edge_rademacher(
            seed, torch.arange(90, 130, device=dev)[:, None, None],
            torch.arange(100, 140, device=dev)[None, :, None],
            torch.arange(17, device=dev)[None, None, :])
        assert torch.equal(q, want)


@pytest.mark.parametrize("n,k", [(200, 17), (97, 33)])
def test_cad_scores_kernel(dev, n, k):
    rng = np.random.default_rng(n)
    a1, a2 = _arr(rng, (n, n), dev, positive=True), _arr(rng, (n, n), dev, positive=True)
    z1, z2 = _arr(rng, (n, k), dev), _arr(rng, (n, k), dev)
    got = cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5)
    torch.testing.assert_close(got, ref.cad_scores(a1, a2, z1, z2, 10.0, 12.5),
                               rtol=1e-4, atol=1e-2)
    assert torch.equal(got, cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5))


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    a = torch.zeros((64, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        bm.block_matmul(a.T, a)
    z = torch.zeros((64, 65), device=dev)
    with pytest.raises(ValueError, match="k=65"):
        cad.cad_scores(a, a, z, z, 1.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sg.stream_gemm(a.T, a)
    with pytest.raises(ValueError, match="q=40"):
        sg.fused_panel_matvec(a, torch.zeros((64, 40), device=dev),
                              torch.zeros((64, 40), device=dev), torch.zeros((64, 40), device=dev))
    assert set(kernels.launch_counts().values()) == {0}


def test_sequence_on_card_matches_cpu(dev):
    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import gmm_snapshot_sequence

    cfg = CommuteConfig(d=6, q=10)
    runs = {}
    for d in ("cuda", "cpu"):
        seq = gmm_snapshot_sequence(256, 3, seed=4, inject_p=0.02, device=d)
        runs[d] = SequenceDetector(cfg, top_k=10, device=d).run(seq.snapshots())
    assert kernels.launch_counts() == {"block_matmul": 33, "edge_projection": 3, "cad_scores": 2,
                                       "stream_gemm": 0, "stream_gemm_tc": 0,
                                       "fused_panel_matvec": 0, "panel_topk_update": 0,
                                       "wkv": 0, "flash_attention": 0,
                                       "flash_attention_wgmma": 0}
    for g, c in zip(runs["cuda"].transitions, runs["cpu"].transitions):
        s_c = c.scores.numpy()
        np.testing.assert_allclose(g.scores.cpu().numpy(), s_c, rtol=1e-3,
                                   atol=1e-3 * np.abs(s_c).max())
        assert g.top_idx.tolist() == c.top_idx.tolist()


def _bits(x: torch.Tensor) -> torch.Tensor:
    """bf16 bits of x (round to nearest even) as int16, as the store ships them."""
    from repro_torch.store.tilestore import _f32_to_bf16_u16

    return torch.from_numpy(_f32_to_bf16_u16(x.cpu().numpy()).view(np.int16)).to(x.device)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (130, 129, 257), (300, 1000, 17)])
@pytest.mark.parametrize("form", ["init+", "init-", "no_init", "a_bits", "b_bits"])
def test_stream_gemm_kernel(dev, m, k, n, form):
    rng = np.random.default_rng(m + k + n)
    a, b = _arr(rng, (m, k), dev), _arr(rng, (k, n), dev)
    init = _arr(rng, (m, n), dev) if form.startswith("init") else None
    sign = -1.0 if form == "init-" else 1.0
    if form == "a_bits":
        a = _bits(a)
    if form == "b_bits":
        b = _bits(b)
    got = sg.stream_gemm(a, b, init, sign=sign)
    torch.testing.assert_close(got, ref.stream_gemm(a, b, init, sign=sign), rtol=1e-5, atol=1e-4)
    assert torch.equal(got, sg.stream_gemm(a, b, init, sign=sign))
    if form.endswith("bits"):  # the in-kernel decode is the host codec's widening
        decoded = sg.stream_gemm(ref.decode_bits(a), ref.decode_bits(b), init, sign=sign)
        assert torch.equal(got, decoded)
    assert kernels.launch_counts()["stream_gemm"] == (3 if form.endswith("bits") else 2)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_stream_gemm_kernel_in_place(dev, sign):
    rng = np.random.default_rng(11)
    a, b, init = _arr(rng, (130, 129), dev), _arr(rng, (129, 257), dev), _arr(rng, (130, 257), dev)
    want = sg.stream_gemm(a, b, init, sign=sign)
    acc = init.clone()
    assert sg.stream_gemm(a, b, acc, sign=sign, out=acc) is acc
    assert torch.equal(acc, want)


@pytest.mark.parametrize("m", [3, 130])
@pytest.mark.parametrize("k", [1, 129, 1314])
@pytest.mark.parametrize("n", [1, 17, 32, 33, 257])
@pytest.mark.parametrize("form", ["init+", "init-", "no_init", "a_bits", "b_bits", "both_bits"])
def test_stream_gemm_routes(dev, m, k, n, form):
    """Both routes (skinny n <= 32, tensor cores n > 32) at ragged m against the
    plain version (phase 2's tolerance, 2e-5 of the largest value), bitwise
    repeatable, bits bitwise the kernel on host-decoded fp32, in place (out =
    init, with the caller's scratch) bitwise the out-of-place launch, and the
    tensor-core route without init bitwise block_matmul's fp32 product."""
    rng = np.random.default_rng(m + k + n)
    a, b = _arr(rng, (m, k), dev), _arr(rng, (k, n), dev)
    init = _arr(rng, (m, n), dev) if form.startswith("init") or form == "both_bits" else None
    sign = -1.0 if form == "init-" else 1.0
    if form in ("a_bits", "both_bits"):
        a = _bits(a)
    if form in ("b_bits", "both_bits"):
        b = _bits(b)
    got = sg.stream_gemm(a, b, init, sign=sign)
    _rel_close(got, ref.stream_gemm(a, b, init, sign=sign), 2e-5)
    assert torch.equal(got, sg.stream_gemm(a, b, init, sign=sign))
    if form.endswith("bits"):
        assert torch.equal(got, sg.stream_gemm(ref.decode_bits(a), ref.decode_bits(b), init,
                                               sign=sign))
    if init is not None:
        acc = init.clone()
        scratch = torch.empty(sg.scratch_elems(m, n, k) + 7, device=dev)  # oversized, fp32-sized
        assert sg.stream_gemm(a, b, acc, sign=sign, out=acc, scratch=scratch) is acc
        assert torch.equal(acc, got)
    if form == "no_init" and n > 32:
        assert torch.equal(got, bm.block_matmul(a, b))
    counts = kernels.launch_counts()
    assert counts["stream_gemm"] > 0
    assert counts["stream_gemm_tc"] == (counts["stream_gemm"] if n > 32 else 0)


def test_cad_scores_kernel_on_a_panel(dev):
    """A row panel scored against the whole Z (z_i a row slice), as the
    streamed scorer calls it: close to the plain version, and bitwise the
    same rows of the square call."""
    rng = np.random.default_rng(5)
    n, k = 300, 17
    a1, a2 = _arr(rng, (n, n), dev, positive=True), _arr(rng, (n, n), dev, positive=True)
    z1, z2 = _arr(rng, (n, k), dev), _arr(rng, (n, k), dev)
    rs = slice(120, 195)
    args = (a1[rs], a2[rs], z1[rs], z1, z2[rs], z2, 10.0, 12.5)
    got = cad.cad_scores_tile(*args)
    torch.testing.assert_close(got, ref.cad_scores_tile(*args), rtol=1e-4, atol=1e-2)
    assert torch.equal(got, cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5)[rs])


@pytest.mark.parametrize("ph,k,q", [(1, 5, 1), (37, 300, 17), (200, 1000, 32)])
@pytest.mark.parametrize("bits", [False, True])
def test_fused_panel_matvec_kernel(dev, ph, k, q, bits):
    rng = np.random.default_rng(ph + k + q)
    p, y = _arr(rng, (ph, k), dev), _arr(rng, (k, q), dev)
    chi, yp = _arr(rng, (ph, q), dev), _arr(rng, (ph, q), dev)
    if bits:
        p = _bits(p)
    got = sg.fused_panel_matvec(p, y, chi, yp)
    want = ref.fused_panel_matvec(p, y, chi, yp)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    for g, again in zip(got, sg.fused_panel_matvec(p, y, chi, yp)):
        assert torch.equal(g, again)
    if bits:
        for g, dec in zip(got, sg.fused_panel_matvec(ref.decode_bits(p), y, chi, yp)):
            assert torch.equal(g, dec)
    assert kernels.launch_counts()["fused_panel_matvec"] == (3 if bits else 2)


@pytest.mark.parametrize("ph,k", [(37, 1000), (1314, 777), (64, 1003), (130, 64)])
@pytest.mark.parametrize("q", [1, 8, 17, 20, 32])
@pytest.mark.parametrize("bits", [False, True])
def test_fused_panel_matvec_gy_is_the_skinny_stream_gemm(dev, ph, k, q, bits):
    """P y on the skinny route with the fused finish, at shapes across the plan's
    edges (K not a multiple of 64, a bits K not a multiple of 8 -- the scalar
    load path --, ph not a multiple of 64): gy bitwise ``stream_gemm(P, y, chi +
    y_panel, sign=-1)``, with chi and y_panel row slices of larger tensors as
    the streamed solve passes them; the caller's scratch gives the same bits."""
    rng = np.random.default_rng(ph + k + q)
    p, y = _arr(rng, (ph, k), dev), _arr(rng, (k, q), dev)
    chi_all, yp_all = _arr(rng, (ph + 9, q), dev), _arr(rng, (ph + 9, q), dev)
    chi, yp = chi_all[5 : 5 + ph], yp_all[3 : 3 + ph]
    if bits:
        p = _bits(p)
    got = sg.fused_panel_matvec(p, y, chi, yp)
    assert torch.equal(got[0], sg.stream_gemm(p, y, chi + yp, sign=-1.0))
    _rel_close(got[0], ref.fused_panel_matvec(p, y, chi, yp)[0], 1e-4)
    # the reductions against float64, to 1e-4 of the summed magnitudes
    d64 = chi.double() - ref.decode_bits(p).double() @ y.double()
    cs_err = (got[1].double() - d64.sum(0, keepdim=True)).abs()
    assert (cs_err <= 1e-4 * d64.abs().sum(0, keepdim=True)).all()
    ss64 = float((d64 * d64).sum())
    assert abs(float(got[2]) - ss64) <= 1e-4 * ss64
    for g, again in zip(got, sg.fused_panel_matvec(p, y, chi, yp)):
        assert torch.equal(g, again)
    counts = kernels.launch_counts()
    assert counts["fused_panel_matvec"] == 2 and counts["stream_gemm"] == 1


def test_edge_projection_kernel_at_row0(dev):
    a = _arr(np.random.default_rng(3), (300, 300), dev, positive=True)
    panel = a[120:180].contiguous()
    torch.testing.assert_close(ep.edge_projection(panel, seed=5, k=17, row0=120),
                               ref.edge_projection(panel, seed=5, k=17, row0=120),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ep.edge_projection(panel, seed=5, k=17, row0=120),
                               ep.edge_projection(a, seed=5, k=17)[120:180],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [257, 130])
@pytest.mark.parametrize("k", [17, 33, 40])
def test_edge_projection_kernel_tiles_and_panels(dev, n, k):
    """A non-symmetric A (numpy seed, signed, so max(A, 0) clips too): the
    kernel, which hashes each unordered pair once, close to the plain
    version; row panels at row0 0, 63, 120 and one across the 64-column tile
    edge at 128 bitwise the same rows of the resident call (k > 32 takes two
    mask words)."""
    rng = np.random.default_rng(100 * n + k)
    a = _arr(rng, (n, n), dev)
    assert not torch.equal(a, a.T)
    whole = ep.edge_projection(a, seed=11, k=k)
    torch.testing.assert_close(whole, ref.edge_projection(a, seed=11, k=k), rtol=1e-5, atol=1e-4)
    for r0, h in ((0, 40), (63, 30), (120, 10), (100, 60)):
        h = min(h, n - r0)
        panel = a[r0 : r0 + h].contiguous()
        assert torch.equal(ep.edge_projection(panel, seed=11, k=k, row0=r0), whole[r0 : r0 + h])
    assert kernels.launch_counts()["edge_projection"] == 5


@pytest.mark.parametrize("n", [97, 300, 1100])
@pytest.mark.parametrize("k", [17, 33, 64])
def test_cad_scores_kernel_chunks_and_panels(dev, n, k):
    """Close to the plain version at n across the 1024-column chunk (1100)
    and rows not 16-byte aligned (97); row panels scored against the whole Z
    -- one at row0=1, whose z_i slice starts 4k bytes in (not 16-byte aligned
    for k=17, 33) -- close to the plain version and bitwise the same rows of
    the square call."""
    rng = np.random.default_rng(n + k)
    a1, a2 = _arr(rng, (n, n), dev, positive=True), _arr(rng, (n, n), dev, positive=True)
    z1, z2 = _arr(rng, (n, k), dev), _arr(rng, (n, k), dev)
    whole = cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5)
    torch.testing.assert_close(whole, ref.cad_scores(a1, a2, z1, z2, 10.0, 12.5),
                               rtol=1e-4, atol=1e-2)
    for r0, h in ((0, 40), (1, 33), (n // 2, n - n // 2)):
        rs = slice(r0, r0 + h)
        args = (a1[rs], a2[rs], z1[rs], z1, z2[rs], z2, 10.0, 12.5)
        got = cad.cad_scores_tile(*args)
        torch.testing.assert_close(got, ref.cad_scores_tile(*args), rtol=1e-4, atol=1e-2)
        assert torch.equal(got, whole[rs])
    assert kernels.launch_counts()["cad_scores"] == 4


def test_cad_scores_kernel_misaligned_adjacency(dev):
    """n % 4 == 0 but A1 starts 4 bytes past a 16-byte boundary: the kernel
    takes its 4-byte load path and gives the bits of the 16-byte path."""
    rng = np.random.default_rng(9)
    n, k = 300, 17
    a1, a2 = _arr(rng, (n, n), dev, positive=True), _arr(rng, (n, n), dev, positive=True)
    z1, z2 = _arr(rng, (n, k), dev), _arr(rng, (n, k), dev)
    buf = torch.empty((n * n + 1,), device=dev)
    shifted = buf[1:].view(n, n)
    shifted.copy_(a1)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    assert torch.equal(cad.cad_scores(shifted, a2, z1, z2, 10.0, 12.5),
                       cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5))


def test_pipeline_stages_through_pinned_memory(dev):
    from repro_torch.core.tiles import StreamStats
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.store import PanelPipeline, TileStore

    n = 256
    a = np.random.default_rng(0).random((n, n), dtype=np.float32)
    for codec in ("raw", "bf16"):
        h = TileStore.create(None, n=n, grid=4, codec=codec).put_snapshot("a", a)
        st = StreamStats(MetricsRegistry())
        with PanelPipeline([h], range(0, n, 64), 64, device=dev, stats=st, encoded=True) as pipe:
            for r0, (p,) in pipe:
                assert p.is_cuda and p.dtype == (torch.int16 if codec == "bf16" else torch.float32)
                want = h.read_panel(r0, 64)
                np.testing.assert_array_equal(ref.decode_bits(p).cpu().numpy(), want)
        assert st.panels == 4 and (st.bytes_h2d_saved > 0) == (codec == "bf16")


def test_oocore_sequence_on_card_matches_cpu(dev):
    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import gmm_snapshot_sequence, store_snapshot_sequence
    from repro_torch.store import TileStore

    runs = {}
    for d in ("cuda", "cpu"):
        store = TileStore.create(None, n=256, grid=8, codec="bf16")
        ids = store_snapshot_sequence(store, gmm_snapshot_sequence(256, 3, seed=4, inject_p=0.02,
                                                                   device=d))
        cfg = CommuteConfig(d=6, q=10, oocore=True, tile_codec="bf16", use_gemm_kernel=True)
        kernels.reset_launch_counts()
        runs[d] = SequenceDetector(cfg, top_k=10, device=d).run(store.snapshot(i) for i in ids)
        if d == "cuda":
            counts = kernels.launch_counts()
    # scratch grid 8 (32-row panels): 3 x (11 GEMMs x 8 x 8 K steps + 8 chi panels)
    assert counts["stream_gemm"] == 3 * (11 * 64 + 8) and counts["block_matmul"] == 0
    its = sum(r.iterations for t in runs["cuda"].transitions for r in t.solve_reports[1:])
    its += runs["cuda"].transitions[0].solve_reports[0].iterations
    assert counts["fused_panel_matvec"] == 8 * its
    assert counts["edge_projection"] == 3 * 8 and counts["cad_scores"] == 2 * 8
    for g, c in zip(runs["cuda"].transitions, runs["cpu"].transitions):
        s_c = c.scores.numpy()
        np.testing.assert_allclose(g.scores.cpu().numpy(), s_c, rtol=1e-3,
                                   atol=1e-3 * np.abs(s_c).max())
        assert g.top_idx.tolist() == c.top_idx.tolist()


def _topk_case(dev, rng, q, ph, k, topk, largest, bits, seeded=True):
    zq, zp = _arr(rng, (q, k), dev), _arr(rng, (ph, k), dev)
    zp[ph // 2] = zp[1]  # an exact tie inside the panel
    if bits:
        zp = _bits(zp)
    idq = _arr(rng, (q, 1), dev, positive=True) + 0.1
    idp = _arr(rng, (1, ph), dev, positive=True) + 0.1
    ex = torch.full((q, 1), -1, dtype=torch.int32, device=dev)
    ex[0, 0] = 1000 + 3  # a global id inside the panel
    vals, ids = eq.topk_init(q, topk, largest=largest, device=dev)
    if seeded:  # a running state from an earlier panel, through the plain version
        vals, ids = ref.panel_topk_update(vals, ids, zq, _arr(rng, (ph, k), dev), idq, idp,
                                          2.5, 0, ex, topk=topk, largest=largest)
    return vals.contiguous(), ids.contiguous(), zq, zp, idq, idp, ex


@pytest.mark.parametrize("q,ph,k,topk", [(1, 144, 17, 20), (1, 144, 17, 300), (3, 128, 20, 20),
                                         (2, 7, 5, 40), (1, 256, 64, 256)])
@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("bits", [False, True], ids=["fp32", "bf16bits"])
def test_panel_topk_update_kernel(dev, q, ph, k, topk, corrected, largest, bits):
    rng = np.random.default_rng(q + ph + k + topk)
    vals, ids, zq, zp, idq, idp, ex = _topk_case(dev, rng, q, ph, k, topk, largest, bits)
    args = (vals, ids, zq, zp, idq, idp, 2.5, 1000, ex)
    kw = dict(topk=topk, corrected=corrected, largest=largest)
    got_v, got_i = eq.panel_topk_update(*args, **kw)
    want_v, want_i = ref.panel_topk_update(*args, **kw)
    finite = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(got_v), finite)
    tol = 1e-5 * float(want_v[finite].abs().max())
    assert float((got_v[finite] - want_v[finite]).abs().max()) <= tol
    # ids equal, except two candidates whose fp32 scores tie within the
    # tolerance may trade places (the kernel and torch sum over k in other orders)
    swaps = (got_i != want_i).nonzero().tolist()
    assert all(abs(float(got_v[r, c] - want_v[r, c])) <= tol for r, c in swaps)
    for r in range(q):
        cut = float(want_v[r][finite[r]][-1])
        odd = set(got_i[r].tolist()) ^ set(want_i[r].tolist())
        values = dict(zip(got_i[r].tolist() + want_i[r].tolist(),
                          got_v[r].tolist() + want_v[r].tolist()))
        assert all(abs(values[i] - cut) <= tol for i in odd)  # only ties at the cut
    again_v, again_i = eq.panel_topk_update(*args, **kw)
    assert torch.equal(again_v, got_v) and torch.equal(again_i, got_i)
    for row in got_i.tolist():  # no id twice, whatever topk
        real = [i for i in row if i >= 0]
        assert len(real) == len(set(real))
    assert 1003 not in got_i[0].tolist() or not torch.isfinite(got_v[0]).all()
    assert kernels.launch_counts()["panel_topk_update"] == 2


@pytest.mark.parametrize("topk", [1, 20, 32, 33, 300])
@pytest.mark.parametrize("ph", [7, 128, 144, 300])
@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("bits", [False, True], ids=["fp32", "bf16bits"])
def test_panel_topk_merger_kernel(dev, topk, ph, corrected, largest, bits):
    """One PanelTopk merge from a running state against the plain version, as
    test_panel_topk_update_kernel holds the one-panel call."""
    rng = np.random.default_rng(topk + ph)
    vals, ids, zq, zp, idq, idp, ex = _topk_case(dev, rng, 2, ph, 17, topk, largest, bits)
    kw = dict(topk=topk, corrected=corrected, largest=largest)
    merger = eq.PanelTopk(zq, idq, idp, ex, 2.5, panel_rows=ph, inv_deg_row0=1000,
                          state=(vals, ids), **kw)
    merger.update(zp, 1000)
    got_v, got_i = merger.result()
    want_v, want_i = ref.panel_topk_update(vals, ids, zq, zp, idq, idp, 2.5, 1000, ex, **kw)
    finite = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(got_v), finite)
    tol = 1e-5 * float(want_v[finite].abs().max())
    assert float((got_v[finite] - want_v[finite]).abs().max()) <= tol
    swaps = (got_i != want_i).nonzero().tolist()
    assert all(abs(float(got_v[r, c] - want_v[r, c])) <= tol for r, c in swaps)
    for row in got_i.tolist():
        real = [i for i in row if i >= 0]
        assert len(real) == len(set(real))
    assert kernels.launch_counts()["panel_topk_update"] == 1


@pytest.mark.parametrize("topk", [20, 300])
@pytest.mark.parametrize("bits", [False, True], ids=["fp32", "bf16bits"])
def test_panel_merger_on_card_equals_per_panel_calls(dev, topk, bits):
    """Nine panels through one PanelTopk (two state buffers in turn) bitwise a
    chain of one-panel calls; the caller's state is left as it was."""
    rng = np.random.default_rng(topk)
    zq, inv = _arr(rng, (2, 17), dev), _arr(rng, (1, 9 * 144), dev, positive=True) + 0.1
    z = _arr(rng, (9 * 144, 17), dev)
    zs = _bits(z) if bits else z
    idq = _arr(rng, (2, 1), dev, positive=True)
    ex = torch.tensor([[150], [-1]], dtype=torch.int32, device=dev)
    kw = dict(topk=topk, corrected=False, largest=True)
    state = eq.topk_init(2, topk, largest=True, device=dev)
    seed = tuple(t.clone() for t in state)
    merger = eq.PanelTopk(zq, idq, inv, ex, 3.0, panel_rows=144, state=state, **kw)
    chain = state
    for r0 in range(0, 9 * 144, 144):
        merger.update(zs[r0 : r0 + 144], r0)
        chain = eq.panel_topk_update(*chain, zq, zs[r0 : r0 + 144], idq, inv[:, r0 : r0 + 144],
                                     3.0, r0, ex, **kw)
    got = merger.result()
    assert torch.equal(got[0], chain[0]) and torch.equal(got[1], chain[1])
    assert torch.equal(state[0], seed[0]) and torch.equal(state[1], seed[1])
    assert 150 not in got[1][0].tolist()
    assert kernels.launch_counts()["panel_topk_update"] == 18


def test_panel_topk_update_kernel_refuses_what_it_cannot_take(dev):
    vals, ids = eq.topk_init(1, 8000, largest=True, device=dev)
    zq, zp = torch.zeros((1, 4), device=dev), torch.zeros((300, 4), device=dev)
    idq, idp = torch.zeros((1, 1), device=dev), torch.zeros((1, 300), device=dev)
    ex = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most"):
        eq.panel_topk_update(vals, ids, zq, zp, idq, idp, 1.0, 0, ex, topk=8000)
    with pytest.raises(ValueError, match="contiguous"):
        eq.panel_topk_update(vals[:, :4], ids[:, :4], zq, torch.zeros((4, 300), device=dev).T,
                             idq, idp, 1.0, 0, ex, topk=4)
    assert kernels.launch_counts()["panel_topk_update"] == 0


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_queries_on_card_match_cpu(dev, codec):
    from repro_torch.core import nearest_neighbors, top_anomalies_from_store
    from repro_torch.store import EmbeddingStore

    rng = np.random.default_rng(2)
    n, k = 1536, 17
    store = EmbeddingStore.create(None, n=n, k=k, codec=codec)
    store.put_embedding("t0000", rng.normal(size=(n, k)).astype(np.float32), 321.5,
                        rng.uniform(0.5, 2.0, n).astype(np.float32))
    for topk in (20, 300):
        for corrected in (False, True):
            g = top_anomalies_from_store(store, topk, corrected=corrected, device="cuda")
            c = top_anomalies_from_store(store, topk, corrected=corrected, device="cpu")
            assert g.idx.tolist() == c.idx.tolist()
            np.testing.assert_allclose(g.val, c.val, rtol=1e-5)
    g = nearest_neighbors(store, 0, 20, device="cuda")
    c = nearest_neighbors(store, 0, 20, device="cpu")
    assert g.idx.tolist() == c.idx.tolist() and 0 not in g.idx
    assert kernels.launch_counts()["panel_topk_update"] == 5 * (n // store.panel_rows)


def _rel_close(got, want, tol):
    """max |got - want| <= tol x max |want| (fp32 comparison)."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol:g} x {scale:.3e}"


def _wkv_args(dev, bh, s, dk, dv, dtype, decay=(0.5, 1.0), seed=0):
    rng = np.random.default_rng(seed)
    r, k = _arr(rng, (bh, s, dk), dev), _arr(rng, (bh, s, dk), dev)
    v = _arr(rng, (bh, s, dv), dev)
    lw = -torch.exp(_arr(rng, (bh, s, dk), dev) * decay[0] - decay[1])
    u = 0.1 * _arr(rng, (bh, dk), dev)
    s0 = _arr(rng, (bh, dk, dv), dev)
    return r.to(dtype), k.to(dtype), v.to(dtype), lw, u, s0


@pytest.mark.parametrize("bh,s,dk,dv", [(3, 1, 16, 16), (5, 31, 64, 64), (4, 100, 64, 64),
                                        (2, 65, 8, 12), (160, 64, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel(dev, bh, s, dk, dv, dtype):
    r, k, v, lw, u, s0 = _wkv_args(dev, bh, s, dk, dv, dtype, seed=bh + s)
    for init in (None, s0):
        y, st = wkv.wkv(r, k, v, lw, u, s0=init, return_state=True)
        wy, wst = ref.wkv(r, k, v, lw, u, s0=init, return_state=True)
        assert y.dtype == dtype and st.dtype == torch.float32
        _rel_close(y, wy, 1e-4 if dtype == torch.float32 else 2.0**-7)
        _rel_close(st, wst, 1e-4)
        y2, st2 = wkv.wkv(r, k, v, lw, u, s0=init, return_state=True)
        assert torch.equal(y, y2) and torch.equal(st, st2)
    assert torch.equal(wkv.wkv(r, k, v, lw, u), wkv.wkv(r, k, v, lw, u, return_state=True)[0])
    assert kernels.launch_counts()["wkv"] == 6


@pytest.mark.parametrize("s", [1, 31, 32, 33, 65, 1000, 2048])
@pytest.mark.parametrize("dk,dv", [(64, 64), (5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_across_chunk_edges(dev, s, dk, dv, dtype):
    """The chunk-parallel scan at one chunk (S <= 64), at several, and at
    ragged ends, at rwkv6-3b's heads and at odd widths (the scalar load
    path), with and without s0: the plain version's tolerances, bitwise
    repeatable, one launch counted per call."""
    r, k, v, lw, u, s0 = _wkv_args(dev, 3, s, dk, dv, dtype, decay=(0.5, 3.0), seed=s + dk)
    for init in (None, s0):
        y, st = wkv.wkv(r, k, v, lw, u, s0=init, return_state=True)
        wy, wst = ref.wkv(r, k, v, lw, u, s0=init, return_state=True)
        _rel_close(y, wy, 1e-4 if dtype == torch.float32 else 2.0**-7)
        _rel_close(st, wst, 1e-4)
        y2, st2 = wkv.wkv(r, k, v, lw, u, s0=init, return_state=True)
        assert torch.equal(y, y2) and torch.equal(st, st2)
    assert kernels.launch_counts()["wkv"] == 4


@pytest.mark.parametrize("s", [64, 96, 128, 1000])
def test_wkv_kernel_at_strong_decay_matches_the_oracle(dev, s):
    """tests/test_kernels.py::test_wkv_kernel's decays (lw = -exp(0.5 N - 1)), 1e-3."""
    r, k, v, lw, u, _ = _wkv_args(dev, 3, s, 16, 16, torch.float32, seed=s)
    torch.testing.assert_close(wkv.wkv(r, k, v, lw, u), ref.wkv(r, k, v, lw, u),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bhkv,groups,s,t,d", [(2, 1, 64, 64, 64), (2, 3, 100, 100, 128),
                                               (3, 2, 1, 1, 16), (1, 6, 130, 130, 128),
                                               (2, 2, 70, 33, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, bhkv, groups, s, t, d, causal, dtype):
    rng = np.random.default_rng(s + t + d)
    q = _arr(rng, (bhkv * groups, s, d), dev).to(dtype)
    k, v = _arr(rng, (bhkv, t, d), dev).to(dtype), _arr(rng, (bhkv, t, d), dev).to(dtype)
    got = flash.flash_attention(q, k, v, causal=causal, groups=groups)
    want = ref.flash_attention(q, k, v, causal=causal, groups=groups)
    assert got.dtype == dtype
    _rel_close(got, want, 1e-4 if dtype == torch.float32 else 2.0**-7)
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal, groups=groups))
    assert kernels.launch_counts()["flash_attention"] == 2
    tc = dtype == torch.bfloat16 and d in flash.WGMMA_DIMS
    assert kernels.launch_counts()["flash_attention_wgmma"] == (2 if tc else 0)


@pytest.mark.parametrize("s,t", [(1, 1), (63, 63), (65, 65), (1000, 1000), (1, 70), (63, 200),
                                 (65, 17), (1000, 333)])
@pytest.mark.parametrize("groups", [1, 6])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_wgmma_route(dev, s, t, groups, causal, d):
    """The tensor-core route (bf16, D in {64, 128}) against the plain version:
    ragged S and T (zero-filled TMA tiles), T != S, GQA, causal or not."""
    rng = np.random.default_rng(s * 7 + t + d + groups)
    q = _arr(rng, (2 * groups, s, d), dev).to(torch.bfloat16)
    k, v = (_arr(rng, (2, t, d), dev).to(torch.bfloat16) for _ in range(2))
    got = flash.flash_attention(q, k, v, causal=causal, groups=groups)
    _rel_close(got, ref.flash_attention(q, k, v, causal=causal, groups=groups), 2.0**-7)
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal, groups=groups))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_wgmma"] == 2


def test_lm_kernels_refuse_what_they_cannot_take(dev):
    r = torch.zeros((2, 8, 65), device=dev)
    with pytest.raises(ValueError, match="dk=65"):
        wkv.wkv(r, r, r, r, torch.zeros((2, 65), device=dev))
    r = torch.zeros((2, 8, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv(r.transpose(0, 1).contiguous().transpose(0, 1), r, r, r,
                torch.zeros((2, 16), device=dev))
    with pytest.raises(TypeError):
        wkv.wkv(r.half(), r.half(), r.half(), r, torch.zeros((2, 16), device=dev))
    q = torch.zeros((4, 8, 129), device=dev)
    with pytest.raises(ValueError, match="d=129"):
        flash.flash_attention(q, q, q)
    q = torch.zeros((4, 8, 32), device=dev)
    with pytest.raises(ValueError, match="groups"):
        flash.flash_attention(q, q[:3], q[:3], groups=2)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    qb = torch.zeros((4 * 8 * 64 + 1,), dtype=torch.bfloat16, device=dev)[1:].view(4, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_attention(qb, qb, qb)
    assert kernels.launch_counts()["wkv"] == 0
    assert kernels.launch_counts()["flash_attention"] == 0
    assert kernels.launch_counts()["flash_attention_wgmma"] == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_smoke_models_on_card_match_cpu(dev, arch):
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    spec = lm.build_spec(configs.get_smoke(arch))  # fp32 params and compute
    params = lm.init_params(spec, seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, spec.cfg.vocab, size=(3, 37)).astype(np.int32)
    out = {}
    for d in ("cuda", "cpu"):
        eng = ServeEngine(spec, params, s_max=48, cfg=ServeConfig(max_new_tokens=8), device=d)
        out[d] = eng.generate(prompts)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    counts = kernels.launch_counts()
    want = spec.cfg.n_layers
    assert counts["flash_attention" if arch == "qwen2-1.5b" else "wkv"] == want
    assert sum(counts.values()) == want
    logits = {}
    for d in ("cuda", "cpu"):
        p = params if d == "cpu" else ServeEngine(spec, params, s_max=48, device=d).params
        logits[d], _ = lm.prefill(spec, p, torch.from_numpy(prompts).long().to(d), 48)
    _rel_close(logits["cuda"].cpu(), logits["cpu"], 1e-4)


@pytest.mark.parametrize("oocore", [False, True], ids=["resident", "oocore"])
def test_incremental_cli_report_on_card(dev, tmp_path, oocore):
    """``caddelag-run-torch --incremental-chain --run-report --trace`` at n=64 on
    the card: both files pass the port's validators, and the report's chain
    sections equal a CPU run's on the same arguments (integer counts and
    logical sizes: equal)."""
    import json

    from repro_torch.launch import caddelag_run
    from repro_torch.obs import REGISTRY, disable_tracing, report, tracer

    args = ["--n", "64", "--t-steps", "3", "--d", "3", "--q", "4", "--drift-nodes", "3",
            "--incremental-chain"]
    docs = {}
    try:
        for d in ("cuda", "cpu"):
            out = tmp_path / d
            out.mkdir()
            extra = (["--store", str(out / "st"), "--oocore-chain", "--use-gemm-kernel"]
                     if oocore else [])
            before = REGISTRY.snapshot().counters
            caddelag_run.main(["--device", d, *args, *extra, "--run-report", str(out / "r.json"),
                               "--trace", str(out / "t.json")])
            assert report.validate_file(str(out / "r.json")) == "caddelag_run_report"
            assert report.validate_file(str(out / "t.json")) == "chrome_trace"
            doc = json.loads((out / "r.json").read_text())
            docs[d] = ({f: doc["chain"][f] - before.get(f"chain.{f}", 0.0)
                        for f in report.CHAIN_FIELDS}, [t["chain"] for t in doc["transitions"]])
    finally:
        disable_tracing()
        tracer().clear()
    assert docs["cuda"] == docs["cpu"]
    assert (docs["cuda"][0]["full_rebuilds"], docs["cuda"][0]["incremental_updates"]) == (1, 2)
    counts = kernels.launch_counts()
    assert counts["edge_projection"] > 0 and counts["cad_scores"] > 0
    assert counts["stream_gemm" if oocore else "block_matmul"] > 0


def test_rademacher_omega_on_card_bitwise_cpu(dev):
    """The delta chain's sketch matrix hashed on the card equals the CPU's bit for bit."""
    from repro_torch.core.delta_chain import _rademacher_omega

    for n, m, seed in ((10512, 6, 0x5EED), (1536, 6, 0xD2), (7, 3, 2**32 + 5)):
        np.testing.assert_array_equal(_rademacher_omega(n, m, seed, dev),
                                      _rademacher_omega(n, m, seed))


# ---------------------------------------------------------------------------
# device grids: the edge projection at a column offset, the schedules on one
# card, and the launches on a second card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row0,col0,m,n", [(0, 0, 300, 300), (0, 150, 150, 150),
                                           (150, 0, 150, 150), (150, 150, 150, 150),
                                           (64, 37, 100, 203), (0, 130, 257, 129)])
@pytest.mark.parametrize("k", [17, 40])
def test_edge_projection_kernel_at_col0(dev, row0, col0, m, n, k):
    """A block of a non-symmetric A at global (row0, col0): against the plain
    version with col0, bitwise repeatable; the diagonal tiles take the
    unordered-pair route, the others ordered pairs, col0 = 37 the 4-byte
    loads.  Its column blocks add up to the whole row's value."""
    rng = np.random.default_rng(row0 + col0 + k)
    a = _arr(rng, (row0 + m, col0 + n), dev)
    blk = a[row0:, col0:].contiguous()
    got = ep.edge_projection(blk, seed=3, k=k, row0=row0, col0=col0)
    torch.testing.assert_close(got, ref.edge_projection(blk, seed=3, k=k, row0=row0, col0=col0),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(got, ep.edge_projection(blk, seed=3, k=k, row0=row0, col0=col0))
    cut = n // 2
    parts = (ep.edge_projection(blk[:, :cut].contiguous(), seed=3, k=k, row0=row0, col0=col0)
             + ep.edge_projection(blk[:, cut:].contiguous(), seed=3, k=k, row0=row0,
                                  col0=col0 + cut))
    torch.testing.assert_close(parts, got, rtol=1e-5, atol=1e-4)
    assert kernels.launch_counts()["edge_projection"] == 4


@pytest.mark.parametrize("schedule,launches", [("xla", 4), ("summa", 4), ("cannon", 8)])
def test_grid_schedules_on_one_card(dev, schedule, launches):
    """A 2x2 grid with every tile on one card: exact block_matmul launch
    counts, and max |C - float64| no worse than twice torch.matmul's in fp32
    (test_block_matmul_float64_accuracy's rule: cannon sums two K halves in
    fp32, so it is not bitwise any one-call product)."""
    from repro_torch.core.distmatrix import make_context, matmul

    ctx = make_context([dev] * 4, 2)
    rng = np.random.default_rng(5)
    a, b = _arr(rng, (1000, 1000), dev), _arr(rng, (1000, 1000), dev)
    got = matmul(ctx.put_matrix(a), ctx.put_matrix(b), schedule=schedule)
    assert kernels.launch_counts()["block_matmul"] == launches
    exact = a.double() @ b.double()
    err = float((got.to_dense().double() - exact).abs().max())
    err_torch = float((torch.matmul(a, b).double() - exact).abs().max())
    assert err <= 2.0 * err_torch, (err, err_torch)


def test_grid_sequence_on_card_matches_cpu_grid(dev):
    """The resident main path on a 2x2 grid of one card against the same grid
    of the CPU (plain versions): scores within 1e-3 of the largest, the
    kernels launched once a tile."""
    from repro_torch.core import CommuteConfig, detect_sequence_anomalies, make_context
    from repro_torch.graphs import gmm_snapshot_sequence

    cfg = CommuteConfig(eps_rp=1e-2, d=4, q=6, schedule="cannon")
    runs = {}
    for d in ("cuda", "cpu"):
        ctx = make_context([d] * 4, 2)
        seq = gmm_snapshot_sequence(256, 3, seed=2, inject_p=0.01, ctx=ctx)
        runs[d] = detect_sequence_anomalies(seq.snapshots(), cfg, top_k=10, ctx=ctx)
    for g, c in zip(runs["cuda"].transitions, runs["cpu"].transitions):
        _rel_close(g.scores.cpu(), c.scores, 1e-3)
    counts = kernels.launch_counts()
    assert counts["block_matmul"] == 3 * (2 * 3 + 1) * 8
    assert (counts["edge_projection"], counts["cad_scores"]) == (12, 8)


def test_make_device_grid_refuses_to_repeat_a_card(dev):
    from repro_torch.launch.mesh import make_device_grid

    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this host has {have}"):
        make_device_grid(have + 1, 1, "cuda")


def test_grid_with_a_host_home_reads_its_card_tiles(dev):
    """A grid that mixes device types (the home on the host, the other tiles
    on the card): copies to the host wait for their data, so the stitched
    matrix and the column-reduced degrees are the card's."""
    from repro_torch.core import laplacian as lap
    from repro_torch.core.distmatrix import make_context

    ctx = make_context(["cpu", dev, dev, dev], 2)
    x = np.abs(np.random.default_rng(11).normal(size=(2048, 2048))).astype(np.float32)
    m = ctx.put_matrix(x)
    for _ in range(3):
        np.testing.assert_array_equal(ctx.to_numpy(m), x)
        np.testing.assert_allclose(lap.degrees(m).numpy(), x.sum(1, dtype=np.float64),
                                   rtol=1e-5)


def test_kernels_launch_on_their_operands_card(dev):
    """Every kernel with its operands on cuda:1 while cuda:0 is current runs
    on cuda:1 and agrees with its plain version there.  Needs two cards: on
    a one-card machine this test skips."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: operands on cuda:1 while cuda:0 is current")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(9)
    a, b = _arr(rng, (300, 200), d1), _arr(rng, (200, 170), d1)
    torch.testing.assert_close(bm.block_matmul(a, b), ref.block_matmul(a, b), rtol=1e-5,
                               atol=1e-4)
    assert all(torch.equal(x, y) for x, y in zip(bm.split_tf32(a), ref.split_tf32(a)))
    sq = _arr(rng, (257, 257), d1, positive=True)
    torch.testing.assert_close(ep.edge_projection(sq, seed=1, k=17),
                               ref.edge_projection(sq, seed=1, k=17), rtol=1e-5, atol=1e-4)
    z1, z2 = _arr(rng, (257, 17), d1), _arr(rng, (257, 17), d1)
    torch.testing.assert_close(cad.cad_scores(sq, sq.T.contiguous(), z1, z2, 3.0, 4.0),
                               ref.cad_scores(sq, sq.T.contiguous(), z1, z2, 3.0, 4.0),
                               rtol=1e-4, atol=1e-2)
    for n in (17, 170):  # the skinny and the tensor-core route
        bb = _arr(rng, (200, n), d1)
        torch.testing.assert_close(sg.stream_gemm(a, bb), ref.stream_gemm(a, bb), rtol=1e-5,
                                   atol=1e-4)
    y, chi, yp = _arr(rng, (200, 8), d1), _arr(rng, (300, 8), d1), _arr(rng, (300, 8), d1)
    torch.testing.assert_close(sg.fused_panel_matvec(a, y, chi, yp)[0],
                               ref.fused_panel_matvec(a, y, chi, yp)[0], rtol=1e-4, atol=1e-4)
    vals, ids, zq, zp, idq, idp, ex = _topk_case(d1, rng, 2, 128, 17, 20, True, False)
    got_v, _ = eq.panel_topk_update(vals, ids, zq, zp, idq, idp, 2.5, 1000, ex, topk=20)
    want_v, _ = ref.panel_topk_update(vals, ids, zq, zp, idq, idp, 2.5, 1000, ex, topk=20)
    _rel_close(got_v, want_v, 1e-5)
    r, k, v, lw, u, _ = _wkv_args(d1, 3, 100, 64, 64, torch.float32)
    _rel_close(wkv.wkv(r, k, v, lw, u), ref.wkv(r, k, v, lw, u), 1e-4)
    q = _arr(rng, (4, 70, 64), d1).to(torch.bfloat16)
    kk, vv = (_arr(rng, (2, 70, 64), d1).to(torch.bfloat16) for _ in range(2))
    _rel_close(flash.flash_attention(q, kk, vv, causal=True, groups=2),
               ref.flash_attention(q, kk, vv, causal=True, groups=2), 2.0**-7)
    assert torch.cuda.current_device() == 0
