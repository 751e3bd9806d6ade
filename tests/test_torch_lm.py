"""The port's LM modules against the JAX package, one module at a time, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them,
and the plain kernel versions are held to that file's tolerances (1e-3 for
wkv, 1e-4 for flash attention).  Model modules run at the SMOKE configs in
fp32, where both packages compute the same sums in another order: 1e-5 of
the largest value for the recurrences and projections, 1e-4 for the
attention and decode paths (the tolerance of test_decode_matches_prefill).
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import rwkv6 as jrwkv
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.interop import _params_tree
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv as twkv
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import mlp as tmlp
from repro_torch.models import rwkv6 as trwkv


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors never launch


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, rtol):
    """max |got - want| <= rtol x max |want| (and the same shape)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _params(jtree):
    return _params_tree(jax.tree.map(np.asarray, jtree), torch.device("cpu"))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen2-1.5b"])
def test_configs_are_the_jax_packages(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke, jconfigs.get_smoke)):
        tc, jc = get_t(arch), get_j(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.hd, tc.vocab_padded) == (jc.hd, jc.vocab_padded)
        assert tc.pdtype == getattr(torch, jc.param_dtype)
        assert tc.cdtype == getattr(torch, jc.compute_dtype)


def test_unported_archs_raise():
    for arch in jconfigs.ARCH_IDS:
        if arch in tconfigs.ARCH_IDS:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tconfigs.get_config(arch)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# the wkv kernel's plain version and the model's chunked form
# ---------------------------------------------------------------------------


def _wkv_inputs(rng, bh, s, dk, dv, decay_scale=0.5, decay_shift=1.0):
    r, k = _normal(rng, (bh, s, dk)), _normal(rng, (bh, s, dk))
    v = _normal(rng, (bh, s, dv))
    lw = -np.exp(_normal(rng, (bh, s, dk)) * decay_scale - decay_shift).astype(np.float32)
    u = 0.1 * _normal(rng, (bh, dk))
    return r, k, v, lw, u


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (96, 24)])
def test_plain_wkv_matches_pallas(s, chunk):
    """tests/test_kernels.py::test_wkv_kernel's shapes and decays, 1e-3."""
    r, k, v, lw, u = _wkv_inputs(np.random.default_rng(s), 3, s, 16, 16)
    want = np.asarray(jops.wkv(*(jnp.asarray(x) for x in (r, k, v, lw, u)), chunk=chunk))
    got = twkv.wkv(*(_t(x) for x in (r, k, v, lw, u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.wkv(r, k, v, lw, u)),
                               rtol=1e-3, atol=1e-3)


def test_plain_wkv_state_in_and_out():
    """ref.wkv over two halves, the state handed over, equals one pass."""
    r, k, v, lw, u = (_t(x) for x in _wkv_inputs(np.random.default_rng(5), 4, 40, 8, 12))
    y, s_fin = twkv.wkv(r, k, v, lw, u, return_state=True)
    y1, s1 = twkv.wkv(r[:, :17], k[:, :17], v[:, :17], lw[:, :17], u, return_state=True)
    y2, s2 = twkv.wkv(r[:, 17:].contiguous(), k[:, 17:].contiguous(), v[:, 17:].contiguous(),
                      lw[:, 17:].contiguous(), u, s0=s1, return_state=True)
    _close(torch.cat([y1, y2], dim=1), y, 1e-5)
    _close(s2, s_fin, 1e-5)
    assert s_fin.shape == (4, 8, 12) and s_fin.dtype == torch.float32


@pytest.mark.parametrize("s,piece", [(128, 64), (96, 64), (130, 32), (64, 1)])
def test_plain_wkv_piecewise_matches_pallas(s, piece):
    """The decomposition the card's chunk-parallel scan relies on: the plain
    wkv run piece by piece, each piece seeded with the previous piece's final
    state, equals the Pallas wkv over the whole sequence (1e-3, as above)."""
    r, k, v, lw, u = _wkv_inputs(np.random.default_rng(s + piece), 3, s, 16, 16)
    want = np.asarray(jops.wkv(*(jnp.asarray(x) for x in (r, k, v, lw, u)), chunk=32))
    ys, st = [], None
    for c0 in range(0, s, piece):
        part = [_t(x[:, c0 : c0 + piece]) for x in (r, k, v, lw)]
        y, st = twkv.wkv(*part, _t(u), s0=st, return_state=True)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bh,s,dk,dv,want", [
    (160, 1024, 64, 64, 160 * 16 * (64 * 64 + 64)),  # rwkv6-3b's prefill: 42 MB
    (3, 65, 5, 7, 3 * 2 * (5 * 7 + 5)),  # a ragged last chunk counts whole
    (2, 0, 16, 16, 0),
])
def test_wkv_scratch_elems(bh, s, dk, dv, want):
    """The card's scratch: each 64-row chunk's state and decay."""
    assert twkv.scratch_elems(bh, s, dk, dv) == want


@pytest.mark.parametrize("s,chunk", [(24, 8), (24, 16), (13, 8)])
def test_wkv_chunked_matches_jax(s, chunk):
    """The model's chunked form with s0 in and s_final out, 1e-5 (chunk halving
    included: 16 -> 8 for S=24, 8 -> 1 for S=13)."""
    rng = np.random.default_rng(s + chunk)
    b, nh, dk = 2, 3, 8
    r, k, v, lw = (_normal(rng, (b, s, nh, dk)) for _ in range(4))
    lw = -np.exp(lw * 0.3 - 1.5).astype(np.float32)
    u = 0.1 * _normal(rng, (nh, dk))
    s0 = _normal(rng, (b, nh, dk, dk))
    jy, js = jrwkv.wkv_chunked(*(jnp.asarray(x) for x in (r, k, v, lw, u)), chunk=chunk,
                               s0=jnp.asarray(s0))
    ty, ts = trwkv.wkv_chunked(*(_t(x) for x in (r, k, v, lw, u)), chunk=chunk, s0=_t(s0))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def test_wkv_reference_matches_jax():
    rng = np.random.default_rng(3)
    b, s, nh, dk = 2, 9, 3, 8
    r, k, v, lw = (_normal(rng, (b, s, nh, dk)) for _ in range(4))
    lw = -np.exp(lw * 0.5 - 1.0).astype(np.float32)
    u = 0.1 * _normal(rng, (nh, dk))
    s0 = _normal(rng, (b, nh, dk, dk))
    jy, js = jrwkv.wkv_reference(*(jnp.asarray(x) for x in (r, k, v, lw, u)), s0=jnp.asarray(s0))
    ty, ts = trwkv.wkv_reference(*(_t(x) for x in (r, k, v, lw, u)), s0=_t(s0))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)
    # and the chunked form agrees with the oracle
    cy, cs = trwkv.wkv_chunked(*(_t(x) for x in (r, k, v, lw, u)), chunk=4, s0=_t(s0))
    _close(cy, ty, 1e-5)
    _close(cs, ts, 1e-5)


# ---------------------------------------------------------------------------
# the flash_attention kernel's plain version and the model's chunked form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,d", [(128, 64), (256, 128), (64, 32), (128, 224)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas(s, d, causal):
    """tests/test_kernels.py::test_flash_attention's shapes and zamba2's
    shared-block head dim 224, 1e-4."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_normal(rng, (2, s, d)) for _ in range(3))
    want = np.asarray(jops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                           bq=64, bk=64))
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.flash_attention(q, k, v, causal=causal)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 224, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"), (torch.float32, 224, "simt"),
    (torch.float32, 256, "simt"), (torch.bfloat16, 32, "simt"), (torch.bfloat16, 200, "simt"),
    (torch.bfloat16, 256, "simt")])
def test_flash_kernel_route_table(dtype, d, want):
    """The card's fixed dispatch, as the wrapper reads it: bf16 at D 64, 128
    and 224 on the tensor cores; fp32 at any D and bf16 at any other D on the
    SIMT kernel."""
    assert tflash.kernel_route(dtype, d) == want


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_kernel_wgmmaILi128EEEvP' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_kernel_wgmmaILi128EEEvP
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 147 registers, used 1 barriers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_kernel_wgmmaILi224EEEvP' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_kernel_wgmmaILi224EEEvP
    128 bytes stack frame, 128 bytes spill stores, 124 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 360 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel,want", [
    ("flash_kernel_wgmmaILi128E", {"registers": 147, "spill_stores": 0, "spill_loads": 0}),
    ("flash_kernel_wgmmaILi224E", {"registers": 168, "spill_stores": 128, "spill_loads": 124}),
    ("flash_kernel_wgmmaILi64E", None)])
def test_ptxas_usage_reads_one_kernel(kernel, want):
    """The build log's registers and spills of one entry function, as
    chip_smoke.py reads them for the D = 224 instance; None when absent."""
    from repro_torch.kernels import _build

    assert _build.ptxas_usage(_PTXAS_LOG, kernel) == want


def _attn_cfg(**kw):
    return tcm.ArchConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                          n_kv_heads=2, d_ff=64, vocab=16, attn_chunk=16,
                          compute_dtype="float32", **kw)


@pytest.mark.parametrize("s,causal", [(64, True), (40, True), (64, False)])
def test_chunked_flash_gqa_matches_jax(s, causal):
    """nh=4 over nkv=2; attn_chunk 16 (S=40 halves it to 8), 1e-4."""
    rng = np.random.default_rng(s)
    b, hd = 2, 16
    q = _normal(rng, (b, s, 4, hd))
    k, v = _normal(rng, (b, s, 2, hd)), _normal(rng, (b, s, 2, hd))
    tcfg = _attn_cfg()
    jcfg = jcm.ArchConfig(**dataclasses.asdict(tcfg))
    want = jattn._chunked_flash(jcfg, *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                rules={})
    got = tattn._chunked_flash(tcfg, _t(q), _t(k), _t(v), causal=causal)
    _close(got, want, 1e-4)
    # the kernel's plain version with groups=2 computes the same function
    heads = lambda x: _t(x).transpose(1, 2).reshape(-1, s, hd)  # noqa: E731
    flat = tflash.flash_attention(heads(q), heads(k), heads(v), causal=causal, groups=2)
    _close(flat.reshape(b, 4, s, hd).transpose(1, 2), want, 1e-4)


# ---------------------------------------------------------------------------
# model modules at the SMOKE configs
# ---------------------------------------------------------------------------


def _rwkv_setup(seed=0):
    jcfg = jconfigs.get_smoke("rwkv6-3b")
    tcfg = tconfigs.get_smoke("rwkv6-3b")
    jp = jrwkv.init_rwkv(jcfg, jax.random.PRNGKey(seed))
    # decays strong enough that the chunked form's state matters
    jp = {**jp, "w_base": jnp.full_like(jp["w_base"], -1.0),
          "mix": jnp.asarray(np.random.default_rng(seed).uniform(size=jp["mix"].shape),
                             jnp.float32)}
    return jcfg, tcfg, jp, _params(jp)


def test_rwkv_timemix_prefill_matches_jax():
    jcfg, tcfg, jp, tp = _rwkv_setup()
    x = _normal(np.random.default_rng(1), (2, 20, jcfg.d_model))
    jout, jprev, js = jlm._rwkv_tm_prefill(jcfg, jp, jnp.asarray(x), rules={})
    tout, tprev, ts = trwkv.rwkv_timemix_prefill(tcfg, tp, _t(x))
    _close(tout, jout, 1e-5)
    _close(tprev, jprev, 0)
    _close(ts, js, 1e-5)
    _close(tout, jrwkv.apply_rwkv_timemix(jcfg, jp, jnp.asarray(x)), 1e-5)


def test_rwkv_channelmix_matches_jax():
    jcfg, tcfg, jp, tp = _rwkv_setup(1)
    x = _normal(np.random.default_rng(2), (2, 11, jcfg.d_model))
    _close(trwkv.apply_rwkv_channelmix(tcfg, tp, _t(x)),
           jrwkv.apply_rwkv_channelmix(jcfg, jp, jnp.asarray(x)), 1e-5)


def test_rwkv_decode_matches_jax():
    jcfg, tcfg, jp, tp = _rwkv_setup(2)
    rng = np.random.default_rng(3)
    b, d = 2, jcfg.d_model
    nh, hd = d // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    cache = {"tm_prev": _normal(rng, (b, 1, d)), "cm_prev": _normal(rng, (b, 1, d)),
             "wkv": _normal(rng, (b, nh, hd, hd))}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: _t(v) for k, v in cache.items()}
    for step in range(3):
        x1, x2 = _normal(rng, (b, 1, d)), _normal(rng, (b, 1, d))
        jy1, jcache = jrwkv.apply_rwkv_timemix_decode(jcfg, jp, jnp.asarray(x1), jcache)
        ty1, tcache = trwkv.apply_rwkv_timemix_decode(tcfg, tp, _t(x1), tcache)
        jy2, jcache = jrwkv.apply_rwkv_channelmix_decode(jcfg, jp, jnp.asarray(x2), jcache)
        ty2, tcache = trwkv.apply_rwkv_channelmix_decode(tcfg, tp, _t(x2), tcache)
        _close(ty1, jy1, 1e-5)
        _close(ty2, jy2, 1e-5)
        for key in ("tm_prev", "cm_prev", "wkv"):
            _close(tcache[key], jcache[key], 1e-5)
    fresh = trwkv.rwkv_cache_init(tcfg, 3, torch.float32)
    jfresh = jrwkv.rwkv_cache_init(jcfg, 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in jfresh.items()}


def _attn_setup(seed=0):
    jcfg = jconfigs.get_smoke("qwen2-1.5b")  # QKV bias, rope theta 1e6, GQA 4 over 2
    tcfg = tconfigs.get_smoke("qwen2-1.5b")
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # the init's biases are zeros; random ones test the bias path
    jp = {**jp, **{n: jnp.asarray(_normal(rng, jp[n].shape, 0.1)) for n in ("bq", "bk", "bv")}}
    return jcfg, tcfg, jp, _params(jp)


def test_attention_prefill_matches_jax():
    jcfg, tcfg, jp, tp = _attn_setup()
    x = _normal(np.random.default_rng(4), (2, 24, jcfg.d_model))
    jy, (jk, jv) = jattn.attend_prefill(jcfg, jp, jnp.asarray(x), rules={})
    ty, (tk, tv) = tattn.attend_prefill(tcfg, tp, _t(x))
    _close(ty, jy, 1e-4)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


def test_attention_decode_matches_jax():
    jcfg, tcfg, jp, tp = _attn_setup(1)
    rng = np.random.default_rng(5)
    b, s_max, pos = 2, 16, 9
    shape = (b, s_max, jcfg.n_kv_heads, jcfg.hd)
    kc, vc = _normal(rng, shape), _normal(rng, shape)
    jcache = (jnp.asarray(kc), jnp.asarray(vc))
    tcache = (_t(kc), _t(vc))
    for step in range(3):
        x = _normal(rng, (b, 1, jcfg.d_model))
        jy, jcache = jattn.attend_decode(jcfg, jp, jnp.asarray(x), jcache, pos + step, rules={})
        ty, tcache = tattn.attend_decode(tcfg, tp, _t(x), tcache, pos + step)
        _close(ty, jy, 1e-4)
        _close(tcache[0], jcache[0], 1e-5)
        _close(tcache[1], jcache[1], 1e-5)


def test_mlp_matches_jax():
    jcfg = jconfigs.get_smoke("qwen2-1.5b")
    tcfg = tconfigs.get_smoke("qwen2-1.5b")
    jp = jmlp.init_mlp(jcfg, jax.random.PRNGKey(7))
    x = _normal(np.random.default_rng(7), (2, 5, jcfg.d_model))
    _close(tmlp.apply_mlp(tcfg, _params(jp), _t(x)), jmlp.apply_mlp(jcfg, jp, jnp.asarray(x)),
           1e-5)


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(8)
    x = _normal(rng, (2, 6, 3, 16))
    for norm in ("rms", "ln"):
        tcfg = _attn_cfg(norm=norm)
        jcfg = jcm.ArchConfig(**dataclasses.asdict(tcfg))
        jinit, japply = jcm.make_norm(jcfg, 16)
        jp = {k: jnp.asarray(_normal(rng, v.shape)) for k, v in jinit(None).items()}
        tinit, tapply = tcm.make_norm(tcfg, 16)
        assert set(dict(tinit().named_parameters())) == set(jp)
        _close(tapply(_params(jp), _t(x)), japply(jp, jnp.asarray(x)), 1e-5)
    pos = np.arange(6) + 1000
    jcos, jsin = jcm.rope_tables(jnp.asarray(pos), 16, 1e6)
    tcos, tsin = tcm.rope_tables(torch.from_numpy(pos), 16, 1e6)
    _close(tcos, jcos, 1e-5)
    _close(tsin, jsin, 1e-5)
    _close(tcm.apply_rope(_t(x), tcos, tsin), jcm.apply_rope(jnp.asarray(x), jcos, jsin), 1e-5)


def test_init_distributions_match_jax():
    """The port's initializers draw the JAX package's distributions (not its bits)."""
    gen = torch.Generator().manual_seed(0)
    t = tcm.dense_init(gen, (512, 256), torch.float32)
    j = np.asarray(jcm.dense_init(jax.random.PRNGKey(0), (512, 256), jnp.float32))
    assert abs(float(t.std()) - float(j.std())) < 0.02 * float(j.std())
    assert float(t.abs().max()) <= 3.0 / np.sqrt(512) + 1e-7
    e = tcm.embed_init(gen, (512, 256), torch.float32)
    assert abs(float(e.std()) - 0.02) < 0.001
