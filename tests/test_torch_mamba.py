"""The port's Mamba2 layer and the zamba2 hybrid against the JAX package, on the CPU.

``ssd_chunked`` against the JAX ``ssd_chunked`` within 1e-5 of the largest
(fp32; the port contracts the intra-chunk einsum pairwise, another order of
the same sums) and against ``ssd_reference`` within the JAX property test's
1e-3 (tests/test_property.py), over chunks that do and do not divide S, with
and without an entering state.  ``apply_mamba`` with its cache and
``apply_mamba_decode`` at 1e-5, the shared attention block (input
concat(h, emb0) at width 2 * d_model) at 1e-5, zamba2 SMOKE end to end
(logits within 1e-4 of the largest, greedy tokens equal to the JAX
engine's), ``interop`` on the hybrid tree, and the flash attention's plain
versions at zamba2's head dim 224 against the JAX ``_chunked_flash``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_cpu_mesh
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mamba2 as jmb
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.interop import _params_tree, lm_params_from_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmb
from repro_torch.serving import ServeConfig, ServeEngine

ARCH = "zamba2-7b"


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
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _jit_serve(jspec):
    """The JAX prefill and decode step, jitted (eager JAX dispatches op by op)."""
    prefill = jax.jit(lambda p, toks, s_max: jlm.prefill(jspec, p, {"tokens": toks}, s_max),
                      static_argnums=2)
    return prefill, jax.jit(lambda p, tok, cache: jlm.decode_step(jspec, p, tok, cache))


def test_config_is_the_jax_packages():
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get_t(ARCH)) == dataclasses.asdict(get_j(ARCH))


def _ssd_inputs(seed, s, b=2, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, s, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, s, h)))).astype(np.float32)  # softplus
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bm, cm = _normal(rng, (b, s, n)), _normal(rng, (b, s, n))
    d = _normal(rng, (h,))
    h0 = _normal(rng, (b, h, p, n), 0.5)
    return x, dt, a_log, bm, cm, d, h0


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 16), (20, 8), (16, 64), (7, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax_and_the_reference(s, chunk, with_h0):
    """Chunks dividing S, halved until they divide it (24/16 -> 8, 20/8 -> 4,
    7/4 -> 1), longer than S; with and without an entering state."""
    x, dt, a_log, bm, cm, d, h0 = _ssd_inputs(s + chunk, s)
    h0 = h0 if with_h0 else None
    kw = {} if h0 is None else {"h0": h0}
    jy, jh = jmb.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a_log, bm, cm, d)), chunk=chunk,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    ty, th = tmb.ssd_chunked(*(_t(v) for v in (x, dt, a_log, bm, cm, d)), chunk=chunk,
                             **{k: _t(v) for k, v in kw.items()})
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)
    ry, rh = tmb.ssd_reference(*(_t(v) for v in (x, dt, a_log, bm, cm, d)),
                               **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(th.numpy(), rh.numpy(), rtol=1e-3, atol=1e-3)
    jry, jrh = jmb.ssd_reference(*(jnp.asarray(v) for v in (x, dt, a_log, bm, cm, d)),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(ry, jry, 1e-5)
    _close(rh, jrh, 1e-5)


def _mamba_setup(seed=0):
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jmb.init_mamba(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # the init's conv bias and dt bias are zeros; random ones test their paths
    jp = {**jp, "conv_b": jnp.asarray(_normal(rng, jp["conv_b"].shape, 0.1)),
          "dt_bias": jnp.asarray(_normal(rng, jp["dt_bias"].shape, 0.5))}
    return jcfg, tcfg, jp, _params_tree(jax.tree.map(np.asarray, jp), torch.device("cpu"))


@pytest.mark.parametrize("s", [21, 2])
def test_apply_mamba_and_decode_match_jax(s):
    """Prefill with its cache (S=21 over chunk 8; S=2, shorter than the conv
    window), then three decode steps from that cache."""
    jcfg, tcfg, jp, tp = _mamba_setup()
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, s, jcfg.d_model))
    jout, jcache = jax.jit(lambda p, x: jmb.apply_mamba(jcfg, p, x, return_cache=True))(
        jp, jnp.asarray(x))
    tout, tcache = tmb.apply_mamba(tcfg, tp, _t(x), return_cache=True)
    _close(tout, jout, 1e-5)
    _close(tmb.apply_mamba(tcfg, tp, _t(x)), jout, 1e-5)
    _close(tcache["ssm"], jcache["ssm"], 1e-5)
    if s >= 3:
        _close(tcache["conv"], jcache["conv"], 1e-6)
    else:  # the JAX tail is S rows; the port pads it to the window with zeros
        assert tuple(tcache["conv"].shape) == tuple(tmb.mamba_cache_init(tcfg, 2, torch.float32)
                                                    ["conv"].shape)
        _close(tcache["conv"][:, -s:], jcache["conv"], 1e-6)
        assert not tcache["conv"][:, :-s].any()
        return
    decode = jax.jit(lambda p, x, c: jmb.apply_mamba_decode(jcfg, p, x, c))
    for _ in range(3):
        xt = _normal(rng, (2, 1, jcfg.d_model))
        jy, jcache = decode(jp, jnp.asarray(xt), jcache)
        ty, tcache = tmb.apply_mamba_decode(tcfg, tp, _t(xt), tcache)
        _close(ty, jy, 1e-5)
        _close(tcache["ssm"], jcache["ssm"], 1e-5)
        _close(tcache["conv"], jcache["conv"], 1e-6)


def test_mamba_cache_init_matches_jax():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    got = tmb.mamba_cache_init(tcfg, 3, torch.float32)
    want = jmb.mamba_cache_init(jcfg, 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_conv_filters_stay_out_of_the_compute_cast():
    assert {"w_z", "w_x", "w_b", "w_c", "w_dt", "w_out"} <= tcm.COMPUTE_NAMES
    assert not {"conv_wx", "conv_wbc", "conv_b", "norm", "a_log", "d_skip", "dt_bias",
                "router"} & tcm.COMPUTE_NAMES
    cfg = tconfigs.get_smoke(ARCH).replace(compute_dtype="bfloat16")
    p = tmb.init_mamba(cfg, torch.Generator().manual_seed(0), device="cpu")
    cast = tcm.cast_for_compute(p, torch.bfloat16)
    assert cast.w_x.dtype == torch.bfloat16 and cast.conv_wx.dtype == torch.float32


@pytest.fixture(scope="module")
def model():
    jspec = jlm.build_spec(jconfigs.get_smoke(ARCH))
    jp = jax.jit(lambda key: jlm.init_params(jspec, key))(jax.random.PRNGKey(0))
    tspec = tlm.build_spec(tconfigs.get_smoke(ARCH))
    tp = lm_params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    return jspec, jp, tspec, tp


def test_hybrid_spec_and_interop(model):
    """7 layers, shared block every 3: two groups of (3 mamba, shared) and a
    remainder mamba; the shared block's parameters once, not in blocks."""
    jspec, jp, tspec, tp = model
    assert tspec.layers() == (["mamba"] * 3 + ["shared_attn"]) * 2 + ["mamba"]
    assert tspec.has_shared_attn
    assert len(tp.blocks) == 7
    assert tlm.param_count(tp) == jlm.param_count(jp)
    assert tlm.param_count(tlm.init_params(tspec, device="cpu")) == jlm.param_count(jp)
    # execution order: layer 1 of group 0 holds blocks 3, 4, 5
    np.testing.assert_array_equal(tp.blocks[4].mamba.w_x.numpy(),
                                  np.asarray(jp["groups"][0]["1"]["mamba"]["w_x"][1]))
    np.testing.assert_array_equal(tp.blocks[6].mamba.w_out.numpy(),
                                  np.asarray(jp["groups"][1]["0"]["mamba"]["w_out"][0]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp["shared_attn"])[0]:
        mod = tp.shared_attn
        for key in path:
            mod = getattr(mod, key.key)
        np.testing.assert_array_equal(mod.numpy(), np.asarray(leaf))
    d = tspec.cfg.d_model
    assert tuple(tp.shared_attn.attn.wq.shape) == (2 * d, 2 * d)  # head_dim 2 d / n_heads
    assert tuple(tp.shared_attn.ln.scale.shape) == (2 * d,)


def test_depth_below_attn_every_has_no_shared_call():
    cfg = tconfigs.get_smoke(ARCH).replace(n_layers=2)
    spec = tlm.build_spec(cfg)
    assert spec.layers() == ["mamba", "mamba"]
    assert spec.groups[0].count == 0
    jspec = jlm.build_spec(jconfigs.get_smoke(ARCH).replace(n_layers=2))
    assert spec.has_shared_attn == jspec.has_shared_attn  # initialized, never called


def test_shared_block_matches_jax(model):
    """Prefill and two decode steps of the shared block over concat(h, emb0)."""
    jspec, jp, tspec, tp = model
    jcfg, tcfg = jspec.cfg, tspec.cfg
    rng = np.random.default_rng(5)
    h, emb0 = _normal(rng, (2, 11, jcfg.d_model)), _normal(rng, (2, 11, jcfg.d_model))
    jh, jc = jax.jit(lambda sp, h, e: jlm._apply_block_prefill(
        jcfg, jspec, "shared_attn", None, h, 16, rules={}, shared=sp, emb0=e, enc_out=None))(
        jp["shared_attn"], jnp.asarray(h), jnp.asarray(emb0))
    tc = tlm.init_cache(tspec, 2, 16, device="cpu")["layers"][3]
    th = tlm._apply_block_prefill(tcfg, "shared_attn", tp.shared_attn, _t(h), tc, _t(emb0))
    _close(th, jh, 1e-5)
    _close(tc["k"], jc["k"], 1e-5)
    _close(tc["v"], jc["v"], 1e-5)
    decode = jax.jit(lambda sp, x, c, pos, e: jlm._apply_block_decode(
        jcfg, jspec, "shared_attn", None, x, c, pos, rules={}, shared=sp, emb0=e, enc_out=None))
    for pos in (11, 12):
        x, e = _normal(rng, (2, 1, jcfg.d_model)), _normal(rng, (2, 1, jcfg.d_model))
        jy, jc = decode(jp["shared_attn"], jnp.asarray(x), jc, pos, jnp.asarray(e))
        ty, tc = tlm._apply_block_decode(tcfg, "shared_attn", tp.shared_attn, _t(x), tc, pos,
                                         _t(e))
        _close(ty, jy, 1e-5)


def test_prefill_and_decode_logits_match_jax(model):
    jspec, jp, tspec, tp = model
    prompts = np.random.default_rng(0).integers(0, tspec.cfg.vocab, size=(2, 13)).astype(np.int32)
    prefill, decode = _jit_serve(jspec)
    jl, jcache = prefill(jp, jnp.asarray(prompts), 19)
    tl, tcache = tlm.prefill(tspec, tp, torch.from_numpy(prompts).long(), 19)
    _close(tl, jl, 1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(6):
        jl, jcache = decode(jp, jnp.asarray(tok), jcache)
        tl, tcache = tlm.decode_step(tspec, tp, torch.from_numpy(tok).long(), tcache)
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_greedy_tokens_match_jax_engine(model):
    jspec, jp, tspec, tp = model
    prompts = np.random.default_rng(1).integers(0, tspec.cfg.vocab, size=(3, 16)).astype(np.int32)
    want = JServeEngine(jspec, make_cpu_mesh(1, 1), jp, s_max=32, batch=3,
                        cfg=JServeConfig(max_new_tokens=8)).generate(prompts)
    got = ServeEngine(tspec, tp, s_max=32, batch=3, cfg=ServeConfig(max_new_tokens=8),
                      device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_matches_prefill(model):
    jspec, jp, tspec, tp = model
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tspec.cfg.vocab, size=(2, 12))).long()
    logits, cache = tlm.prefill(tspec, tp, toks[:, :8], 16)
    for i in range(8, 12):
        logits, cache = tlm.decode_step(tspec, tp, toks[:, i], cache)
        want, _ = tlm.prefill(tspec, tp, toks[:, : i + 1], 16)
        _close(logits, want, 1e-4)


@pytest.mark.parametrize("s,groups", [(64, 1), (40, 2)])
def test_flash_plain_versions_at_head_dim_224_match_jax(s, groups):
    """zamba2's shared block attends at D = 2 x 3584 / 32 = 224: the model's
    chunked form and the kernel's plain version against the JAX _chunked_flash."""
    rng = np.random.default_rng(s)
    b, nkv, hd = 2, 2, 224
    q = _normal(rng, (b, s, nkv * groups, hd))
    k, v = _normal(rng, (b, s, nkv, hd)), _normal(rng, (b, s, nkv, hd))
    tcfg = tcm.ArchConfig(name="t", family="hybrid", n_layers=1, d_model=64,
                          n_heads=nkv * groups, n_kv_heads=nkv, d_ff=64, vocab=16,
                          head_dim=hd, attn_chunk=16, compute_dtype="float32")
    want = jattn._chunked_flash(jconfigs.get_smoke(ARCH).replace(**{
        f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}),
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, rules={})
    _close(tattn._chunked_flash(tcfg, _t(q), _t(k), _t(v), causal=True), want, 1e-4)
    heads = lambda x: _t(x).transpose(1, 2).reshape(-1, s, hd)  # noqa: E731
    flat = tflash.flash_attention(heads(q), heads(k), heads(v), causal=True, groups=groups)
    _close(flat.reshape(b, nkv * groups, s, hd).transpose(1, 2), want, 1e-4)
    assert tflash.D_MAX >= hd


def test_serve_launcher_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "time to first token" in out and "first sequence" in out
