"""The port's MoE layer and the MoE architectures against the JAX package, on the CPU.

``apply_moe`` against the JAX ``apply_moe`` without a mesh (the semantics
of ``_moe_local``), on the same numpy inputs and one JAX init carried
across: the expert ids and kept masks equal (the JAX routing is recomputed
here from the same JAX primitives ``_moe_local`` uses), y and the aux losses
within 1e-5 of the largest (fp32; the two packages sum in another order),
with capacity factors that do and do not drop tokens.  Then granite-moe and
llama4 (alternating dense and MoE layers, a shared expert) end to end at
SMOKE: prefill and six decode steps within 1e-4 of the largest, greedy
tokens equal to the JAX engine's (``tests/test_torch_serve.py``'s
tolerances).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jconfigs
from repro.launch.mesh import make_cpu_mesh
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.interop import _params_tree, lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServeConfig, ServeEngine

ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors never launch


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _jit_serve(jspec):
    """The JAX prefill and decode step, jitted (eager JAX dispatches op by op)."""
    prefill = jax.jit(lambda p, toks, s_max: jlm.prefill(jspec, p, {"tokens": toks}, s_max),
                      static_argnums=2)
    return prefill, jax.jit(lambda p, tok, cache: jlm.decode_step(jspec, p, tok, cache))


def _jax_routing(cfg, p, xt, cap):
    """The JAX package's routing of ``_moe_local``, step for step."""
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(ids, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(-1, cfg.n_experts)
    pos = ((jnp.cumsum(flat, axis=0) - flat).reshape(onehot.shape) * onehot).sum(-1)
    return np.asarray(ids), np.asarray(pos < cap)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke, jconfigs.get_smoke)):
        tc, jc = get_t(arch), get_j(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.hd == jc.hd


@pytest.mark.parametrize("arch,cf,seq", [
    ("granite-moe-3b-a800m", 1.25, 13), ("llama4-maverick-400b-a17b", 1.25, 13),
    ("granite-moe-3b-a800m", 0.5, 24), ("llama4-maverick-400b-a17b", 0.5, 24),
    ("granite-moe-3b-a800m", 4.0, 5)])
def test_apply_moe_matches_jax(arch, cf, seq):
    jcfg = jconfigs.get_smoke(arch).replace(capacity_factor=cf)
    tcfg = tconfigs.get_smoke(arch).replace(capacity_factor=cf)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = _params_tree(jax.tree.map(np.asarray, jp), torch.device("cpu"))
    x = np.random.default_rng(seq).normal(size=(2, seq, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(jcfg, p, x))(jp, jnp.asarray(x))
    with tmoe.record_routing() as log:
        ty, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    cap = tmoe.capacity(tcfg, 2 * seq)
    assert cap == max(4, min(int(cf * 2 * seq * tcfg.top_k / tcfg.n_experts), 2 * seq))
    (r,) = log
    ids, keep = _jax_routing(jcfg, jp, jnp.asarray(x.reshape(-1, jcfg.d_model)), cap)
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf == 0.5:
        assert not keep.all()  # some tokens are dropped
    if cf == 4.0:
        assert keep.all()
    _close(ty, jy, 1e-5)
    for name in ("lb_loss", "z_loss"):
        _close(taux[name], jaux[name], 1e-5)


def test_topk_ties_go_to_the_lower_index():
    """A zero router gives every expert the same probability: lax.top_k then
    takes the lowest ids, in order, and so does the port."""
    cfg = tconfigs.get_smoke("granite-moe-3b-a800m")
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    p.router.data.zero_()
    r = tmoe.route(cfg, p, torch.randn(6, cfg.d_model), cap=4)
    want = np.asarray(lax.top_k(jnp.full((6, cfg.n_experts), 1.0 / cfg.n_experts),
                                cfg.top_k)[1])
    np.testing.assert_array_equal(r.expert_ids.numpy(), want)
    # token-major positions: token t's slots sit at t in each of its experts
    np.testing.assert_array_equal(r.position.numpy(), np.repeat(np.arange(6)[:, None],
                                                                cfg.top_k, axis=1))
    assert r.keep.numpy().tolist() == [[t < 4] * cfg.top_k for t in range(6)]


def test_init_keeps_the_router_fp32_and_draws_stacks_by_slice():
    cfg = tconfigs.get_smoke("llama4-maverick-400b-a17b").replace(
        param_dtype="bfloat16", d_model=256, d_expert=128)
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p.router.dtype == torch.float32
    assert {p.w_gate.dtype, p.w_up.dtype, p.w_down.dtype, p.shared.w_up.dtype} == \
        {torch.bfloat16}
    assert tuple(p.w_gate.shape) == (8, 256, 128) and tuple(p.w_down.shape) == (8, 128, 256)
    # the JAX fan-in rule: shape[0], which is E for an expert stack; a
    # truncated normal within 3 std has std 0.9866 of the untruncated one
    w = p.w_gate.float()
    std = 1.0 / math.sqrt(8)
    assert float(w.abs().max()) <= 3.0 * std * (1 + 2**-8)
    assert abs(float(w.std()) / (0.98658 * std) - 1.0) < 0.01
    assert not torch.equal(w[0], w[1])  # each expert its own draw


def test_interop_keeps_each_leafs_dtype():
    """llama4 at SMOKE with bf16 parameters: the expert stacks arrive bf16,
    the router fp32, bit for bit."""
    jcfg = jconfigs.get_smoke("llama4-maverick-400b-a17b").replace(param_dtype="bfloat16")
    jspec = jlm.build_spec(jcfg)
    jp = jax.jit(lambda key: jlm.init_params(jspec, key))(jax.random.PRNGKey(0))
    tspec = tlm.build_spec(tconfigs.get_smoke("llama4-maverick-400b-a17b").replace(
        param_dtype="bfloat16"))
    tp = lm_params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    moe_block = tp.blocks[1]
    assert moe_block.moe.router.dtype == torch.float32
    assert moe_block.moe.w_gate.dtype == torch.bfloat16
    want = np.asarray(jp["groups"][0]["1"]["moe"]["w_gate"][0]).astype(np.float32)
    np.testing.assert_array_equal(moe_block.moe.w_gate.float().numpy(), want)


def test_llama4_alternates_dense_and_moe_layers():
    cfg = tconfigs.get_smoke("llama4-maverick-400b-a17b")
    spec = tlm.build_spec(cfg)
    assert spec.layers() == ["attn", "attn_moe"] * (cfg.n_layers // 2)
    assert spec.groups[0].override("attn") == {"d_ff": 2 * cfg.d_ff}
    assert spec.groups[0].override("attn_moe") == {}
    tp = tlm.init_params(spec, device="cpu")
    for i, block in enumerate(tp.blocks):
        if i % 2 == 0:
            assert tuple(block.mlp.w_up.shape) == (cfg.d_model, 2 * cfg.d_ff)
        else:
            assert tuple(block.moe.w_up.shape) == (cfg.n_experts, cfg.d_model, cfg.d_expert)
            assert tuple(block.moe.shared.w_up.shape) == (cfg.d_model, cfg.d_expert)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    jp = jax.jit(lambda key: jlm.init_params(jspec, key))(jax.random.PRNGKey(0))
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    tp = lm_params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jspec, jp, tspec, tp


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def test_params_carry_over(model):
    arch, jspec, jp, tspec, tp = model
    assert tlm.param_count(tp) == jlm.param_count(jp)
    assert tlm.param_count(tlm.init_params(tspec, device="cpu")) == jlm.param_count(jp)
    assert len(tp.blocks) == tspec.cfg.n_layers


def test_prefill_and_decode_logits_match_jax(model):
    arch, jspec, jp, tspec, tp = model
    prompts = _prompts(tspec.cfg, 2, 13)
    prefill, decode = _jit_serve(jspec)
    jl, jcache = prefill(jp, jnp.asarray(prompts), 19)
    with tmoe.record_routing() as log:
        tl, tcache = tlm.prefill(tspec, tp, torch.from_numpy(prompts).long(), 19)
    assert len(log) == tspec.layers().count("attn_moe")
    _close(tl, jl, 1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(6):
        jl, jcache = decode(jp, jnp.asarray(tok), jcache)
        tl, tcache = tlm.decode_step(tspec, tp, torch.from_numpy(tok).long(), tcache)
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_greedy_tokens_match_jax_engine(model):
    arch, jspec, jp, tspec, tp = model
    prompts = _prompts(tspec.cfg, 3, 16, seed=1)
    want = JServeEngine(jspec, make_cpu_mesh(1, 1), jp, s_max=32, batch=3,
                        cfg=JServeConfig(max_new_tokens=8)).generate(prompts)
    got = ServeEngine(tspec, tp, s_max=32, batch=3, cfg=ServeConfig(max_new_tokens=8),
                      device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_never_drops_a_token(model):
    """At decode t = B tokens and the capacity is at least 4, so B <= 4 drops none."""
    arch, jspec, jp, tspec, tp = model
    toks = torch.from_numpy(_prompts(tspec.cfg, 3, 9, seed=4)).long()
    _, cache = tlm.prefill(tspec, tp, toks[:, :8], 12)
    with tmoe.record_routing() as log:
        tlm.decode_step(tspec, tp, toks[:, 8], cache)
    assert log and all(bool(r.keep.all()) for r in log)
    assert tmoe.capacity(tspec.cfg, 3) == 4


def test_compute_names_leave_the_router_alone():
    assert "router" not in tcm.COMPUTE_NAMES
    cfg = tconfigs.get_smoke("granite-moe-3b-a800m").replace(compute_dtype="bfloat16")
    tp = tlm.init_params(tlm.build_spec(cfg), device="cpu")
    cast = tcm.cast_for_compute(tp, torch.bfloat16)
    assert cast.blocks[0].moe.router.dtype == torch.float32
    assert cast.blocks[0].moe.w_gate.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "time to first token" in out and "first sequence" in out
