"""The other dense configs and chameleon (vlm) in the port, against the JAX package.

granite-3-2b (GQA, tied embeddings), stablelm-1.6b (MHA, LayerNorm),
deepseek-67b (GQA, bf16 parameters at full size) and chameleon-34b (the
vlm family, built as dense, with qk-norm).  For each SMOKE config the JAX
package's ``lm.init_params(spec, PRNGKey(0))`` goes through numpy into
``interop.lm_params_from_numpy``; then prefill logits, six decode steps and
the greedy tokens of the two ``ServeEngine``s are compared, with
``tests/test_torch_serve.py``'s tolerances: logits within 1e-4 of the
largest, tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_cpu_mesh
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine

ARCHS = ["granite-3-2b", "stablelm-1.6b", "deepseek-67b", "chameleon-34b"]
TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX spec, JAX params, port spec, port params) from one JAX init."""
    arch = request.param
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    jp = jax.jit(lambda key: jlm.init_params(jspec, key))(jax.random.PRNGKey(0))
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    tp = lm_params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jspec, jp, tspec, tp


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors never launch


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _jit_serve(jspec):
    """The JAX prefill and decode step, jitted (eager JAX dispatches op by op)."""
    prefill = jax.jit(lambda p, toks, s_max: jlm.prefill(jspec, p, {"tokens": toks}, s_max),
                      static_argnums=2)
    return prefill, jax.jit(lambda p, tok, cache: jlm.decode_step(jspec, p, tok, cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke, jconfigs.get_smoke)):
        tc, jc = get_t(arch), get_j(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.hd, tc.vocab_padded) == (jc.hd, jc.vocab_padded)
        assert tc.pdtype == getattr(torch, jc.param_dtype)


def test_registry_holds_every_architecture():
    """Every JAX ``ARCH_IDS`` entry, in its order, builds a spec in the port
    at both sizes: the same groups (and encoder groups) as the JAX package's."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and len(tconfigs.ARCH_IDS) == 10
    for arch in jconfigs.ARCH_IDS:
        for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                             (tconfigs.get_smoke, jconfigs.get_smoke)):
            got, want = tlm.build_spec(get_t(arch)), jlm.build_spec(get_j(arch))
            for g_groups, w_groups in ((got.groups, want.groups),
                                       (got.enc_groups, want.enc_groups)):
                assert [(g.block_types, g.count, g.overrides) for g in g_groups] == \
                    [(g.block_types, g.count, g.overrides) for g in w_groups], arch
            assert got.is_encdec == want.is_encdec


def _wrapper_calls():
    """(name, call(t)) for every kernel wrapper; ``t(x)`` makes a CPU tensor of x."""
    rng = np.random.default_rng(1)
    a = rng.random((32, 32)).astype(np.float32)
    z = rng.normal(size=(32, 5)).astype(np.float32)
    r = rng.normal(size=(2, 8, 4)).astype(np.float32)
    from repro_torch.kernels import (block_matmul, cad_score, edge_projection, emb_query,
                                     flash_attention, stream_gemm, wkv)

    def topk(t, update_only=False):
        vals, ids = emb_query.topk_init(1, 4, largest=True, device="cpu")
        args = (t(z[:1]), torch.zeros((1, 1)), torch.zeros((1, 32)),
                torch.full((1, 1), -1, dtype=torch.int32), 1.0)
        if update_only:
            merger = emb_query.PanelTopk(torch.from_numpy(z[:1]), *args[1:], topk=4,
                                         panel_rows=32)
            return merger.update(t(z), 0)
        return emb_query.panel_topk_update(vals, ids, args[0], t(z), args[1], args[2], 1.0, 0,
                                           args[3], topk=4)

    return [
        ("block_matmul", lambda t: block_matmul.block_matmul(t(a), t(a))),
        ("split_tf32", lambda t: block_matmul.split_tf32(t(a))),
        ("edge_projection", lambda t: edge_projection.edge_projection(t(a), seed=0, k=5)),
        ("cad_scores", lambda t: cad_score.cad_scores(t(a), t(a), t(z), t(z), 1.0, 1.0)),
        ("cad_scores_tile", lambda t: cad_score.cad_scores_tile(t(a), t(a), t(z), t(z), t(z),
                                                                t(z), 1.0, 1.0)),
        ("stream_gemm", lambda t: stream_gemm.stream_gemm(t(a), t(z), t(z))),
        ("fused_panel_matvec", lambda t: stream_gemm.fused_panel_matvec(t(a), t(z), t(z),
                                                                        t(z))),
        ("panel_topk_update", topk),
        ("PanelTopk.update", lambda t: topk(t, update_only=True)),
        ("wkv", lambda t: wkv.wkv(t(r), t(r), t(r), -torch.ones(r.shape), torch.zeros((2, 4)))),
        ("flash_attention", lambda t: flash_attention.flash_attention(t(r), t(r[:1]), t(r[:1]),
                                                                      groups=2)),
    ]


@pytest.mark.parametrize("name,call", _wrapper_calls(), ids=[n for n, _ in _wrapper_calls()])
def test_kernel_wrappers_refuse_operands_that_require_grad(name, call):
    """No kernel has a backward: a wrapper given an operand that requires grad
    under grad mode raises (the gradient would stop there), on the CPU as on
    the card; under no_grad, or without such an operand, it runs."""
    def grad_t(x):
        return torch.from_numpy(np.array(x)).requires_grad_(True)

    with pytest.raises(RuntimeError, match="requires grad"):
        call(grad_t)
    with torch.no_grad():
        call(grad_t)
    call(lambda x: torch.from_numpy(np.array(x)))


def test_build_spec_takes_every_decoder_family():
    base = tconfigs.get_smoke("granite-3-2b")
    for family in ("dense", "vlm"):
        spec = tlm.build_spec(base.replace(family=family))
        assert spec.groups == (tlm.GroupSpec(("attn",), base.n_layers),)
    for arch in tconfigs.ARCH_IDS:  # moe, hybrid and rwkv, each as the JAX package builds it
        cfg = tconfigs.get_smoke(arch)
        want = jlm.build_spec(jconfigs.get_smoke(arch))
        got = tlm.build_spec(cfg)
        assert [(g.block_types, g.count, g.overrides) for g in got.groups] == \
            [(g.block_types, g.count, g.overrides) for g in want.groups]
        assert got.has_shared_attn == want.has_shared_attn
    spec = tlm.build_spec(base.replace(family="encdec", enc_layers=3, dec_layers=2))
    assert spec.is_encdec and spec.enc_layers() == ["enc"] * 3 and spec.layers() == ["dec"] * 2


def test_params_carry_over(model):
    arch, jspec, jp, tspec, tp = model
    assert tlm.param_count(tp) == jlm.param_count(jp)
    assert tlm.param_count(tlm.init_params(tspec, device="cpu")) == jlm.param_count(jp)
    assert len(tp.blocks) == tspec.cfg.n_layers
    layer = jax.tree.map(lambda a: np.asarray(a)[1], jp["groups"][0]["0"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(layer)[0]:
        mod = tp.blocks[1]
        for key in path:
            mod = getattr(mod, key.key)
        np.testing.assert_array_equal(mod.numpy(), leaf)


def test_prefill_and_decode_logits_match_jax(model):
    arch, jspec, jp, tspec, tp = model
    cfg = tspec.cfg
    prompts = _prompts(cfg, 2, 13)
    s_max = 13 + 6
    prefill, decode = _jit_serve(jspec)
    jl, jcache = prefill(jp, jnp.asarray(prompts), s_max)
    tl, tcache = tlm.prefill(tspec, tp, torch.from_numpy(prompts).long(), s_max)
    assert tl.shape == (2, cfg.vocab_padded) and tcache["pos"] == 13
    _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(6):
        jl, jcache = decode(jp, jnp.asarray(tok), jcache)
        tl, tcache = tlm.decode_step(tspec, tp, torch.from_numpy(tok).long(), tcache)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_greedy_tokens_match_jax_engine(model):
    arch, jspec, jp, tspec, tp = model
    prompts = _prompts(tspec.cfg, 3, 16, seed=1)
    want = JServeEngine(jspec, make_cpu_mesh(1, 1), jp, s_max=32, batch=3,
                        cfg=JServeConfig(max_new_tokens=8)).generate(prompts)
    eng = ServeEngine(tspec, tp, s_max=32, batch=3, cfg=ServeConfig(max_new_tokens=8),
                      device="cpu")
    got = eng.generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_matches_prefill(model):
    """Prefill over S tokens then decode = prefill over S + i tokens, at every i."""
    arch, jspec, jp, tspec, tp = model
    toks = torch.from_numpy(_prompts(tspec.cfg, 2, 12, seed=2)).long()
    logits, cache = tlm.prefill(tspec, tp, toks[:, :8], 16)
    for i in range(8, 12):
        logits, cache = tlm.decode_step(tspec, tp, toks[:, i], cache)
        want, _ = tlm.prefill(tspec, tp, toks[:, : i + 1], 16)
        _close(logits, want)


def test_bf16_params_are_shared_by_the_engine():
    """deepseek and chameleon keep bf16 parameters at full size: the engine's
    bf16 compute copy shares them instead of doubling the weights."""
    cfg = tconfigs.get_smoke("chameleon-34b").replace(param_dtype="bfloat16",
                                                       compute_dtype="bfloat16")
    spec = tlm.build_spec(cfg)
    tp = tlm.init_params(spec, device="cpu")
    assert {p.dtype for p in tp.parameters()} == {torch.bfloat16}
    eng = ServeEngine(spec, tp, s_max=8, device="cpu")
    assert {n: p.data_ptr() for n, p in eng.params.named_parameters()} == \
        {n: p.data_ptr() for n, p in tp.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "time to first token" in out and "first sequence" in out
