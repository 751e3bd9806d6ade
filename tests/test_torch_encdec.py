"""The encoder-decoder family (seamless-m4t-medium) in the port, against the JAX package.

The SMOKE config (2 + 2 layers, d_model 64, LayerNorm, fp32): the JAX
package's ``lm.init_params(spec, PRNGKey(0))`` goes through numpy into
``interop.lm_params_from_numpy``, frames and prompts are made with numpy
from a seed, and both packages run them.  Logits within 1e-4 of the
largest (tests/test_torch_families.py's tolerance), greedy tokens
identical; ``project_kv`` and ``cross_attend_decode`` alone within 1e-5 of
the largest (tests/test_torch_lm.py's tolerance for projections).  Frames
are as long as the prompt, or longer or shorter (cross-attention with S !=
T), and one ragged length exercises the halved KV chunks.
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
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.interop import _params_tree, lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.tree import tree_leaves

ARCH = "seamless-m4t-medium"
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """(JAX spec, JAX params, port spec, port params) from one JAX init."""
    jspec = jlm.build_spec(jconfigs.get_smoke(ARCH))
    jp = jax.jit(lambda key: jlm.init_params(jspec, key))(jax.random.PRNGKey(0))
    tspec = tlm.build_spec(tconfigs.get_smoke(ARCH))
    tp = lm_params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    return jspec, jp, tspec, tp


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors never launch


def _inputs(cfg, b, s, t, seed=0):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    frames = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    return prompts, frames


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_configs_are_the_jax_packages():
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke, jconfigs.get_smoke)):
        tc, jc = get_t(ARCH), get_j(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.hd, tc.vocab_padded) == (jc.hd, jc.vocab_padded)


def test_spec_and_params_carry_over(model):
    jspec, jp, tspec, tp = model
    assert tspec.is_encdec and tspec.enc_layers() == ["enc", "enc"]
    assert tspec.layers() == ["dec", "dec"]
    assert [(g.block_types, g.count) for g in tspec.enc_groups] == \
        [(g.block_types, g.count) for g in jspec.enc_groups]
    assert tlm.param_count(tp) == jlm.param_count(jp)
    assert tlm.param_count(tlm.init_params(tspec, device="cpu")) == jlm.param_count(jp)
    layer = jax.tree.map(lambda a: np.asarray(a)[1], jp["enc_groups"][0]["0"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(layer)[0]:
        mod = tp.enc_blocks[1]
        for key in path:
            mod = getattr(mod, key.key)
        np.testing.assert_array_equal(mod.numpy(), leaf)
    # the port's tree is the JAX package's, leaf for leaf
    tree = tlm.params_tree(tspec, tp)
    for (jpath, jl), tl in zip(jax.tree_util.tree_flatten_with_path(jp)[0], tree_leaves(tree),
                               strict=True):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl), err_msg=str(jpath))


def test_project_kv_matches_jax(model):
    """No RoPE on the encoder's keys: k/v within 1e-5 of the largest."""
    jspec, jp, tspec, tp = model
    x = np.random.default_rng(3).normal(size=(2, 11, tspec.cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: np.asarray(a)[0], jp["groups"][0]["0"]["xattn"])
    jk, jv = jattn.project_kv(jspec.cfg, pj, jnp.asarray(x))
    tk, tv = tattn.project_kv(tspec.cfg, _params_tree(pj, torch.device("cpu")),
                              torch.from_numpy(x))
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


@pytest.mark.parametrize("pos", [0, 5, 17])
def test_cross_attend_decode_matches_jax(model, pos):
    """q rotated at ``pos``, the encoder's K/V unrotated and unmasked: 1e-5."""
    jspec, jp, tspec, tp = model
    cfg = tspec.cfg
    rng = np.random.default_rng(pos)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    k = rng.normal(size=(3, 9, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    v = rng.normal(size=(3, 9, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    pj = jax.tree.map(lambda a: np.asarray(a)[1], jp["groups"][0]["0"]["xattn"])
    want = jattn.cross_attend_decode(jspec.cfg, pj, jnp.asarray(x), (jnp.asarray(k),
                                                                     jnp.asarray(v)), pos)
    got = tattn.cross_attend_decode(cfg, _params_tree(pj, torch.device("cpu")),
                                    torch.from_numpy(x), (torch.from_numpy(k),
                                                          torch.from_numpy(v)), pos)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("s,t", [(12, 12), (7, 24), (16, 5), (9, 96)])
def test_attend_train_across_matches_jax(model, s, t):
    """Cross-attention (kv_override) and the encoder's full attention: 1e-4."""
    jspec, jp, tspec, tp = model
    cfg = tspec.cfg.replace(attn_chunk=16)  # T=24 and 96 split into chunks, 5 into ragged ones
    rng = np.random.default_rng(s * t)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: np.asarray(a)[0], jp["groups"][0]["0"]["xattn"])
    pt = _params_tree(pj, torch.device("cpu"))
    jcfg = jspec.cfg.replace(attn_chunk=16)
    kv = jattn.project_kv(jcfg, pj, jnp.asarray(enc))
    want = jattn.attend_train(jcfg, pj, jnp.asarray(x), causal=False, kv_override=kv)
    got = tattn.attend_train(cfg, pt, torch.from_numpy(x), causal=False,
                             kv_override=tattn.project_kv(cfg, pt, torch.from_numpy(enc)))
    _close(got, want)
    want = jattn.attend_train(jcfg, pj, jnp.asarray(enc), causal=False)
    _close(tattn.attend_train(cfg, pt, torch.from_numpy(enc), causal=False), want)


@pytest.mark.parametrize("s,t", [(13, 13), (10, 20), (16, 7)])
def test_prefill_and_decode_logits_match_jax(model, s, t):
    jspec, jp, tspec, tp = model
    cfg = tspec.cfg
    prompts, frames = _inputs(cfg, 2, s, t)
    s_max = s + 6
    prefill = jax.jit(lambda p, b: jlm.prefill(jspec, p, b, s_max))
    decode = jax.jit(lambda p, tok, cache: jlm.decode_step(jspec, p, tok, cache))
    jl, jcache = prefill(jp, {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)})
    tl, tcache = tlm.prefill(tspec, tp, torch.from_numpy(prompts).long(), s_max,
                             frames=torch.from_numpy(frames))
    assert tl.shape == (2, cfg.vocab_padded) and tcache["pos"] == s
    _close(tl, jl)
    assert all(c["xk"].shape == (2, t, cfg.n_kv_heads, cfg.hd) for c in tcache["layers"])
    _close(tcache["enc_out"], jcache["enc_out"])
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(6):
        jl, jcache = decode(jp, jnp.asarray(tok), jcache)
        tl, tcache = tlm.decode_step(tspec, tp, torch.from_numpy(tok).long(), tcache)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_decode_matches_prefill(model):
    """Prefill over S tokens then decode = prefill over S + i tokens, same frames."""
    jspec, jp, tspec, tp = model
    prompts, frames = _inputs(tspec.cfg, 2, 12, 9, seed=2)
    toks, fr = torch.from_numpy(prompts).long(), torch.from_numpy(frames)
    logits, cache = tlm.prefill(tspec, tp, toks[:, :8], 16, frames=fr)
    for i in range(8, 12):
        logits, cache = tlm.decode_step(tspec, tp, toks[:, i], cache)
        want, _ = tlm.prefill(tspec, tp, toks[:, : i + 1], 16, frames=fr)
        _close(logits, want)


@pytest.mark.parametrize("t", [16, 40])
def test_greedy_tokens_match_jax_engine(model, t):
    jspec, jp, tspec, tp = model
    prompts, frames = _inputs(tspec.cfg, 3, 16, t, seed=1)
    want = JServeEngine(jspec, make_cpu_mesh(1, 1), jp, s_max=32, batch=3,
                        cfg=JServeConfig(max_new_tokens=8)).generate(prompts, frames=frames)
    eng = ServeEngine(tspec, tp, s_max=32, batch=3, cfg=ServeConfig(max_new_tokens=8),
                      device="cpu")
    got = eng.generate(prompts, frames=frames)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_frames_go_with_the_encoder_decoder_only(model):
    jspec, jp, tspec, tp = model
    prompts, frames = _inputs(tspec.cfg, 1, 4, 4)
    with pytest.raises(ValueError, match="frames"):
        tlm.prefill(tspec, tp, torch.from_numpy(prompts).long(), 8)
    dense = tlm.build_spec(tconfigs.get_smoke("granite-3-2b"))
    with pytest.raises(ValueError, match="frames"):
        tlm.prefill(dense, tlm.init_params(dense, device="cpu"),
                    torch.from_numpy(prompts).long(), 8, frames=torch.from_numpy(frames))


def test_serve_launcher_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "time to first token" in out and "first sequence" in out
