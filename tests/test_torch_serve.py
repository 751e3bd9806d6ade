"""The port's serving path against the JAX package's, end to end on the CPU.

For both SMOKE configs the JAX package's ``lm.init_params(spec, PRNGKey(0))``
goes through numpy into ``interop.lm_params_from_numpy``; then prefill
logits, six decode steps and the greedy tokens of the two ``ServeEngine``s
are compared.  Logits within 1e-4 of the largest (the tolerance of
tests/test_serving_and_data.py's test_decode_matches_prefill); tokens
identical.
"""

import subprocess
import sys
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-1.5b", "rwkv6-3b"]
TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX spec, JAX params, port spec, port params) from one JAX init."""
    arch = request.param
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    jp = jlm.init_params(jspec, jax.random.PRNGKey(0))
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


def test_params_carry_over(model):
    arch, jspec, jp, tspec, tp = model
    assert tlm.param_count(tp) == jlm.param_count(jp)
    assert len(tp.blocks) == tspec.cfg.n_layers
    layer0 = jax.tree.map(lambda a: np.asarray(a)[0], jp["groups"][0]["0"])
    flat = jax.tree_util.tree_flatten_with_path(layer0)[0]
    for path, leaf in flat:
        mod = tp.blocks[0]
        for key in path:
            mod = getattr(mod, key.key)
        np.testing.assert_array_equal(mod.numpy(), leaf)


def test_prefill_and_decode_logits_match_jax(model):
    arch, jspec, jp, tspec, tp = model
    cfg = tspec.cfg
    prompts = _prompts(cfg, 2, 13)
    s_max = 13 + 6
    jl, jcache = jlm.prefill(jspec, jp, {"tokens": jnp.asarray(prompts)}, s_max)
    tl, tcache = tlm.prefill(tspec, tp, torch.from_numpy(prompts).long(), s_max)
    assert tl.shape == (2, cfg.vocab_padded) and tcache["pos"] == 13
    _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(6):
        jl, jcache = jlm.decode_step(jspec, jp, jnp.asarray(tok), jcache)
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
    assert eng.stats.decode_steps == 7 and eng.stats.ttft_s > 0


def test_decode_matches_prefill(model):
    """Prefill over S tokens then decode = prefill over S + i tokens, at every i."""
    arch, jspec, jp, tspec, tp = model
    toks = torch.from_numpy(_prompts(tspec.cfg, 2, 14, seed=2)).long()
    logits, cache = tlm.prefill(tspec, tp, toks[:, :8], 16)
    for i in range(8, 14):
        logits, cache = tlm.decode_step(tspec, tp, toks[:, i], cache)
        want, _ = tlm.prefill(tspec, tp, toks[:, : i + 1], 16)
        _close(logits, want)


def test_padded_vocab_never_wins(model):
    arch, jspec, jp, tspec, tp = model
    cfg = tspec.cfg
    assert cfg.vocab_padded == cfg.vocab  # 512: no padding at SMOKE, so pad it here
    spec = tlm.build_spec(cfg.replace(vocab=500))
    logits, _ = tlm.prefill(spec, tp, torch.from_numpy(_prompts(spec.cfg, 2, 5)).long(), 8)
    assert bool((logits[:, 500:] == -1e30).all())
    eng = ServeEngine(spec, tp, s_max=40, cfg=ServeConfig(max_new_tokens=32, temperature=50.0),
                      device="cpu")
    out = eng.generate(_prompts(spec.cfg, 4, 8))
    assert out.max() < 500 and len(np.unique(out)) > 50  # hot sampling, never a padded id


def test_temperature_sampling_is_seeded(model):
    arch, jspec, jp, tspec, tp = model
    prompts = _prompts(tspec.cfg, 2, 6, seed=3)

    def run(seed):
        eng = ServeEngine(tspec, tp, s_max=16, cfg=ServeConfig(max_new_tokens=10,
                                                               temperature=1.0, seed=seed),
                          device="cpu")
        return eng.generate(prompts)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.max() < tspec.cfg.vocab


def test_engine_leaves_the_callers_params_alone(model):
    arch, jspec, jp, tspec, tp = model
    before = {n: p.data_ptr() for n, p in tp.named_parameters()}
    eng = ServeEngine(tspec, tp, s_max=8, device="cpu")
    assert {n: p.data_ptr() for n, p in tp.named_parameters()} == before
    # fp32 compute: the engine shares every tensor instead of copying
    assert {n: p.data_ptr() for n, p in eng.params.named_parameters()} == before


def test_unported_family_raises():
    """A family without a block layout (an SSM that is not RWKV) raises."""
    cfg = tconfigs.get_smoke("qwen2-1.5b").replace(family="ssm")
    with pytest.raises(NotImplementedError, match="block layout"):
        tlm.build_spec(cfg)


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = tlm.build_spec(tconfigs.get_smoke("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_params(spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "9", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "time to first token" in out and "first sequence" in out


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.serving, repro_torch.models.lm, repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.interop; print('ok')")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
