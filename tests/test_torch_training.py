"""The port's training path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
package's ``lm.init_params`` through numpy, laid out as its tree
(``interop.lm_tree_from_numpy``).  Tolerances:

- ``loss_fn`` at SMOKE for every family: the loss within rtol 1e-5, each
  gradient leaf within rtol 1e-4 / atol 1e-5 (the JAX package's
  ``test_grad_accumulation_matches_full_batch`` tolerance), the atol taken
  of the leaf's largest value where that exceeds 1: both sum the same fp32
  terms in another order, and their rounding grows with the leaf (rwkv6's
  embedding gradient reaches 5.3, an RMS norm over 0.02-scale embeddings
  scaling it by ~50; one of its 32768 entries differs by 1.95e-5);
- one AdamW or Adafactor step: parameters and moments within rtol 1e-5 /
  atol 1e-7 (the same fp32 elementwise formulas; fused multiply-adds and
  the reductions' order differ in the last bits);
- the data pipeline, checkpoints and a restart: bitwise.

The kernels (``flash_attention``, ``wkv``) and their autograd Functions run
only on the card (tests/test_torch_cuda.py); here the CPU tensors take the
plain chunked forms and no kernel launches.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_cpu_mesh
from repro.models import lm as jlm
from repro.training import checkpoint as jckpt
from repro.training import optim as joptim
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import lm_tree_from_numpy, opt_state_from_numpy, tree_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.common import ArchConfig
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optim as toptim
from repro_torch.training import train_step as tts
from repro_torch.training import (FailureInjector, InjectedFailure, StepTimer,
                                  StragglerWatchdog)
from repro_torch.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
# (arch, family) -- llama4 is the MoE with the dense / MoE alternation and a
# shared expert, zamba2 the hybrid with its shared block
FAMILIES = [("granite-3-2b", "dense"), ("llama4-maverick-400b-a17b", "moe"),
            ("granite-moe-3b-a800m", "moe"), ("zamba2-7b", "hybrid"), ("rwkv6-3b", "ssm"),
            ("seamless-m4t-medium", "encdec"), ("chameleon-34b", "vlm")]


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launch_counts()
    yield
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors never launch


def _jax_init(arch):
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    jp = jax.jit(lambda key: jlm.init_params(jspec, key))(jax.random.PRNGKey(0))
    return jspec, jp


def _batch(cfg, b=2, s=16, t=8, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_mode == "frames":
        out["frames"] = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    return out


def _assert_tree_close(got, want, rtol, atol, leaf_scale=False):
    """Leaf by leaf; with ``leaf_scale`` the atol is of max(1, the leaf's largest |value|)."""
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, (path, w) in zip(got_leaves, want_leaves):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max(initial=0.0))) if leaf_scale else 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale, err_msg=str(path))


def _assert_tree_equal(got, want):
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, (path, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8)), path


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,family", FAMILIES)
def test_loss_and_grads_match_jax(arch, family):
    jspec, jp = _jax_init(arch)
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    assert tspec.cfg.family == family
    batch = _batch(tspec.cfg)
    jfn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jspec, p, b), has_aux=True))
    (jl, jm), jg = jfn(jp, {k: jnp.asarray(v) for k, v in batch.items()})

    params = lm_tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tb = tts.batch_to_device(batch, "cpu")
    loss, metrics = tlm.loss_fn(tspec, tlm.params_view(tspec, params), tb)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("xent", "lb_loss", "z_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7)
    if family == "moe":
        assert metrics["lb_loss"].item() > 0 and metrics["z_loss"].item() > 0
    _assert_tree_close(list(grads), jax.tree.leaves(jg), rtol=1e-4, atol=1e-5, leaf_scale=True)


def test_remat_checkpoints_each_block_and_loss_chunk():
    """cfg.remat recomputes in the backward: the same loss and gradients."""
    cfg = tconfigs.get_smoke("granite-3-2b").replace(vocab_chunk=4)
    spec, spec_r = tlm.build_spec(cfg), tlm.build_spec(cfg.replace(remat=True))
    params, _ = tts.init_state(spec, toptim.OptConfig(), device="cpu")
    batch = tts.batch_to_device(_batch(cfg), "cpu")
    out = []
    for sp in (spec, spec_r):
        loss, _ = tlm.loss_fn(sp, tlm.params_view(sp, params), batch)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_params_tree_is_the_jax_layout():
    """The port's own init as a tree: the JAX package's structure, shapes and
    dtypes, for every SMOKE config and zamba2 at 2 layers (a group of no
    layers: stacks with a zero leading axis)."""
    cases = [(arch, {}) for arch in tconfigs.ARCH_IDS] + [("zamba2-7b", {"n_layers": 2})]
    for arch, kw in cases:
        jspec = jlm.build_spec(jconfigs.get_smoke(arch).replace(**kw))
        shapes = jax.eval_shape(lambda k: jlm.init_params(jspec, k), jax.random.PRNGKey(0))
        tspec = tlm.build_spec(tconfigs.get_smoke(arch).replace(**kw))
        tree = tlm.params_tree(tspec, tlm.init_params(tspec, device="cpu"))
        want = jax.tree_util.tree_flatten_with_path(shapes)[0]
        got = list(tree_paths(tree))
        assert len(got) == len(want), arch
        for (gp, g), (wp, w) in zip(got, want):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), (arch, wp)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    cfg = toptim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = joptim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        got = toptim.lr_schedule(cfg, s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(joptim.lr_schedule(jcfg, jnp.asarray(s))),
                                   rtol=1e-6)
    lrs = [float(toptim.lr_schedule(cfg, s)) for s in (0, 9, 10, 50, 99)]
    assert lrs[0] < lrs[1] <= lrs[2] and lrs[2] >= lrs[3] >= lrs[4] >= 0.1 * 0.99


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0, "b": torch.ones(3) * 10.0}
    clipped, norm = toptim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(700), rel=1e-6)
    assert float(toptim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)
    small = {"a": torch.full((3,), 0.1)}
    _, n = toptim.clip_by_global_norm(small, 1.0)  # under the limit: unchanged
    assert torch.equal(small["a"], torch.full((3,), 0.1)) and float(n) < 1.0
    jg = {"a": jnp.ones((4,)) * 10.0, "b": jnp.ones((3,)) * 10.0}
    np.testing.assert_allclose(float(toptim.global_norm({"a": torch.ones(4) * 10.0,
                                                         "b": torch.ones(3) * 10.0})),
                               float(joptim.global_norm(jg)), rtol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_step_matches_jax(name):
    """Two steps from the JAX package's state after its first (llama4 SMOKE:
    2-D and stacked 3-D expert leaves, 1-D norms stacked to 2-D)."""
    jspec, jp = _jax_init("llama4-maverick-400b-a17b")
    jcfg = joptim.OptConfig(name=name, lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = toptim.OptConfig(name=name, lr=1e-2, warmup_steps=2, total_steps=10)
    jinit, jupd = joptim.make_optimizer(jcfg)
    _, tupd = toptim.make_optimizer(tcfg)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jp)
             for _ in range(2)]
    jstate = jinit(jp)
    jp1, jstate = jax.jit(jupd)(grads[0], jstate, jp)
    params = lm_tree_from_numpy(jax.tree.map(np.asarray, jp1), device="cpu")
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    _assert_tree_equal(state, jstate)
    jp2, jstate2 = jax.jit(jupd)(grads[1], jstate, jp1)
    params, state = tupd(tree_from_numpy(grads[1], "cpu"), state, params)
    assert int(state["count"]) == 2 and state["count"].dtype == torch.int32
    _assert_tree_close(params, jp2, rtol=1e-5, atol=1e-7)
    _assert_tree_close(state, jstate2, rtol=1e-5, atol=1e-7)


def test_adafactor_memory_factored():
    p = {"w": torch.zeros((128, 64)), "b": torch.zeros((64,)), "s": torch.zeros((3, 8, 5))}
    st = toptim.adafactor_init(p)
    assert st["v"]["w"]["vr"].shape == (128,) and st["v"]["w"]["vc"].shape == (64,)
    assert st["v"]["b"]["v"].shape == (64,)
    assert st["v"]["s"]["vr"].shape == (3, 8) and st["v"]["s"]["vc"].shape == (3, 5)
    # the factored moments flatten as the JAX package's ("vc" before "vr")
    jst = joptim.adafactor_init({k: jnp.zeros(tuple(v.shape)) for k, v in p.items()})
    assert [x.shape for x in jax.tree.leaves(jst)] == \
        [tuple(x.shape) for x in tree_leaves(st)]


def test_train_step_matches_jax():
    """One whole step (gradient, clip, AdamW) from the same parameters: the
    metrics within rtol 1e-5, the new parameters within rtol 1e-4 / atol 1e-5.

    Both take eps = 1e-3: the first AdamW step moves an entry by
    lr g / (|g| + eps), and with the default eps of 1e-8 an entry whose g is
    near 1e-8 turns a last-bits difference of g into a difference of up to
    2 lr (entries of w_down and the embedding moved by 1.1e-5 and 3.3e-5 at
    lr 1e-2).  With eps = 1e-3 a relative difference d of g moves the update
    by at most d / 4 of lr."""
    arch = "granite-3-2b"
    jspec, jp = _jax_init(arch)
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    mesh = make_cpu_mesh(1, 1)
    jstep, *_ = jts.make_train_step(jspec, mesh, joptim.OptConfig(**ocfg), donate=False)
    jopt = joptim.adamw_init(jp)
    batch = _batch(tspec.cfg, b=4, s=16)
    with mesh:
        jp1, _, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    step = tts.make_train_step(tspec, toptim.OptConfig(**ocfg), device="cpu")
    params, opt, tm = step(params, toptim.adamw_init(params), batch)
    for k in ("loss", "grad_norm", "xent"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    _assert_tree_close(params, jp1, rtol=1e-4, atol=1e-5)


def test_grad_accumulation_matches_full_batch():
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=256, remat=False, compute_dtype="float32")
    spec = tlm.build_spec(cfg)
    ocfg = toptim.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg, b=8, s=16, seed=3)
    out = []
    for accum in (1, 4):
        params, opt = tts.init_state(spec, ocfg, device="cpu")
        step = tts.make_train_step(spec, ocfg, accum=accum, device="cpu")
        out.append(step(params, opt, batch))
    (p1, _, m1), (p4, _, m4) = out
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_train_step(spec, ocfg, accum=3, device="cpu")(*tts.init_state(
            spec, ocfg, device="cpu"), batch)


# ---------------------------------------------------------------------------
# the data pipeline: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,frames_dim", [(0, 0, 0), (0, 5, 16), (3, 17, 64),
                                                  (2**32 - 2, 2**32 - 1, 8)])
def test_host_batch_is_bitwise_the_jax_packages(seed, step, frames_dim):
    kw = dict(vocab=49155, seq_len=37, global_batch=5, seed=seed, frames_dim=frames_dim)
    want = jpipe.host_batch(jpipe.DataConfig(**kw), step)
    got = tpipe.host_batch(tpipe.DataConfig(**kw), step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8)), k


def test_prefetcher_yields_the_steps_in_order():
    cfg = tpipe.DataConfig(vocab=100, seq_len=8, global_batch=2, seed=1)
    pf = tpipe.Prefetcher(cfg, start_step=3)
    try:
        for step in (3, 4, 5):
            np.testing.assert_array_equal(pf.next()["tokens"], tpipe.host_batch(cfg, step)["tokens"])
    finally:
        pf.close()
    assert not pf._t.is_alive()


# ---------------------------------------------------------------------------
# checkpoints: across the packages, bitwise
# ---------------------------------------------------------------------------


def _jax_state(arch, name):
    """The JAX package's params and optimizer state after one update."""
    jspec, jp = _jax_init(arch)
    jinit, jupd = joptim.make_optimizer(joptim.OptConfig(name=name, lr=1e-2, warmup_steps=1))
    rng = np.random.default_rng(11)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jp)
    jp1, jst = jax.jit(jupd)(g, jinit(jp), jp)
    return jspec, {"params": jp1, "opt": jst}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "seamless-m4t-medium"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, arch, name):
    jspec, jstate = _jax_state(arch, name)
    jckpt.save(str(tmp_path), 3, jstate, extra={"loss": 1.5})
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    ocfg = toptim.OptConfig(name=name)
    params, opt = tts.init_state(tspec, ocfg, device="cpu")
    state, extra, step = tckpt.restore(str(tmp_path), 3, {"params": params, "opt": opt})
    assert step == 3 and extra == {"loss": 1.5}
    _assert_tree_equal(state, jstate)
    assert all(x.requires_grad for x in tree_leaves(state["params"]))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_port_checkpoint_restores_into_jax(tmp_path, arch, name):
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    ocfg = toptim.OptConfig(name=name, lr=1e-2, warmup_steps=1)
    params, opt = tts.init_state(tspec, ocfg, seed=4, device="cpu")
    step = tts.make_train_step(tspec, ocfg, device="cpu")
    params, opt, _ = step(params, opt, _batch(tspec.cfg))
    tckpt.save(str(tmp_path), 1, {"params": params, "opt": opt}, extra={"arch": arch})
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    pshape = jax.eval_shape(lambda k: jlm.init_params(jspec, k), jax.random.PRNGKey(0))
    oshape = jax.eval_shape(joptim.make_optimizer(joptim.OptConfig(name=name))[0], pshape)
    back, extra, s = jckpt.restore(str(tmp_path), 1, {"params": pshape, "opt": oshape})
    assert s == 1 and extra == {"arch": arch}
    _assert_tree_equal({"params": params, "opt": opt}, back)


def test_bf16_leaves_keep_their_bits(tmp_path):
    """bf16 leaves are written as the JAX package writes them (raw 2-byte
    values, ``bfloat16`` in the manifest) and read back bit for bit."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)).to(torch.bfloat16),
            "n": [torch.arange(4, dtype=torch.int32)]}
    tckpt.save(str(tmp_path), 2, tree)
    back, _, _ = tckpt.restore(str(tmp_path), 2, tree)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], tree["w"])
    assert torch.equal(back["n"][0], tree["n"][0])
    import ml_dtypes

    jtree = {"w": np.asarray(tree["w"].float().numpy()).astype(ml_dtypes.bfloat16)}
    jckpt.save(str(tmp_path / "j"), 1, jtree)
    back, _, _ = tckpt.restore(str(tmp_path / "j"), 1, {"w": tree["w"]})
    assert torch.equal(back["w"], tree["w"])


def test_checkpoint_atomicity_and_template_checks(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.arange(10), "y": {"z": torch.ones((3, 3))}}
    tckpt.save(d, 1, tree)
    os.makedirs(os.path.join(d, "step_00000002.tmp"), exist_ok=True)  # a crashed writer
    assert tckpt.latest_step(d) == 1 and tckpt.latest_step(str(tmp_path / "none")) is None
    back, _, step = tckpt.restore(d, 1, tree)
    assert step == 1 and torch.equal(back["x"], torch.arange(10))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, 1, {"x": tree["x"]})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(d, 1, {"x": torch.arange(9), "y": {"z": torch.ones((3, 3))}})


def test_async_checkpointer_copies_before_returning_and_surfaces_errors(tmp_path):
    t = torch.zeros(1000)
    ac = tckpt.AsyncCheckpointer()
    ac.save(str(tmp_path), 1, {"t": t})
    t.add_(1.0)  # the optimizer updates in place right after a save
    ac.wait()
    back, _, _ = tckpt.restore(str(tmp_path), 1, {"t": t})
    assert float(back["t"].abs().max()) == 0.0
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    ac.save(str(blocker / "x"), 1, {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        ac.wait()


# ---------------------------------------------------------------------------
# restart, watchdog, failure injection, the launcher
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms(True) for one test: the embedding's
    backward (index_put_ with accumulate) sums in thread order otherwise."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch", ["granite-3-2b", "seamless-m4t-medium"])
def test_restart_is_bitwise_the_uninterrupted_run(tmp_path, arch, deterministic):
    """Crash at step 4 (after the step-3 checkpoint), restart, finish: the
    losses of steps 3..5 and the final state equal the straight run's, bitwise
    (deterministic algorithms on)."""
    cfg = tconfigs.get_smoke(arch).replace(remat=True)
    kw = dict(steps=6, batch=4, seq=32, ckpt_every=3, log_every=100, device="cpu")
    pa, oa, straight = ttrain.train_loop(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(InjectedFailure):
        ttrain.train_loop(cfg, ckpt_dir=str(tmp_path / "b"), fail_at=4, **kw)
    assert tckpt.latest_step(str(tmp_path / "b")) == 3
    pb, ob, resumed = ttrain.train_loop(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(resumed) == 3 and resumed == straight[3:]
    for a, b in zip(tree_leaves({"p": pa, "o": oa}), tree_leaves({"p": pb, "o": ob})):
        assert torch.equal(a, b)


def test_straggler_watchdog_flags_slow_steps():
    dog = StragglerWatchdog(factor=2.0, warmup_steps=2)
    for i in range(5):
        assert not dog.observe(i, 0.1)
    assert dog.observe(5, 0.5)  # 5x EMA
    assert dog.flags and dog.flags[0][0] == 5
    assert not dog.observe(6, 0.1)  # EMA not poisoned by the outlier


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_step=3)
    inj.check(2)
    with pytest.raises(InjectedFailure):
        inj.check(3)
    inj.check(3)  # second pass (post-restart) does not re-fire


def test_step_timer_on_the_cpu():
    with StepTimer("cpu") as t:
        sum(range(1000))
    with StepTimer() as u:
        pass
    assert t.dt >= 0 and u.dt >= 0


def test_train_launcher_exits_42_then_resumes(tmp_path, capsys):
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "6", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SystemExit) as e:
        ttrain.main(argv + ["--fail-at", "3"])
    assert e.value.code == 42
    assert "injected node failure at step 3" in capsys.readouterr().out
    ttrain.main(argv)
    out = capsys.readouterr().out
    assert "restored step 2" in out and "[train] done" in out
    # --data / --model train on a device grid: the run's last checkpoint
    # resumes on a 2x1 grid of the CPU (nothing left to run at step 6)
    ttrain.main(argv + ["--data", "2"])
    assert "restored step 6" in capsys.readouterr().out


def test_training_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.training, repro_torch.data, repro_torch.launch.train; "
            "print('ok')")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
