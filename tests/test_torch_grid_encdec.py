"""The encoder-decoder family (seamless-m4t-medium) on a device grid: the
port on 2x2, 1x4, 4x1 and 2x2x2 CPU grids against the JAX package on
``mesh22`` and against the port's own 1x1 path.

The encoder reads frame embeddings laid out by ``(batch, seq, embed)``;
each decoder block's cross-attention projects every KV head of the
encoder's positions on each tile and attends with the tile's own q heads,
non-causally.  The SMOKE model's weights come from the JAX package's
``lm.init_params`` (``PRNGKey(3)``) through numpy (``interop``); tokens and
frames from numpy ``default_rng``.  Tolerances (fp32 throughout),
``tests/test_torch_grid_lm.py``'s and ``tests/test_torch_training.py``'s:

- the loss on every grid against JAX on ``mesh22`` and port 1x1 (fsdp and
  seqshard on 2x2, 1x4 and 4x1 against 1x1): rel 1e-5;
- every gradient on 2x2 against JAX's: rtol 1e-4, entries within 1e-4 of
  the leaf's largest;
- one AdamW step on 2x2 against JAX's ``make_train_step`` on ``mesh22``:
  loss, grad norm and xent rel 1e-5, parameters rtol 1e-4 / atol 1e-5;
- prefill and decode logits within 1e-5 of the largest of JAX's on
  ``mesh22``; greedy tokens equal to the JAX ``ServeEngine`` on ``mesh22``
  and to port 1x1;
- the grid cross-attention against the one-device one: within 1e-5 of the
  largest; ``global_batch_for``'s frames bitwise ``host_batch``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.training import optim as joptim
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.core import collectives as coll
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import lm_grid_params_from_numpy, lm_params_from_numpy, lm_tree_from_numpy
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import serve_rules
from repro_torch.training import optim as toptim
from repro_torch.training import train_step as tts
from repro_torch.tree import tree_leaves

ARCH = "seamless-m4t-medium"
JSPEC = jlm.build_spec(jconfigs.get_smoke(ARCH))
TSPEC = tlm.build_spec(tconfigs.get_smoke(ARCH))
D = TSPEC.cfg.d_model
GRIDS = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1), "pod2x2x2": (2, 2, 2)}


def _grid(name):
    shape = GRIDS[name]
    return make_cpu_mesh(*shape[1:], pod=shape[0]) if len(shape) == 3 else make_cpu_mesh(*shape)


@pytest.fixture(scope="module")
def weights():
    """The JAX package's SMOKE weights (PRNGKey(3)) and the same as numpy."""
    p = jlm.init_params(JSPEC, jax.random.PRNGKey(3))
    return p, jax.tree.map(np.asarray, p)


def _batch(b=4, s=16, t=16, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 512, size=(b, s)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1),
            "frames": rng.normal(size=(b, t, D)).astype(np.float32)}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _rows(logits: coll.Sharded, grid) -> np.ndarray:
    ax = coll.entry_axes(logits.spec[0])
    return torch.cat([logits[t] for t in range(grid.n_tiles)
                      if all(grid.coords(t)[a] == 0 for a in grid.axis_names if a not in ax)]
                     ).numpy()


def _port_loss(np_tree, batch, grid=None, preset="baseline", grads=False):
    tree = lm_tree_from_numpy(np_tree, "cpu")
    if grid is None:
        loss, _ = tlm.loss_fn(TSPEC, tlm.params_view(TSPEC, tree),
                              tts.batch_to_device(batch, "cpu"))
        return float(loss.detach()), None
    rules = None if preset == "baseline" else tdry.RULE_PRESETS[preset](grid)
    pspecs, _ = tts.grid_specs(TSPEC, toptim.OptConfig(), grid, rules)
    run = tcm.GridRun(tts.train_rules(TSPEC, grid, rules))
    loss, _, gtrees = tts.grid_loss_and_grad(TSPEC, tcm.shard_tree(tree, pspecs, grid),
                                             tts.place_batch(batch, run), pspecs, run)
    vals = {float(x) for x in loss}
    assert len(vals) == 1, f"the loss differs between tiles: {vals}"
    return vals.pop(), tcm.unshard_tree(gtrees, pspecs, grid) if grads else None


_JAX = {}


def _jax_loss_and_grad(params, batch, mesh):
    if "loss" not in _JAX:
        rules = jcm.attach_axis_sizes(dict(jcm.DEFAULT_RULES), mesh)
        with mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, bb: jlm.loss_fn(JSPEC, p, bb, rules=rules), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX["loss"] = (float(loss), g)
    return _JAX["loss"]


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_grid_loss_matches_jax_mesh22_and_1x1(weights, grid_name, mesh22):
    params, np_tree = weights
    batch = _batch()
    got, _ = _port_loss(np_tree, batch, _grid(grid_name))
    assert got == pytest.approx(_jax_loss_and_grad(params, batch, mesh22)[0], rel=1e-5)
    assert got == pytest.approx(_port_loss(np_tree, batch)[0], rel=1e-5)


def test_grid_grads_match_jax_mesh22(weights, mesh22):
    """Every leaf's gradient on 2x2 (the encoder's, the cross-attention's
    K/V projections through the encoder output) against JAX's."""
    params, np_tree = weights
    batch = _batch()
    _, grads = _port_loss(np_tree, batch, make_cpu_mesh(2, 2), grads=True)
    _, jg = _jax_loss_and_grad(params, batch, mesh22)
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(jg), strict=True):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("preset", ["fsdp", "seqshard"])
def test_presets_match_1x1(weights, preset):
    """fsdp and seqshard (the decoder's and the encoder's positions over
    model: the cross-attention gathers the encoder's whole) on 2x2, 1x4 and
    4x1 against 1x1."""
    _, np_tree = weights
    batch = _batch()
    one, _ = _port_loss(np_tree, batch)
    for shape in ((2, 2), (1, 4), (4, 1)):
        got, _ = _port_loss(np_tree, batch, make_cpu_mesh(*shape), preset)
        assert got == pytest.approx(one, rel=1e-5), shape


def test_grid_train_step_matches_jax(weights, mesh22):
    """One AdamW step with frames from the same parameters and zero state on
    2x2 against JAX on ``mesh22`` (eps 1e-3, as ``test_torch_training.py``
    explains)."""
    params, np_tree = weights
    kw = dict(name="adamw", lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    jstep, *_ = jts.make_train_step(JSPEC, mesh22, joptim.OptConfig(**kw), donate=False)
    batch = _batch(8, 16, 16, seed=5)
    with mesh22:
        jp1, _, jm = jstep(params, joptim.make_optimizer(joptim.OptConfig(**kw))[0](params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    grid = make_cpu_mesh(2, 2)
    ocfg = toptim.OptConfig(**kw)
    pspecs, ospecs = tts.grid_specs(TSPEC, ocfg, grid)
    tree = lm_tree_from_numpy(np_tree, "cpu")
    pg = tcm.shard_tree(tree, pspecs, grid)
    sg = tcm.shard_tree(toptim.make_optimizer(ocfg)[0](tree), ospecs, grid)
    pg, sg, tm = tts.make_train_step(TSPEC, ocfg, grid=grid)(pg, sg, batch)
    for k in ("loss", "grad_norm", "xent"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    got = tcm.unshard_tree(pg, pspecs, grid)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(jp1), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_compressed_step_on_pod_grid():
    """One int8 compressed step with frames on 2x2x2: finite, the loss the
    uncompressed step's."""
    ocfg = toptim.OptConfig(lr=1e-3)
    pod = make_cpu_mesh(2, 2, pod=2)
    step, ef_init, _ = tts.make_compressed_train_step(TSPEC, pod, ocfg)
    params, opt = tts.init_pod_state(TSPEC, ocfg, pod, seed=2)
    batch = _batch(8, 16, 16, seed=5)
    _, _, m, _ = step(params, opt, batch, ef_init(params))
    plain, _ = tts.init_state(TSPEC, ocfg, seed=2, grid=pod)
    _, _, mp = tts.make_train_step(TSPEC, ocfg, grid=pod)(
        plain, [toptim.make_optimizer(ocfg)[0](t) for t in plain], batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx(float(mp["loss"]), rel=1e-5)


# ---------------------------------------------------------------------------
# the cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["baseline", "seqshard"])
def test_cross_attention_grid_matches_one_device(weights, preset):
    """``cross_attend_train_grid`` on 2x2 (q heads over model; under
    seqshard the decoder's 16 and the encoder's 24 positions over model)
    against ``attend_train(kv_override=project_kv(enc))``: y within 1e-5 of
    its largest; the returned K/V are every KV head of every encoder
    position on each tile."""
    _, np_tree = weights
    params = lm_params_from_numpy(TSPEC, np_tree, "cpu")
    p = params.blocks[0].xattn
    cfg = TSPEC.cfg
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 16, D)).astype(np.float32))
    enc = torch.from_numpy(rng.normal(size=(4, 24, D)).astype(np.float32))
    want = tattn.attend_train(cfg, p, x, causal=False, kv_override=tattn.project_kv(cfg, p, enc))
    grid = make_cpu_mesh(2, 2)
    rules = {**tcm.attach_axis_sizes(dict(tcm.DEFAULT_RULES) if preset == "baseline"
                                     else tdry.RULE_PRESETS[preset](grid), grid),
             "_path": "lm.train"}
    run = tcm.GridRun(rules)
    tree = {k: v for k, v in tlm.param_dict(params)["blocks"][0]["xattn"].items()}
    specs = tcm.sanitize_specs(tcm.tree_specs(tattn.attention_axes(cfg), rules), tree, grid)
    pg = tlm._namespace(tcm.sharded_tree(tcm.shard_tree(tree, specs, grid), specs, grid))
    y, k, v = tattn.cross_attend_train_grid(cfg, run, pg, run.place(x, ("batch", "seq", "embed")),
                                            run.place(enc, ("batch", "seq", "embed")))
    got = tcm.unshard_tree([{"x": t} for t in y], {"x": tcm.Spec(*y.spec)}, grid)["x"]
    _close(got.numpy(), want.numpy(), 1e-5)
    assert k[3].shape == (2, 24, cfg.n_kv_heads, cfg.hd) and k.spec == (("data",), None, None,
                                                                         None)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_grid_prefill_and_decode_logits_match_jax(weights, mesh22):
    params, np_tree = weights
    b = _batch(4, 8, 12, seed=1)
    nxt = np.array([3, 17, 250, 9], np.int32)
    rules_j = jcm.attach_axis_sizes(dict(jcm.DEFAULT_RULES), mesh22)
    with mesh22:
        lg, jc = jax.jit(lambda p, bb: jlm.prefill(JSPEC, p, bb, 16, rules=rules_j))(
            params, {"tokens": jnp.asarray(b["tokens"]), "frames": jnp.asarray(b["frames"])})
        lg2, _ = jax.jit(lambda p, t, c: jlm.decode_step(JSPEC, p, t, c, rules=rules_j))(
            params, jnp.asarray(nxt), jc)
    for shape in ((2, 2), (1, 4), (4, 1)):
        grid = make_cpu_mesh(*shape)
        rules = serve_rules(TSPEC, grid)
        tree = tlm.param_dict(lm_params_from_numpy(TSPEC, np_tree, "cpu"))
        specs = tcm.sanitize_specs(tlm.param_specs(TSPEC, rules), tree, grid)
        view = tlm.grid_view(TSPEC, lm_grid_params_from_numpy(TSPEC, np_tree, specs, grid),
                             specs, grid, stacked=False)
        run = tcm.GridRun(rules)
        with torch.inference_mode():
            got, cache = tlm.prefill(
                TSPEC, view, run.place(torch.as_tensor(b["tokens"]).long(), ("batch", "seq")), 16,
                frames=run.place(torch.as_tensor(b["frames"]), ("batch", "seq", "embed")),
                rules=rules)
            got2, _ = tlm.decode_step(TSPEC, view, run.place(torch.as_tensor(nxt).long(),
                                                             ("batch",)), cache, rules=rules)
        _close(_rows(got, grid), np.asarray(lg), 1e-5)
        _close(_rows(got2, grid), np.asarray(lg2), 1e-5)
        xk, enc = cache["layers"][0]["xk"], cache["enc_out"]
        assert xk.shape == (4, 12, 4, 16) and xk[0].shape == (4 // shape[0], 12, 4, 16)
        assert enc.spec == (("data",), None, None) and enc[0].shape == (4 // shape[0], 12, D)
        # the JAX cross K/V, cut onto the grid, are the port's tiles
        for t in range(grid.n_tiles):
            r0 = grid.coords(t)["data"] * (4 // shape[0])
            _close(xk[t].numpy(), np.asarray(jc["groups"][0]["0"]["xk"][0])[r0:r0 + 4 // shape[0]],
                   1e-5)


def test_grid_serve_matches_jax_mesh22_and_1x1(weights, mesh22):
    """Greedy tokens on 2x2, 1x4, 4x1 and 1x1 against JAX's ``prefill`` and
    ``decode_step`` jitted on ``mesh22`` under its engine's decode rules
    (the JAX ``ServeEngine`` itself refuses, on ``mesh22``, the cross K/V
    its own prefill returns: its decode step declares another layout), and
    against that engine on a 1x1 mesh."""
    params, np_tree = weights
    b = _batch(4, 8, 8, seed=1)
    rules = jcm.attach_axis_sizes({**dict(jcm.DEFAULT_RULES), "moe_gathered": True,
                                   "embed_p": None, "embed_d": None}, mesh22)
    with mesh22:
        lg, cache = jax.jit(lambda p, bb: jlm.prefill(JSPEC, p, bb, 16, rules=rules))(
            params, {"tokens": jnp.asarray(b["tokens"]), "frames": jnp.asarray(b["frames"])})
        step = jax.jit(lambda p, t, c: jlm.decode_step(JSPEC, p, t, c, rules=rules))
        want = []
        for _ in range(4):
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok))
            lg, cache = step(params, tok, cache)
    want = np.stack(want, axis=1)
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    np.testing.assert_array_equal(
        JServeEngine(JSPEC, mesh1, params, s_max=16, batch=4,
                     cfg=JServeConfig(max_new_tokens=4)).generate(b["tokens"], b["frames"]), want)
    tparams = lm_params_from_numpy(TSPEC, np_tree, "cpu")
    for grid in (None, make_cpu_mesh(2, 2), make_cpu_mesh(1, 4), make_cpu_mesh(4, 1)):
        eng = ServeEngine(TSPEC, tparams, s_max=16, batch=4, device="cpu", grid=grid,
                          cfg=ServeConfig(max_new_tokens=4))
        np.testing.assert_array_equal(eng.generate(b["tokens"], b["frames"]), want)


def test_tile_bytes_equal_dry_run(weights):
    """2x2: the engine's parameter tiles and a decode cache's tiles (batch 4,
    16 positions, the encoder output over 16 frames) against the dry run's
    ``argument_bytes`` of that cell; the training state's tiles against its
    train_4k cell."""
    _, np_tree = weights
    grid = make_cpu_mesh(2, 2)
    eng = ServeEngine(TSPEC, lm_params_from_numpy(TSPEC, np_tree, "cpu"), s_max=16,
                      device="cpu", grid=grid)
    want = tdry.argument_bytes(TSPEC, tconfigs.ShapeSpec("decode_small", "decode", 16, 4), grid,
                               dict(tcm.DEFAULT_RULES), "adamw", compute_cast=True)
    assert {sum(x.numel() * x.element_size() for x in tree_leaves(t)) for t in eng.tiles} \
        == {want["param_bytes_per_tile"]}
    with torch.inference_mode():
        run = tcm.GridRun(eng.rules)
        b = _batch(4, 16, 16)
        _, cache = tlm.prefill(TSPEC, eng.params, run.place(torch.as_tensor(b["tokens"]).long(),
                                                            ("batch", "seq")), 16,
                               frames=run.place(torch.as_tensor(b["frames"]),
                                                ("batch", "seq", "embed")), rules=eng.rules)
    cb = {sum(c[k][t].numel() * c[k][t].element_size() for c in cache["layers"] for k in c)
          + cache["enc_out"][t].numel() * cache["enc_out"][t].element_size() for t in range(4)}
    assert cb == {want["cache_bytes_per_tile"]}
    params, state = tts.init_state(TSPEC, toptim.OptConfig(), seed=0, grid=grid)
    tw = tdry.argument_bytes(TSPEC, tconfigs.SHAPES_BY_NAME["train_4k"], grid,
                             dict(tcm.DEFAULT_RULES), "adamw")
    assert {sum(x.numel() * x.element_size() for x in tree_leaves(p)) for p in params} \
        == {tw["param_bytes_per_tile"]}
    assert {sum(x.numel() * x.element_size() for x in tree_leaves(s)) for s in state} \
        == {tw["opt_state_bytes_per_tile"]}


# ---------------------------------------------------------------------------
# the data pipeline and the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [("data", None), ("data", "model")])
def test_global_batch_for_frames_bitwise_host_batch(spec):
    cfg = tpipe.DataConfig(vocab=512, seq_len=16, global_batch=4, frames_dim=D)
    grid = make_cpu_mesh(2, 2)
    tb = tpipe.global_batch_for(cfg, 3, grid, tcm.Spec(*spec))
    host = tpipe.host_batch(cfg, 3)
    fr = tb["frames"]
    assert fr.spec == tuple(coll.entry_axes(e) or None for e in spec) + (None,)
    put = tcm.unshard_tree(list(fr), tcm.Spec(*fr.spec), grid)
    np.testing.assert_array_equal(put.numpy(), host["frames"])


def test_launchers_on_grid(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--data", "2", "--model", "2",
                 "--max-new", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "grid 2x2" in out and "moved between grid positions" in out
    ttrain.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
                 "--device", "cpu", "--data", "2", "--model", "2"])
    assert "[train] done" in capsys.readouterr().out
