"""The LM substrate on a device grid: the port on 2x2 and 2x2x2 CPU grids
against its own 1x1 path and against the JAX package on ``mesh22``.

The model is ``tests/test_sharding.py``'s TINY (dense, 2 layers, d_model 64,
4 q heads over 2 KV heads, fp32 compute), its weights carried from the JAX
package's ``lm.init_params`` through numpy (``interop``).  Tolerances:

- the loss (baseline, fsdp and seqshard presets) against port 1x1 and JAX
  on ``mesh22``: rel 1e-5, ``test_sharding.py::test_loss_invariant_to_mesh``'s;
- one AdamW or Adafactor step on 2x2 (and on 2x2x2 with the multi-pod
  rules) against 1x1: parameters within 1e-6 (the same fp32 terms summed in
  another order: tensor-parallel partials, per-tile norm sums);
- served tokens: ``array_equal`` -- greedy against port 1x1 and JAX on
  ``mesh22``, temperature-sampled against port 1x1 only (the port's
  Gumbel-max draws are not JAX's bits);
- ``global_batch_for``: bitwise, each tile and the whole;
- the remesh restore (2x2 -> 1x1, 1x1 -> 2x2): losses rel 1e-5, tighter than
  the JAX restart test's 2e-3 (the same steps, as above); a JAX checkpoint
  restored onto a port grid: rel 1e-4 (the JAX step against the port's, as
  ``test_torch_training.py`` holds one step, compounded over two);
- storage: every tile's shape is ``tile_shape``'s, its bytes the dry run's
  ``argument_bytes``; a prefill's moved bytes equal a count by hand;
- the compressed pod step: its synced gradients within the int8 error of
  the pods' uncompressed mean (half a quantization step of each pod, averaged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.data import pipeline as jpipe
from repro.launch import dryrun as jdry
from repro.launch import train as jtrain
from repro.launch.mesh import make_cpu_mesh as j_mesh
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models.common import ArchConfig as JArch
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.core import collectives as coll
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import (grid_tree_from_numpy, lm_grid_params_from_numpy,
                                 lm_params_from_numpy, lm_tree_from_numpy)
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_cpu_mesh, mesh_chip_count
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import attention as tattn
from repro_torch.models.common import ArchConfig, Spec
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.training import optim as toptim
from repro_torch.training import train_step as tts
from repro_torch.tree import tree_leaves

_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=256, remat=False, compute_dtype="float32")
J_TINY = JArch(**_TINY)
T_TINY = ArchConfig(**_TINY)
JSPEC, TSPEC = jlm.build_spec(J_TINY), tlm.build_spec(T_TINY)


@pytest.fixture(scope="module")
def jparams():
    """The JAX package's TINY weights (seed 3) and the same as numpy."""
    p = jlm.init_params(JSPEC, jax.random.PRNGKey(3))
    return p, jax.tree.map(np.asarray, p)


def _tokens(b=4, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)


def _rules(grid, preset="baseline"):
    if preset == "baseline":
        r = tcm.multipod_rules() if "pod" in grid.axis_names else dict(tcm.DEFAULT_RULES)
    else:
        r = tdry.RULE_PRESETS[preset](grid)
    return r


def _port_loss(np_tree, tokens, grid=None, preset="baseline"):
    """The port's loss on ``grid`` (None: one device) and its tiles."""
    tree = lm_tree_from_numpy(np_tree, "cpu")
    tok = torch.as_tensor(tokens, dtype=torch.int64)
    if grid is None:
        loss, _ = tlm.loss_fn(TSPEC, tlm.params_view(TSPEC, tree), {"tokens": tok, "labels": tok})
        return float(loss.detach())
    rules = tts.train_rules(TSPEC, grid, _rules(grid, preset))
    pspecs, _ = tts.grid_specs(TSPEC, toptim.OptConfig(), grid, _rules(grid, preset))
    tiles = tcm.shard_tree(tree, pspecs, grid)
    run = tcm.GridRun(rules)
    batch = {"tokens": run.place(tok, ("batch", "seq")), "labels": run.place(tok, ("batch", "seq"))}
    loss, _ = tlm.loss_fn(TSPEC, tlm.grid_view(TSPEC, tiles, pspecs, grid), batch, rules=rules)
    vals = [float(x.detach()) for x in loss]
    assert len(set(vals)) == 1, f"the loss differs between tiles: {vals}"
    return vals[0]


def _jax_loss(params, tokens, mesh, preset="baseline"):
    base = dict(jcm.DEFAULT_RULES) if preset == "baseline" else jdry.RULE_PRESETS[preset](mesh)
    rules = jcm.attach_axis_sizes(base, mesh)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    with mesh:
        loss, _ = jax.jit(lambda p, b: jlm.loss_fn(JSPEC, p, b, rules=rules))(params, batch)
    return float(loss)


# ---------------------------------------------------------------------------
# the grid, constrain, the collectives
# ---------------------------------------------------------------------------


def test_make_cpu_mesh_axes_and_pod_contexts():
    g = make_cpu_mesh(2, 2)
    assert g.axis_names == ("data", "model") and g.shape == {"data": 2, "model": 2}
    assert tcm.axis_sizes(g) == {"data": 2, "model": 2} and mesh_chip_count(g) == 4
    assert g.context().n_row_shards == 2 and g.context().n_col_shards == 2
    p = make_cpu_mesh(2, 2, pod=2)
    assert p.axis_names == ("pod", "data", "model") and mesh_chip_count(p) == 8
    assert p.coords(5) == {"pod": 1, "data": 0, "model": 1} and p.index(p.coords(5)) == 5
    assert p.groups(("pod",))[1] == [1, 5]
    assert p.groups(("data", "model"))[1] == [4, 5, 6, 7]
    assert p.context(1).n_row_shards == 2
    # a DistContext is a 2-D grid of itself
    assert tcm.axis_sizes(g.context()) == {"data": 2, "model": 2}


def test_constrain_safe_without_grid():
    x = torch.ones(4, 4)
    assert tcm.constrain(x, ("batch", None), dict(tcm.DEFAULT_RULES)) is x


def test_constrain_relays_and_counts():
    grid = make_cpu_mesh(2, 2)
    rules = {**tcm.attach_axis_sizes(dict(tcm.DEFAULT_RULES), grid), "_path": "lm.serve"}
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    run = tcm.GridRun(rules)
    xs = run.place(x, ("batch", "kv_seq", None))  # rows over data, positions over model
    assert xs[3].shape == (2, 4, 6) and xs.spec == (("data",), ("model",), None)
    before = coll.lm_moves()["lm.serve"]["gather_bytes"]
    whole = tcm.constrain(xs, ("batch", None, None), rules)  # gather the positions
    assert whole.spec == (("data",), None, None)
    for t in range(4):
        d = grid.coords(t)["data"]
        assert torch.equal(whole[t], x[2 * d:2 * d + 2])
    assert coll.lm_moves()["lm.serve"]["gather_bytes"] - before == 4 * (2 * 4 * 6 * 4)
    back = tcm.constrain(whole, ("batch", "kv_seq", None), rules)  # a split moves nothing
    assert all(torch.equal(a, b) for a, b in zip(back, xs))
    # an entry that does not divide is dropped, as the JAX constrain drops it
    odd = run.place(torch.zeros(4, 3), ("batch", None))
    assert tcm.constrain(odd, ("batch", "vocab"), rules).spec == (("data",), None)


def test_collectives_backward_is_their_dual():
    """all_gather's backward is a reduce-scatter, all_reduce's the identity,
    pvary's an all-reduce, reduce_scatter's an all-gather."""
    grid = make_cpu_mesh(2, 2)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 3, generator=gen, dtype=torch.float64, requires_grad=True)
          for _ in range(4)]
    cs = [torch.randn(4, 3, generator=gen, dtype=torch.float64) for _ in range(4)]
    out = coll.all_gather(xs, grid, ("model",), 0, "lm.train")
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cs)), xs)
    for t in range(4):
        c = grid.coords(t)["model"]
        grp = [q for q in grid.groups(("model",)) if t in q][0]
        want = sum(cs[j][2 * c:2 * c + 2] for j in grp)
        assert torch.allclose(g[t], want)
    c2 = [x[:2] for x in cs]
    out = coll.all_reduce(xs, grid, ("data",), "lm.train")
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, c2)), xs)
    assert all(torch.equal(a, b) for a, b in zip(g, c2))
    out = coll.pvary(xs, grid, ("data",), "lm.train")
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, c2)), xs)
    for t in range(4):
        grp = [q for q in grid.groups(("data",)) if t in q][0]
        assert torch.allclose(g[t], sum(c2[j] for j in grp))
    ys = [torch.randn(4, 3, generator=gen, dtype=torch.float64, requires_grad=True)
          for _ in range(4)]
    out = coll.reduce_scatter(ys, grid, ("model",), 0, "lm.train")
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, c2)), ys)
    for t in range(4):
        grp = [q for q in grid.groups(("model",)) if t in q][0]
        assert torch.equal(g[t], torch.cat([c2[j] for j in grp]))


def test_grid_loss_is_deterministic(jparams):
    _, np_tree = jparams
    tok = _tokens()
    a = _port_loss(np_tree, tok, make_cpu_mesh(2, 2))
    b = _port_loss(np_tree, tok, make_cpu_mesh(2, 2))
    assert a == b


# ---------------------------------------------------------------------------
# the loss: port 2x2 against port 1x1 and JAX mesh22
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["baseline", "fsdp", "seqshard"])
def test_grid_loss_matches_1x1_and_jax(jparams, mesh22, preset):
    params, np_tree = jparams
    tok = _tokens()
    one = _port_loss(np_tree, tok)
    two = _port_loss(np_tree, tok, make_cpu_mesh(2, 2), preset)
    jax22 = _jax_loss(params, tok, mesh22, preset)
    assert two == pytest.approx(one, rel=1e-5)
    assert two == pytest.approx(jax22, rel=1e-5)


@pytest.mark.parametrize("preset", ["fsdp", "seqshard"])
def test_presets_match_baseline_on_other_grids(jparams, preset):
    """1x4 and 4x1 grids: fsdp over four data rows, seqshard's four
    sequence slices (q_offset up to 24) against the baseline."""
    _, np_tree = jparams
    tok = _tokens()
    base = _port_loss(np_tree, tok, make_cpu_mesh(2, 2))
    for grid in (make_cpu_mesh(1, 4), make_cpu_mesh(4, 1)):
        assert _port_loss(np_tree, tok, grid, preset) == pytest.approx(base, rel=1e-5)


def test_any_family_on_1x1_grid_runs_single_device_code():
    cfg = tconfigs.get_smoke("rwkv6-3b")
    spec = tlm.build_spec(cfg)
    grid = make_cpu_mesh(1, 1)
    ocfg = toptim.OptConfig(name=cfg.optimizer)
    p1, s1 = tts.init_state(spec, ocfg, seed=1, device="cpu")
    pg, sg = tts.init_state(spec, ocfg, seed=1, grid=grid)
    tok = _tokens(2, 16)
    batch = {"tokens": tok, "labels": tok}
    _, _, m1 = tts.make_train_step(spec, ocfg, device="cpu")(p1, s1, batch)
    _, _, mg = tts.make_train_step(spec, ocfg, grid=grid)(pg, sg, batch)
    assert float(m1["loss"]) == float(mg["loss"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _step_pair(np_tree, grid, opt_name, rules=None, steps=1, accum=1):
    ocfg = toptim.OptConfig(name=opt_name, lr=1e-3)
    tree = lm_tree_from_numpy(np_tree, "cpu")
    state = toptim.make_optimizer(ocfg)[0](tree)
    tok = _tokens(8, 32, seed=5)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    pspecs, ospecs = tts.grid_specs(TSPEC, ocfg, grid, rules)
    pg = tcm.shard_tree(tree, pspecs, grid)
    sg = tcm.shard_tree(state, ospecs, grid)
    step1 = tts.make_train_step(TSPEC, ocfg, device="cpu", accum=accum)
    stepg = tts.make_train_step(TSPEC, ocfg, grid=grid, rules=rules, accum=accum)
    for _ in range(steps):
        tree, state, m1 = step1(tree, state, batch)
        pg, sg, mg = stepg(pg, sg, batch)
    return tree, state, m1, tcm.unshard_tree(pg, pspecs, grid), \
        tcm.unshard_tree(sg, ospecs, grid), mg, pg


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_grid_train_step_matches_1x1(jparams, opt_name):
    _, np_tree = jparams
    p1, s1, m1, pg, sg, mg, tiles = _step_pair(np_tree, make_cpu_mesh(2, 2), opt_name)
    assert float(mg["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    for a, b in zip(tree_leaves(pg), tree_leaves(p1), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)
    for a, b in zip(tree_leaves(sg), tree_leaves(s1), strict=True):
        scale = float(b.abs().max()) if b.numel() else 0.0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5 * scale)


def test_grid_train_step_accumulates_like_1x1(jparams):
    """Two microbatches of the global batch's rows (the JAX package's reshape),
    each laid out on the 2x2 grid: as the 1x1 step's accumulation."""
    _, np_tree = jparams
    p1, _, m1, pg, _, mg, _ = _step_pair(np_tree, make_cpu_mesh(2, 2), "adamw", accum=2)
    assert float(mg["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(pg), tree_leaves(p1), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)


def test_replicated_tiles_stay_bitwise_equal(jparams):
    """Two steps on 2x2: every copy of a replicated parameter tile equals its
    first copy, bit for bit (the all-reduces run in one order on every tile)."""
    _, np_tree = jparams
    grid = make_cpu_mesh(2, 2)
    *_, tiles = _step_pair(np_tree, grid, "adamw", steps=2)
    pspecs, _ = tts.grid_specs(TSPEC, toptim.OptConfig(), grid)
    specs = [s for _, s in toptim.sorted_spec_paths(pspecs)]
    leaves = [tree_leaves(t) for t in tiles]
    for i, s in enumerate(specs):
        used = {a for e in s for a in coll.entry_axes(e)}
        for t in range(4):
            c0 = {k: (v if k in used else 0) for k, v in grid.coords(t).items()}
            assert torch.equal(leaves[t][i], leaves[grid.index(c0)][i])


def test_multipod_train_step_matches_1x1(jparams):
    _, np_tree = jparams
    grid = make_cpu_mesh(2, 2, pod=2)
    p1, _, m1, pg, _, mg, _ = _step_pair(np_tree, grid, "adamw")
    assert np.isfinite(float(mg["loss"]))
    assert float(mg["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(pg), tree_leaves(p1), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)


def test_compressed_train_step_on_pod_grid(jparams):
    """One compressed step on 2x2x2: finite, the loss the uncompressed one's,
    the synced gradient within int8 error of the pods' uncompressed mean."""
    _, np_tree = jparams
    grid = make_cpu_mesh(2, 2, pod=2)
    ocfg = toptim.OptConfig(lr=1e-3)
    step, ef_init, pspecs = tts.make_compressed_train_step(TSPEC, grid, ocfg)
    params, opt = tts.init_pod_state(TSPEC, ocfg, grid, seed=0)
    # the same weights as the uncompressed step's below
    tree = lm_tree_from_numpy(np_tree, "cpu")
    for p in range(2):
        for t, tile in enumerate(tcm.shard_tree(tree, pspecs, tts._pod_grid(grid, p))):
            for a, b in zip(tree_leaves(params[4 * p + t]), tree_leaves(tile)):
                a.data.copy_(b)
    tok = _tokens(8, 32, seed=5)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    # the pods' own gradients against their plain mean
    _, _, raw = step.pod_grads(params, batch)
    synced, _ = tts.compressed_pod_allreduce(raw, ef_init(params), grid)
    for i in range(len(tree_leaves(raw[0]))):
        # each pod's scale: the leaf's amax over its four tiles / 127; each
        # dequantized tile is within half a step (plus the codec's one-ulp edge)
        scales = [max(float(tree_leaves(raw[t])[i].abs().max()) for t in range(4 * p, 4 * p + 4))
                  / 127.0 for p in range(2)]
        bound = (scales[0] + scales[1]) / 4 * (1 + 1e-4) + 1e-30
        for t in range(4):
            a, b, c = (tree_leaves(x)[i] for x in (synced[t], raw[t], raw[t + 4]))
            assert float(torch.max(torch.abs(a - (b + c) / 2))) <= bound
    _, _, m, ef = step(params, opt, batch, ef_init(params))
    _, _, _, _, _, m_plain, _ = _step_pair(np_tree, grid, "adamw")
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx(float(m_plain["loss"]), rel=1e-5)
    assert any(float(torch.max(torch.abs(e))) > 0 for t in ef for e in tree_leaves(t))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_grid_matches_1x1_and_jax(jparams, mesh22):
    params, np_tree = jparams
    prompts = np.random.default_rng(1).integers(0, 256, size=(4, 8)).astype(np.int32)
    jeng = JServeEngine(JSPEC, mesh22, params, s_max=16, batch=4,
                        cfg=JServeConfig(max_new_tokens=4))
    want = jeng.generate(prompts)
    tparams = lm_params_from_numpy(TSPEC, np_tree, "cpu")
    outs = {}
    for temp in (0.0, 0.7):
        for name, grid in (("1x1", None), ("2x2", make_cpu_mesh(2, 2)),
                           ("1x4", make_cpu_mesh(1, 4))):
            eng = ServeEngine(TSPEC, tparams, s_max=16, batch=4, device="cpu", grid=grid,
                              cfg=ServeConfig(max_new_tokens=4, temperature=temp, seed=3))
            outs[temp, name] = eng.generate(prompts)
    np.testing.assert_array_equal(outs[0.0, "2x2"], want)
    np.testing.assert_array_equal(outs[0.0, "2x2"], outs[0.0, "1x1"])
    np.testing.assert_array_equal(outs[0.0, "1x4"], outs[0.0, "1x1"])
    np.testing.assert_array_equal(outs[0.7, "2x2"], outs[0.7, "1x1"])
    np.testing.assert_array_equal(outs[0.7, "1x4"], outs[0.7, "1x1"])


def test_prefill_moves_counted_by_hand(jparams):
    """TINY's prefill of 4 x 8 tokens on 2x2 under the serve rules: batch rows
    over data (2 a tile), heads / d_ff / vocab over model, weights whole over
    data.  Each tile's (2, 8, 64) fp32 rows (4096 B) are all-reduced over the
    2-wide model axis five times -- the vocab-sharded embedding, then each
    layer's attention and MLP -- one partner each, 5 x 4 x 4096 B; the last
    position's (2, 1, 128) logits (1024 B) are gathered over model, 4 x 1024 B."""
    _, np_tree = jparams
    grid = make_cpu_mesh(2, 2)
    from repro_torch.serving.engine import serve_rules

    rules = serve_rules(TSPEC, grid)
    tree = tlm.param_dict(lm_params_from_numpy(TSPEC, np_tree, "cpu"))
    specs = tcm.sanitize_specs(tlm.param_specs(TSPEC, rules), tree, grid)
    tiles = lm_grid_params_from_numpy(TSPEC, np_tree, specs, grid)
    view = tlm.grid_view(TSPEC, tiles, specs, grid, stacked=False)
    tok = tcm.GridRun(rules).place(torch.as_tensor(_tokens(4, 8), dtype=torch.int64),
                                   ("batch", "seq"))
    before = coll.lm_moves()["lm.serve"]
    logits, cache = tlm.prefill(TSPEC, view, tok, 16, rules=rules)
    after = coll.lm_moves()["lm.serve"]
    d = {k: after[k] - before[k] for k in after}
    assert d["reduce_bytes"] == 5 * 4 * 4096 and d["reduces"] == 5
    assert d["gather_bytes"] == 4 * 1024 and d["gathers"] == 1
    assert d["reduce_scatter_bytes"] == 0 and d["permute_bytes"] == 0
    assert logits[0].shape == (2, 256) and cache["layers"][0]["k"][0].shape == (2, 8, 2, 16)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [("data", None), ("data", "model")])
def test_global_batch_for_bitwise_jax(mesh22, spec):
    cfg = tpipe.DataConfig(vocab=512, seq_len=32, global_batch=8)
    jcfg = jpipe.DataConfig(vocab=512, seq_len=32, global_batch=8)
    with mesh22:
        jb = jpipe.global_batch_for(jcfg, 3, mesh22, P(*spec))
    grid = make_cpu_mesh(2, 2)
    tb = tpipe.global_batch_for(cfg, 3, grid, Spec(*spec))
    for key in ("tokens", "labels"):
        whole = np.asarray(jb[key])
        np.testing.assert_array_equal(whole, tpipe.host_batch(cfg, 3)[key])
        for shard in jb[key].addressable_shards:  # each JAX device against its port tile
            r = int(np.argwhere(mesh22.devices == shard.device)[0][0])
            c = int(np.argwhere(mesh22.devices == shard.device)[0][1])
            np.testing.assert_array_equal(tb[key][grid.index({"data": r, "model": c})].numpy(),
                                          np.asarray(shard.data))
        put = tcm.unshard_tree(list(tb[key]), Spec(*tb[key].spec), grid)
        np.testing.assert_array_equal(put.numpy(), whole)


# ---------------------------------------------------------------------------
# checkpoints across grids
# ---------------------------------------------------------------------------


def _loop(d, steps, grid=None):
    return ttrain.train_loop(T_TINY, steps=steps, batch=4, seq=32, ckpt_dir=d, ckpt_every=2,
                             log_every=100, device="cpu", grid=grid)[2]


@pytest.mark.parametrize("first,then", [("2x2", "1x1"), ("1x1", "2x2")])
def test_remesh_restore(tmp_path, first, then):
    grids = {"1x1": None, "2x2": make_cpu_mesh(2, 2)}
    ref_losses = _loop(str(tmp_path / "ref"), 6)
    d = str(tmp_path / "remesh")
    a = _loop(d, 4, grids[first])
    b = _loop(d, 6, grids[then])
    assert len(b) == 2
    np.testing.assert_allclose(a + b, ref_losses, rtol=1e-5)


def test_jax_checkpoint_restores_onto_port_grid(tmp_path):
    """The JAX package trains 4 steps on a 1x1 mesh, checkpointing after 2
    and 4; the port resumes its step-2 checkpoint on a 2x2 grid and runs
    steps 2 and 3 as the JAX package ran them."""
    import shutil

    d = str(tmp_path / "jax")
    j_losses = jtrain.train_loop(J_TINY, j_mesh(1, 1), steps=4, batch=4, seq=32, ckpt_dir=d,
                                 ckpt_every=2, log_every=100)[2]
    shutil.rmtree(tmp_path / "jax" / "step_00000004")
    t_cont = _loop(d, 4, make_cpu_mesh(2, 2))
    assert len(t_cont) == 2
    np.testing.assert_allclose(t_cont, j_losses[2:], rtol=1e-4)


# ---------------------------------------------------------------------------
# storage: per-tile shapes and the dry run's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_tile_storage_equals_dry_run(opt_name):
    grid = make_cpu_mesh(2, 2)
    ocfg = toptim.OptConfig(name=opt_name)
    params, state = tts.init_state(TSPEC, ocfg, seed=0, grid=grid)
    pspecs, ospecs = tts.grid_specs(TSPEC, ocfg, grid)
    shapes = tree_leaves(tts._stacked_shapes(TSPEC))
    specs = [s for _, s in toptim.sorted_spec_paths(pspecs)]
    for t in range(4):
        for s, x, tile in zip(specs, shapes, tree_leaves(params[t]), strict=True):
            assert tuple(tile.shape) == tcm.tile_shape(s, x.shape, grid)
    shape = tconfigs.SHAPES_BY_NAME["train_4k"]
    want = tdry.argument_bytes(TSPEC, shape, grid, dict(tcm.DEFAULT_RULES), opt_name)
    for t in range(4):
        assert sum(x.numel() * x.element_size() for x in tree_leaves(params[t])) \
            == want["param_bytes_per_tile"]
        assert sum(x.numel() * x.element_size() for x in tree_leaves(state[t])) \
            == want["opt_state_bytes_per_tile"]
    cache = tlm.init_cache(TSPEC, 4, 16, rules={**tcm.attach_axis_sizes(
        dict(tcm.DEFAULT_RULES), grid)})
    assert cache["layers"][0]["k"][0].shape == (2, 8, 2, 16)


def test_grid_tree_from_numpy_places_jax_weights(jparams):
    _, np_tree = jparams
    grid = make_cpu_mesh(2, 2)
    pspecs, _ = tts.grid_specs(TSPEC, toptim.OptConfig(), grid)
    tiles = grid_tree_from_numpy(np_tree, pspecs, grid, requires_grad=True)
    whole = tcm.unshard_tree(tiles, pspecs, grid)
    for a, b in zip(tree_leaves(whole), tree_leaves(np_tree)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert all(x.requires_grad for x in tree_leaves(tiles[3]))


# ---------------------------------------------------------------------------
# the kernel's q_offset (plain version) and the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 3])
def test_flash_q_offset_rows_of_whole_sequence(groups):
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2 * groups, 40, 16, generator=gen)
    k = torch.randn(2, 40, 16, generator=gen)
    v = torch.randn(2, 40, 16, generator=gen)
    whole = ref.flash_attention(q, k, v, causal=True, groups=groups)
    for off, n in ((0, 10), (10, 10), (24, 16)):
        part = ref.flash_attention(q[:, off:off + n].contiguous(), k, v, causal=True,
                                   groups=groups, q_offset=off)
        torch.testing.assert_close(part, whole[:, off:off + n], rtol=1e-6, atol=1e-6)
    # the model's chunked form takes the same offset
    cfg = T_TINY.replace(attn_chunk=8)
    qm = q.reshape(1, 2 * groups, 40, 16).transpose(1, 2)
    km, vm = (x.reshape(1, 2, 40, 16).transpose(1, 2) for x in (k, v))
    full = tattn._chunked_flash(cfg, qm, km, vm, causal=True)
    part = tattn._chunked_flash(cfg, qm[:, 24:], km, vm, causal=True, q_offset=24)
    torch.testing.assert_close(part, full[:, 24:], rtol=1e-6, atol=1e-6)


def test_serve_and_train_launchers_on_grid(capsys, tmp_path):
    tserve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--data", "2",
                 "--model", "2", "--max-new", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "grid 2x2" in out and "moved between grid positions" in out
    ttrain.main(["--arch", "granite-3-2b", "--smoke", "--steps", "2", "--batch", "4",
                 "--seq", "16", "--device", "cpu", "--data", "2", "--model", "2"])
    assert "[train] done" in capsys.readouterr().out
    # every family runs on a grid (tests/test_torch_grid_ssm.py, test_torch_grid_encdec.py)
    tserve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--data", "2",
                 "--model", "2", "--max-new", "2", "--prompt-len", "4"])
    assert "grid 2x2" in capsys.readouterr().out
    ttrain.main(["--arch", "seamless-m4t-medium", "--smoke", "--steps", "1", "--device",
                 "cpu", "--data", "2", "--model", "1"])
    assert "[train] done" in capsys.readouterr().out
