"""MoE and chameleon on a device grid: the port on 2x2, 1x4 and 2x2x2 CPU
grids against the JAX package on the same meshes.

A MoE grid is not the 1x1 model: on a mesh the JAX ``apply_moe`` routes
with a capacity per batch shard (its ``shard_map`` branch), so a grid drops
other tokens than one device does, and the reference is JAX on the same
mesh.  The SMOKE models' weights come from the JAX package's
``lm.init_params`` (``PRNGKey(3)``) through numpy (``interop``); tokens
from numpy ``default_rng``.  Tolerances (fp32 throughout):

- each branch of ``apply_moe`` (expert parallelism, the FFN dim sharded,
  the gathered path, granite-moe's fallback from it, the batch axes
  dropped, ``e_ax`` dropped, ``f_ax`` dropped, the multi-pod rules): y within 1e-5 of its
  largest entry, the aux losses rel 1e-5;
- the loss on 2x2 against JAX on ``mesh22``: rel 1e-5; the router's and
  the experts' gradients rtol 1e-4 (entries within 1e-4 of the leaf's
  largest);
- one AdamW (granite-moe) or Adafactor (llama4) step against JAX's
  ``make_train_step`` on ``mesh22``: loss, grad norm and xent rel 1e-5,
  parameters rtol 1e-4 / atol 1e-5 (``tests/test_torch_training.py``'s
  one-step tolerances);
- greedy tokens: ``array_equal`` with the JAX engine on ``mesh22``;
- llama4's grid decode step (the gathered path: one capacity) against its
  1x1 step from the same cache: logits within 1e-5 of the largest;
- bitwise: replicas after a step, the dense family's served logits under
  the prefill and the decode rules, moved bytes counted by hand.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.training import optim as joptim
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.core import collectives as coll
from repro_torch.interop import (lm_grid_params_from_numpy, lm_params_from_numpy,
                                 lm_tree_from_numpy, tree_from_numpy)
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import prefill_rules, serve_rules
from repro_torch.training import optim as toptim
from repro_torch.training import train_step as tts
from repro_torch.tree import tree_leaves

GRANITE, LLAMA4, CHAMELEON = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "chameleon-34b"
MOE_ARCHS = [GRANITE, LLAMA4]


def _specs(arch):
    return (jlm.build_spec(jconfigs.get_smoke(arch)), tlm.build_spec(tconfigs.get_smoke(arch)))


_WEIGHTS = {}


def _weights(arch):
    """The JAX package's SMOKE weights (PRNGKey(3)) and the same as numpy."""
    if arch not in _WEIGHTS:
        p = jlm.init_params(_specs(arch)[0], jax.random.PRNGKey(3))
        _WEIGHTS[arch] = (p, jax.tree.map(np.asarray, p))
    return _WEIGHTS[arch]


def _tokens(vocab, b=4, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _whole(x: coll.Sharded, grid) -> np.ndarray:
    return tcm.unshard_tree([{"x": t} for t in x], {"x": tcm.Spec(*x.spec)}, grid)["x"].numpy()


# ---------------------------------------------------------------------------
# the MoE layer: each branch of the JAX apply_moe
# ---------------------------------------------------------------------------

# (arch, grid (data, model[, pod]), gathered rules, batch, config overrides,
#  the tokens one tile routes: the branch taken)
BRANCHES = {
    "a_expert_parallel": (LLAMA4, (2, 2), False, 4, {}, 16),
    "b_ffn_sharded": (GRANITE, (2, 2), False, 4, {}, 16),
    "c_gathered": (LLAMA4, (2, 2), True, 4, {}, 32),
    "d_granite_gathered_falls_back": (GRANITE, (2, 2), True, 4, {}, 16),
    "batch_axes_dropped": (LLAMA4, (2, 2), False, 3, {}, 24),
    "e_ax_dropped": (LLAMA4, (1, 4), False, 4, {"n_experts": 6}, 32),
    "f_ax_dropped": (GRANITE, (2, 2), False, 4, {"d_expert": 33}, 16),
    "multipod": (LLAMA4, (2, 2, 2), False, 4, {}, 8),
}


def _layer_grid(shape):
    if len(shape) == 3:
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
        return mesh, make_cpu_mesh(2, 2, pod=2), jcm.multipod_rules(), tcm.multipod_rules()
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(*shape), ("data", "model"))
    return mesh, make_cpu_mesh(*shape), dict(jcm.DEFAULT_RULES), dict(tcm.DEFAULT_RULES)


def _moe_layer_params(tc, np_p, rules, grid):
    """One MoE layer's parameters cut onto ``grid`` by ``rules`` (as stored)."""
    whole = tree_from_numpy(np_p, "cpu")
    specs = tcm.sanitize_specs(tcm.tree_specs(tmoe.moe_axes(tc), rules), whole, grid)
    return tlm._namespace(tcm.sharded_tree(tcm.shard_tree(whole, specs, grid), specs, grid))


@pytest.mark.parametrize("case", list(BRANCHES))
def test_apply_moe_branch_matches_jax(case):
    arch, shape, gathered, b, over, t_tile = BRANCHES[case]
    jc = jconfigs.get_smoke(arch).replace(**over)
    tc = tconfigs.get_smoke(arch).replace(**over)
    jp = jmoe.init_moe(jc, jax.random.PRNGKey(1))
    x = np.random.default_rng(0).normal(size=(b, 8, jc.d_model)).astype(np.float32)
    mesh, grid, jbase, tbase = _layer_grid(shape)
    extra = {"moe_gathered": True, "embed_p": None} if gathered else {}
    jr = jcm.attach_axis_sizes({**jcm.arch_rules(jc, jbase), **extra}, mesh)
    with mesh:
        jy, jaux = jax.jit(lambda p, xx: jmoe.apply_moe(jc, p, xx, rules=jr))(jp, jnp.asarray(x))
    tr = {**tcm.attach_axis_sizes({**tcm.arch_rules(tc, tbase), **extra}, grid),
          "_path": "lm.train"}
    run = tcm.GridRun(tr)
    p = _moe_layer_params(tc, jax.tree.map(np.asarray, jp), tr, grid)
    with tmoe.record_routing() as log:
        y, aux = tmoe.apply_moe_grid(tc, run, p, run.place(torch.as_tensor(x),
                                                           ("batch", "seq", "embed")))
    assert {r.expert_ids.shape[0] for r in log[0]} == {t_tile}
    _close(_whole(y, grid), jy, 1e-5)
    for k in ("lb_loss", "z_loss"):
        vals = {float(v) for v in aux[k]}
        assert len(vals) == 1
        assert vals.pop() == pytest.approx(float(jaux[k]), rel=1e-5)


def test_gathered_moves_counted_by_hand():
    """llama4 SMOKE (d 64, 8 experts of f 64, a shared expert of f 64) on 2x2
    under the decode rules, 4 x 1 tokens fp32: the tokens' (2, 1, 64) rows
    (512 B a tile) gathered over data (4 x 512 B); the router's (64, 4)
    halves (1 KiB) gathered over model (4 x 1 KiB); the gate and up
    partials (4, 5, 64) (e_loc 4, capacity 4 + the spare slot: 5 KiB a
    tile) summed over data (2 x 4 x 5 KiB); the (4, 1, 32) output slices
    (512 B) summed over experts (4 x 512 B), gathered over d (4 x 512 B)
    and split by batch; the shared expert's MLP sums its (2, 1, 64)
    partials over model (4 x 512 B).  No weight bytes move."""
    tc = tconfigs.get_smoke(LLAMA4)
    grid = make_cpu_mesh(2, 2)
    rules = serve_rules(tlm.build_spec(tc), grid)
    run = tcm.GridRun(rules)
    jp = jmoe.init_moe(jconfigs.get_smoke(LLAMA4), jax.random.PRNGKey(1))
    p = _moe_layer_params(tc, jax.tree.map(np.asarray, jp), rules, grid)
    x = run.place(torch.randn(4, 1, 64, generator=torch.Generator().manual_seed(0)),
                  ("batch", "seq", "embed"))
    before = coll.lm_moves()["lm.serve"]
    with torch.inference_mode():
        y, _ = tmoe.apply_moe_grid(tc, run, p, x)
    after = coll.lm_moves()["lm.serve"]
    d = {k: after[k] - before[k] for k in after}
    assert d["gathers"] == 3 and d["gather_bytes"] == 4 * 512 + 4 * 1024 + 4 * 512
    assert d["reduces"] == 4
    assert d["reduce_bytes"] == 2 * 4 * 5 * 1024 + 4 * 512 + 4 * 512
    assert d["reduce_scatter_bytes"] == 0 and d["permute_bytes"] == 0
    assert y.spec == x.spec and y[0].shape == (2, 1, 64)


# ---------------------------------------------------------------------------
# the whole model on 2x2 against JAX on mesh22
# ---------------------------------------------------------------------------


def _grid_batch(rules, tok, labels):
    run = tcm.GridRun(rules)
    return {"tokens": run.place(torch.as_tensor(tok, dtype=torch.int64), ("batch", "seq")),
            "labels": run.place(torch.as_tensor(labels, dtype=torch.int64), ("batch", "seq"))}


def _port_grid_loss(arch, tok, grid, grads=False):
    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    tree = lm_tree_from_numpy(np_tree, "cpu")
    pspecs, _ = tts.grid_specs(tspec, toptim.OptConfig(), grid)
    tiles = tcm.shard_tree(tree, pspecs, grid)
    run = tcm.GridRun(tts.train_rules(tspec, grid))
    loss, metrics, gtrees = tts.grid_loss_and_grad(tspec, tiles, _grid_batch(run.rules, tok, tok),
                                                   pspecs, run)
    vals = {float(x) for x in loss}
    assert len(vals) == 1, f"the loss differs between tiles: {vals}"
    return vals.pop(), tcm.unshard_tree(gtrees, pspecs, grid) if grads else None


def _jax_rules(jspec, mesh):
    base = jcm.multipod_rules() if "pod" in mesh.axis_names else dict(jcm.DEFAULT_RULES)
    return jcm.attach_axis_sizes(jcm.arch_rules(jspec.cfg, base), mesh)


def _jax_loss_and_grad(arch, tok, mesh):
    jspec, _ = _specs(arch)
    params, _ = _weights(arch)
    rules = _jax_rules(jspec, mesh)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    with mesh:
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, bb: jlm.loss_fn(jspec, p, bb, rules=rules), has_aux=True))(params, batch)
    return float(loss), g


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4, CHAMELEON])
def test_grid_loss_matches_jax_mesh22(arch, mesh22):
    tok = _tokens(512)
    two, _ = _port_grid_loss(arch, tok, make_cpu_mesh(2, 2))
    want, _ = _jax_loss_and_grad(arch, tok, mesh22)
    assert two == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grid_router_and_expert_grads_match_jax(arch, mesh22):
    tok = _tokens(512)
    _, grads = _port_grid_loss(arch, tok, make_cpu_mesh(2, 2), grads=True)
    _, jg = _jax_loss_and_grad(arch, tok, mesh22)
    jspec, _ = _specs(arch)
    moe_at = [bi for bi, bt in enumerate(jspec.groups[0].block_types) if bt == "attn_moe"][0]
    got, want = grads["groups"][0][str(moe_at)]["moe"], jg["groups"][0][str(moe_at)]["moe"]
    for k in ("router", "w_gate", "w_up", "w_down"):
        a, b = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("arch,opt_name,pod", [(GRANITE, "adamw", False),
                                              (LLAMA4, "adafactor", False),
                                              (LLAMA4, "adafactor", True)])
def test_grid_train_step_matches_jax(arch, opt_name, pod, mesh22, mesh_pod):
    """One step from the same parameters and zero state on 2x2 against JAX on
    ``mesh22``, and on 2x2x2 under the multi-pod rules against JAX on
    ``mesh_pod`` (eps 1e-3 for AdamW, as
    ``test_torch_training.py::test_train_step_matches_jax`` explains)."""
    jspec, tspec = _specs(arch)
    params, np_tree = _weights(arch)
    assert tspec.cfg.optimizer == opt_name
    mesh = mesh_pod if pod else mesh22
    kw = dict(name=opt_name, lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    jstep, *_ = jts.make_train_step(jspec, mesh, joptim.OptConfig(**kw), donate=False)
    tok = _tokens(512, 8, 16, seed=5)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    with mesh:
        jp1, _, jm = jstep(params, joptim.make_optimizer(joptim.OptConfig(**kw))[0](params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    grid = make_cpu_mesh(2, 2, pod=2 if pod else 0)
    ocfg = toptim.OptConfig(**kw)
    pspecs, ospecs = tts.grid_specs(tspec, ocfg, grid)
    tree = lm_tree_from_numpy(np_tree, "cpu")
    pg = tcm.shard_tree(tree, pspecs, grid)
    sg = tcm.shard_tree(toptim.make_optimizer(ocfg)[0](tree), ospecs, grid)
    pg, sg, tm = tts.make_train_step(tspec, ocfg, grid=grid)(pg, sg, batch)
    for k in ("loss", "grad_norm", "xent"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    got = tcm.unshard_tree(pg, pspecs, grid)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(jp1), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4, CHAMELEON])
def test_grid_serve_matches_jax_mesh22(arch, mesh22):
    jspec, tspec = _specs(arch)
    params, np_tree = _weights(arch)
    prompts = _tokens(512, 4, 8, seed=1)
    want = JServeEngine(jspec, mesh22, params, s_max=16, batch=4,
                        cfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    eng = ServeEngine(tspec, lm_params_from_numpy(tspec, np_tree, "cpu"), s_max=16, batch=4,
                      device="cpu", grid=make_cpu_mesh(2, 2), cfg=ServeConfig(max_new_tokens=4))
    np.testing.assert_array_equal(eng.generate(prompts), want)


# ---------------------------------------------------------------------------
# the serve rules: prefill per batch shard, decode gathered
# ---------------------------------------------------------------------------


def _serve_view(tspec, np_tree, rules, grid):
    tree = tlm.param_dict(lm_params_from_numpy(tspec, np_tree, "cpu"))
    specs = tcm.sanitize_specs(tlm.param_specs(tspec, rules), tree, grid)
    tiles = lm_grid_params_from_numpy(tspec, np_tree, specs, grid)
    return tlm.grid_view(tspec, tiles, specs, grid, stacked=False), tiles


def test_prefill_per_batch_shard_decode_gathered():
    """llama4 SMOKE on 2x2 through the engine's rules: each prefill tile
    routes its batch shard's 2 x 8 tokens and gathers its experts' d_model
    halves over data (the expert stacks are stored by the decode rules);
    each decode tile routes all 4 tokens and moves no expert weight."""
    _, tspec = _specs(LLAMA4)
    _, np_tree = _weights(LLAMA4)
    grid = make_cpu_mesh(2, 2)
    rules = serve_rules(tspec, grid)
    view, _ = _serve_view(tspec, np_tree, rules, grid)
    run = tcm.GridRun(rules)
    tok = run.place(torch.as_tensor(_tokens(512, 4, 8), dtype=torch.int64), ("batch", "seq"))
    with torch.inference_mode(), tmoe.record_routing() as log:
        before = coll.lm_moves()["lm.serve"]["gather_bytes"]
        logits, cache = tlm.prefill(tspec, view, tok, 16, rules=prefill_rules(rules))
        pf_gather = coll.lm_moves()["lm.serve"]["gather_bytes"] - before
        n_pf = len(log)
        nxt = run.place(torch.tensor([3, 17, 250, 9]), ("batch",))
        before = coll.lm_moves()["lm.serve"]["gather_bytes"]
        tlm.decode_step(tspec, view, nxt, cache, rules=rules)
        dec_gather = coll.lm_moves()["lm.serve"]["gather_bytes"] - before
    n_moe = sum(bt == "attn_moe" for bt in tspec.layers())
    assert n_pf == n_moe and len(log) == 2 * n_moe
    assert all(r.expert_ids.shape[0] == 16 for rs in log[:n_pf] for r in rs)
    assert all(r.expert_ids.shape[0] == 4 for rs in log[n_pf:] for r in rs)
    # prefill: per MoE layer three (4, 64, 64) stacks, each tile gathering the
    # other data half of its (4, 32, 64) / (4, 64, 32) slices (32 KiB, 4 tiles)
    stacks = n_moe * 3 * 4 * 32 * 1024
    assert pf_gather >= stacks and dec_gather < stacks / 4


def test_dense_serve_unchanged_by_the_rules_split():
    """The dense family under the prefill and the decode rules: the same
    per-tile logits and cache, bit for bit (the split changes only the MoE
    layer's branch)."""
    from repro_torch.models.common import ArchConfig

    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=256, remat=False, compute_dtype="float32")
    spec = tlm.build_spec(cfg)
    grid = make_cpu_mesh(2, 2)
    rules = serve_rules(spec, grid)
    params = tlm.init_params(spec, seed=2, device="cpu")
    tree = tlm.param_dict(params)
    specs = tcm.sanitize_specs(tlm.param_specs(spec, rules), tree, grid)
    view = tlm.grid_view(spec, tcm.shard_tree(tree, specs, grid), specs, grid, stacked=False)
    tok = tcm.GridRun(rules).place(torch.as_tensor(_tokens(256, 4, 8), dtype=torch.int64),
                                   ("batch", "seq"))
    with torch.inference_mode():
        a, ca = tlm.prefill(spec, view, tok, 16, rules=rules)
        b, cb = tlm.prefill(spec, view, tok, 16, rules=prefill_rules(rules))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for la, lb in zip(ca["layers"], cb["layers"]):
        assert all(torch.equal(x, y) for x, y in zip(la["k"], lb["k"]))


def test_llama4_grid_decode_equals_1x1():
    """The gathered decode step routes all B tokens with one capacity, as one
    device does: from the same cache, the grid's logits are the 1x1 step's."""
    _, tspec = _specs(LLAMA4)
    _, np_tree = _weights(LLAMA4)
    params = lm_params_from_numpy(tspec, np_tree, "cpu")
    grid = make_cpu_mesh(2, 2)
    rules = serve_rules(tspec, grid)
    view, _ = _serve_view(tspec, np_tree, rules, grid)
    prompts = torch.as_tensor(_tokens(512, 4, 8), dtype=torch.int64)
    with torch.inference_mode():
        _, cache = tlm.prefill(tspec, params, prompts, 16)
        nxt = torch.tensor([3, 17, 250, 9])
        want, _ = tlm.decode_step(tspec, params, nxt, cache)
        run = tcm.GridRun(rules)
        gcache = tlm.cache_to_grid(tspec, cache, rules)
        got, _ = tlm.decode_step(tspec, view, run.place(nxt, ("batch",)), gcache, rules=rules)
    _close(_whole(got, grid), want.numpy(), 1e-5)


@pytest.mark.parametrize("arch,layout", [(GRANITE, "train"), (GRANITE, "serve"),
                                         (LLAMA4, "train"), (LLAMA4, "serve")])
def test_interop_places_expert_stacks(arch, layout):
    """The JAX weights cut onto 2x2 by the train specs (``grid_tree_from_numpy``)
    or the serve specs (``lm_grid_params_from_numpy``): each expert stack's
    tile is its spec's slice ((E, d, f) / (E, f, d): llama4's experts over
    model and d over data, granite-moe's f over model and d over data), and
    the tiles put back together are the JAX weights."""
    from repro_torch.interop import grid_tree_from_numpy

    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    grid = make_cpu_mesh(2, 2)
    moe_at = str([bi for bi, bt in enumerate(tspec.groups[0].block_types)
                  if bt == "attn_moe"][0])
    if layout == "train":
        pspecs, _ = tts.grid_specs(tspec, toptim.OptConfig(), grid)
        tiles = grid_tree_from_numpy(np_tree, pspecs, grid, requires_grad=True)
        got = tcm.unshard_tree(tiles, pspecs, grid)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(np_tree), strict=True):
            np.testing.assert_array_equal(a.detach().numpy(), b)
        spec = pspecs["groups"][0][moe_at]["moe"]["w_gate"][1:]
        tile = tiles[3]["groups"][0][moe_at]["moe"]["w_gate"][0]
        whole = np_tree["groups"][0][moe_at]["moe"]["w_gate"][0]
    else:
        rules = serve_rules(tspec, grid)
        tree = tlm.param_dict(lm_params_from_numpy(tspec, np_tree, "cpu"))
        specs = tcm.sanitize_specs(tlm.param_specs(tspec, rules), tree, grid)
        tiles = lm_grid_params_from_numpy(tspec, np_tree, specs, grid)
        layer = int(moe_at)
        spec = specs["blocks"][layer]["moe"]["w_gate"]
        tile = tiles[3]["blocks"][layer]["moe"]["w_gate"]
        whole = np_tree["groups"][0][moe_at]["moe"]["w_gate"][0]
    want = {GRANITE: (None, "data", "model"), LLAMA4: ("model", "data", None)}[arch]
    assert tuple(spec) == want
    e, d, f = whole.shape
    cut = whole[e // 2:] if want[0] else whole
    cut = cut[:, d // 2:]
    cut = cut[:, :, f // 2:] if want[2] else cut
    np.testing.assert_array_equal(tile.detach().numpy(), cut)


# ---------------------------------------------------------------------------
# the port's own grid: replicas, storage, the pod step, the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_replicas_stay_bitwise_equal(arch):
    """One step on 2x2: every copy of a replicated parameter tile equals its
    first copy, bit for bit."""
    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    grid = make_cpu_mesh(2, 2)
    ocfg = toptim.OptConfig(name=tspec.cfg.optimizer, lr=1e-3)
    pspecs, ospecs = tts.grid_specs(tspec, ocfg, grid)
    tree = lm_tree_from_numpy(np_tree, "cpu")
    pg = tcm.shard_tree(tree, pspecs, grid)
    sg = tcm.shard_tree(toptim.make_optimizer(ocfg)[0](tree), ospecs, grid)
    tok = _tokens(512, 4, 16, seed=5)
    pg, _, _ = tts.make_train_step(tspec, ocfg, grid=grid)(pg, sg, {"tokens": tok, "labels": tok})
    specs = [s for _, s in toptim.sorted_spec_paths(pspecs)]
    leaves = [tree_leaves(t) for t in pg]
    for i, s in enumerate(specs):
        used = {a for e in s for a in coll.entry_axes(e)}
        for t in range(4):
            c0 = {k: (v if k in used else 0) for k, v in grid.coords(t).items()}
            assert torch.equal(leaves[t][i], leaves[grid.index(c0)][i])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tile_storage_equals_dry_run(arch):
    """The train state's and the engine's per-tile bytes are the dry run's
    ``argument_bytes`` (train_4k and decode_32k cells)."""
    _, tspec = _specs(arch)
    grid = make_cpu_mesh(2, 2)
    ocfg = toptim.OptConfig(name=tspec.cfg.optimizer)
    params, state = tts.init_state(tspec, ocfg, seed=0, grid=grid)
    base = dict(tcm.DEFAULT_RULES)
    want = tdry.argument_bytes(tspec, tconfigs.SHAPES_BY_NAME["train_4k"], grid, base,
                               ocfg.name)
    for t in range(4):
        assert sum(x.numel() * x.element_size() for x in tree_leaves(params[t])) \
            == want["param_bytes_per_tile"]
        assert sum(x.numel() * x.element_size() for x in tree_leaves(state[t])) \
            == want["opt_state_bytes_per_tile"]
    eng = ServeEngine(tspec, tlm.init_params(tspec, seed=0, device="cpu"), s_max=16,
                      device="cpu", grid=grid)
    want = tdry.argument_bytes(tspec, tconfigs.SHAPES_BY_NAME["decode_32k"], grid, base, "adamw")
    for t in range(4):
        assert sum(x.numel() * x.element_size() for x in tree_leaves(eng.tiles[t])) \
            == want["param_bytes_per_tile"]


def test_engine_tiles_equal_dry_run_in_the_compute_dtype():
    """granite-moe as it is served (fp32 parameters, bf16 compute): the
    engine's tiles hold the matrices in bf16, which the dry run's decode
    cell counts with ``compute_cast``; the fp32 count is larger."""
    cfg = tconfigs.get_smoke(GRANITE).replace(compute_dtype="bfloat16")
    tspec = tlm.build_spec(cfg)
    grid = make_cpu_mesh(2, 2)
    eng = ServeEngine(tspec, tlm.init_params(tspec, seed=0, device="cpu"), s_max=16,
                      device="cpu", grid=grid)
    cell = tconfigs.SHAPES_BY_NAME["decode_32k"]
    base = dict(tcm.DEFAULT_RULES)
    want = tdry.argument_bytes(tspec, cell, grid, base, "adamw", compute_cast=True)
    got = {sum(x.numel() * x.element_size() for x in tree_leaves(t)) for t in eng.tiles}
    assert got == {want["param_bytes_per_tile"]}
    assert tdry.argument_bytes(tspec, cell, grid, base, "adamw")["param_bytes_per_tile"] \
        > want["param_bytes_per_tile"]


def _flipped(r, row: int, col: int, gap: float):
    """``r`` with token ``row``'s choice ``col`` moved to its next expert not
    chosen, and ``r`` with that expert's probability set ``gap`` below the
    chosen one's."""
    ids, probs = r.expert_ids.clone(), r.probs.clone()
    new = next(e for e in range(probs.shape[1]) if e not in ids[row].tolist())
    probs[row, new] = probs[row, ids[row, col]] - gap
    ids[row, col] = new
    return dataclasses.replace(r, expert_ids=ids), dataclasses.replace(r, probs=probs)


def test_compare_routings_stops_a_tile_at_its_first_flip():
    """A flip within the margin is allowed and counted; that tile's tokens
    from the flip on are not compared in this layer or a later one, while
    its earlier tokens and the other tiles still are; a wider flip, or a
    kept mask that differs before the flip, raises."""
    cfg = tconfigs.get_smoke(GRANITE)
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    rs = [tmoe.route(cfg, p, torch.randn(32, cfg.d_model, generator=gen), 6) for _ in range(4)]
    want = [[rs[0], rs[1]], [rs[2], rs[3]]]  # two layers of two tiles
    assert all(r["flips"] == 0 and r["compared_tokens"] == 32
               for r in tmoe.compare_routings(want, want, 1e-5))
    got0, want0 = _flipped(rs[0], 9, 0, 1e-6)
    later = dataclasses.replace(rs[2], keep=rs[2].keep.clone())
    later.keep[20:] = ~later.keep[20:]  # tile 0, layer 1: past its flip, not compared
    out = tmoe.compare_routings([[got0, rs[1]], [later, rs[3]]],
                                [[want0, rs[1]], [rs[2], rs[3]]], 1e-5)
    assert [(r["layer"], r["tile"], r["flips"], r["compared_tokens"]) for r in out] == [
        (0, 0, 1, 32), (0, 1, 0, 32), (1, 0, 0, 9), (1, 1, 0, 32)]
    with pytest.raises(ValueError, match="routing flips"):
        tmoe.compare_routings([got0], [_flipped(rs[0], 9, 0, 1e-3)[1]], 1e-5)
    early = dataclasses.replace(rs[2], keep=rs[2].keep.clone())
    early.keep[3] = ~early.keep[3]
    with pytest.raises(ValueError, match="kept masks differ before token 9"):
        tmoe.compare_routings([[got0, rs[1]], [early, rs[3]]],
                              [[want0, rs[1]], [rs[2], rs[3]]], 1e-5)
    with pytest.raises(ValueError, match="kept masks differ"):
        tmoe.compare_routings([[rs[1], rs[2]]], [[rs[1], early]], 1e-5)


def test_moe_compressed_train_step_on_pod_grid():
    """granite-moe's compressed step on 2x2x2: finite, its loss the
    uncompressed multi-pod step's (the same forward: each pod's rows on its
    own sub-grid) within rel 1e-5."""
    _, tspec = _specs(GRANITE)
    grid = make_cpu_mesh(2, 2, pod=2)
    ocfg = toptim.OptConfig(lr=1e-3)
    step, ef_init, _ = tts.make_compressed_train_step(tspec, grid, ocfg)
    params, opt = tts.init_pod_state(tspec, ocfg, grid, seed=0)
    tok = _tokens(512, 8, 16, seed=5)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    losses, _, _ = step.pod_grads(params, batch)
    _, _, m, ef = step(params, opt, batch, ef_init(params))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx((float(losses[0]) + float(losses[4])) / 2, rel=1e-5)
    assert float(m["lb_loss"]) > 0
    assert any(float(torch.max(torch.abs(e))) > 0 for t in ef for e in tree_leaves(t))


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4, CHAMELEON])
def test_launchers_run_moe_and_vlm_on_grid(arch, capsys, tmp_path):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--data", "2", "--model", "2",
                 "--max-new", "3", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "grid 2x2" in out and "moved between grid positions" in out
    ttrain.main(["--arch", arch, "--smoke", "--steps", "1", "--batch", "4", "--seq", "16",
                 "--device", "cpu", "--data", "2", "--model", "2",
                 "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"])
    assert "[train] done" in capsys.readouterr().out
