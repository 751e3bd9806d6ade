"""RWKV6 and Mamba2 (zamba2, with its shared attention block) on a device
grid: the port on 2x2, 1x4, 4x1 and 2x2x2 CPU grids against the JAX
package on ``mesh22`` and against the port's own 1x1 path.

Neither family depends on the grid through a capacity, so a grid gives the
1x1 model up to the order of its sums.  The SMOKE models' weights come from
the JAX package's ``lm.init_params`` (``PRNGKey(3)``) through numpy
(``interop``); tokens from numpy ``default_rng``.  Tolerances (fp32
throughout), ``tests/test_torch_grid_lm.py``'s and
``tests/test_torch_training.py``'s:

- the loss on every grid (baseline rules; fsdp and seqshard on 2x2; the
  multi-pod rules on 2x2x2) against JAX on ``mesh22`` and port 1x1: rel
  1e-5;
- every gradient on 2x2 -- zamba2's one ``shared_attn`` set too, which its
  13 (SMOKE: 2) invocations reach -- against JAX's: rtol 1e-4, entries
  within 1e-4 of the leaf's largest;
- one AdamW step on 2x2 against JAX's ``make_train_step`` on ``mesh22``:
  loss, grad norm and xent rel 1e-5, parameters rtol 1e-4 / atol 1e-5;
- prefill and decode logits within 1e-5 of the largest, against JAX's
  ``prefill`` / ``decode_step`` on ``mesh22`` (and, under the long-context
  rules, against port 1x1); greedy tokens equal to the JAX ``ServeEngine``
  on ``mesh22`` and to port 1x1;
- a JAX-laid Mamba2 conv cache cut onto 2x2 and 1x4 by ``cache_to_grid``
  against the port's grid prefill cache: equal shapes, values within 1e-5
  of the largest (two packages' fp32 products);
- moved bytes of one rwkv6 prefill counted by hand; tile bytes equal to
  the dry run's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import common as jcm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.training import optim as joptim
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.core import collectives as coll
from repro_torch.interop import lm_grid_params_from_numpy, lm_params_from_numpy, lm_tree_from_numpy
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import serve_rules
from repro_torch.training import optim as toptim
from repro_torch.training import train_step as tts
from repro_torch.tree import tree_leaves

RWKV, ZAMBA = "rwkv6-3b", "zamba2-7b"
ARCHS = [RWKV, ZAMBA]
GRIDS = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1), "pod2x2x2": (2, 2, 2)}


def _grid(name):
    shape = GRIDS[name]
    return make_cpu_mesh(*shape[1:], pod=shape[0]) if len(shape) == 3 else make_cpu_mesh(*shape)


def _specs(arch):
    return jlm.build_spec(jconfigs.get_smoke(arch)), tlm.build_spec(tconfigs.get_smoke(arch))


_WEIGHTS, _JAX = {}, {}


def _weights(arch):
    """The JAX package's SMOKE weights (PRNGKey(3)) and the same as numpy."""
    if arch not in _WEIGHTS:
        p = jlm.init_params(_specs(arch)[0], jax.random.PRNGKey(3))
        _WEIGHTS[arch] = (p, jax.tree.map(np.asarray, p))
    return _WEIGHTS[arch]


def _tokens(b=4, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(np.int32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _whole(x: coll.Sharded, grid) -> np.ndarray:
    return tcm.unshard_tree([{"x": t} for t in x], {"x": tcm.Spec(*x.spec)}, grid)["x"].numpy()


def _rows(logits: coll.Sharded, grid) -> np.ndarray:
    """Per-tile (batch rows, whole vocab) logits put together (the first copy of each row)."""
    ax = coll.entry_axes(logits.spec[0])
    return torch.cat([logits[t] for t in range(grid.n_tiles)
                      if all(grid.coords(t)[a] == 0 for a in grid.axis_names if a not in ax)]
                     ).numpy()


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def _port_loss(arch, tok, grid=None, preset="baseline", grads=False):
    """The port's loss (and whole gradients) on ``grid`` (None: one device)."""
    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    tree = lm_tree_from_numpy(np_tree, "cpu")
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if grid is None:
        loss, _ = tlm.loss_fn(tspec, tlm.params_view(tspec, tree),
                              tts.batch_to_device(batch, "cpu"))
        return float(loss.detach()), None
    rules = None if preset == "baseline" else tdry.RULE_PRESETS[preset](grid)
    pspecs, _ = tts.grid_specs(tspec, toptim.OptConfig(), grid, rules)
    run = tcm.GridRun(tts.train_rules(tspec, grid, rules))
    loss, _, gtrees = tts.grid_loss_and_grad(tspec, tcm.shard_tree(tree, pspecs, grid),
                                             tts.place_batch(batch, run), pspecs, run)
    vals = {float(x) for x in loss}
    assert len(vals) == 1, f"the loss differs between tiles: {vals}"
    return vals.pop(), tcm.unshard_tree(gtrees, pspecs, grid) if grads else None


def _jax_loss_and_grad(arch, tok, mesh):
    key = (arch, tok.tobytes())
    if key not in _JAX:
        jspec, _ = _specs(arch)
        params, _ = _weights(arch)
        rules = jcm.attach_axis_sizes(jcm.arch_rules(jspec.cfg, dict(jcm.DEFAULT_RULES)), mesh)
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(np.roll(tok, -1, axis=1))}
        with mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, bb: jlm.loss_fn(jspec, p, bb, rules=rules), has_aux=True))(params,
                                                                                    batch)
        _JAX[key] = (float(loss), g)
    return _JAX[key]


@pytest.mark.parametrize("grid_name", list(GRIDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_loss_matches_jax_mesh22_and_1x1(arch, grid_name, mesh22):
    tok = _tokens()
    got, _ = _port_loss(arch, tok, _grid(grid_name))
    one, _ = _port_loss(arch, tok)
    want, _ = _jax_loss_and_grad(arch, tok, mesh22)
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(one, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_grads_match_jax_mesh22(arch, mesh22):
    """Every leaf's gradient on 2x2 against JAX's, zamba2's shared block's
    one parameter set included."""
    tok = _tokens()
    _, grads = _port_loss(arch, tok, make_cpu_mesh(2, 2), grads=True)
    _, jg = _jax_loss_and_grad(arch, tok, mesh22)
    if arch == ZAMBA:
        assert set(grads["shared_attn"]) == {"ln", "attn", "ln2", "mlp"}
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(jg), strict=True):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("preset", ["fsdp", "seqshard"])
@pytest.mark.parametrize("arch", ARCHS)
def test_presets_match_1x1(arch, preset):
    """fsdp (batch over both axes, inner whole) and seqshard (the sequence
    over model: the token shift, the causal conv and the chunk scans read
    the rows of the tile before, so the recurrent blocks gather the
    sequence) on 2x2, 1x4 and 4x1 against 1x1."""
    tok = _tokens()
    one, _ = _port_loss(arch, tok)
    for shape in ((2, 2), (1, 4), (4, 1)):
        got, _ = _port_loss(arch, tok, make_cpu_mesh(*shape), preset)
        assert got == pytest.approx(one, rel=1e-5), shape


def test_seqshard_gathers_the_sequence_for_the_recurrence():
    """rwkv6 under seqshard on 1x4: each tile's 4 of the 16 positions; the
    blocks' inputs are gathered over model (counted), and the loss is the
    1x1 loss."""
    tok = _tokens()
    before = coll.lm_moves()["lm.train"]["gather_bytes"]
    got, _ = _port_loss(RWKV, tok, make_cpu_mesh(1, 4), "seqshard")
    moved = coll.lm_moves()["lm.train"]["gather_bytes"] - before
    # two blocks a layer, each gathering (4, 4, 64) fp32 (4 KiB) from 3 others on 4 tiles
    assert moved >= 2 * 2 * 3 * 4 * 4096
    assert got == pytest.approx(_port_loss(RWKV, tok)[0], rel=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_train_step_matches_jax(arch, mesh22):
    """One AdamW step from the same parameters and zero state on 2x2 against
    JAX on ``mesh22`` (eps 1e-3, as ``test_torch_training.py`` explains)."""
    jspec, tspec = _specs(arch)
    params, np_tree = _weights(arch)
    kw = dict(name="adamw", lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    jstep, *_ = jts.make_train_step(jspec, mesh22, joptim.OptConfig(**kw), donate=False)
    tok = _tokens(8, 16, seed=5)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    with mesh22:
        jp1, _, jm = jstep(params, joptim.make_optimizer(joptim.OptConfig(**kw))[0](params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    grid = make_cpu_mesh(2, 2)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_and_compressed_step_on_pod_grid(arch):
    """``init_state(grid=)`` cuts the port's own init onto 2x2 (each tile at
    its ``tile_shape``, the tiles put back the 1x1 state), and one int8
    compressed step on 2x2x2 is finite with the uncompressed step's loss."""
    _, tspec = _specs(arch)
    ocfg = toptim.OptConfig(lr=1e-3)
    grid = make_cpu_mesh(2, 2)
    p1, _ = tts.init_state(tspec, ocfg, seed=2, device="cpu")
    pg, _ = tts.init_state(tspec, ocfg, seed=2, grid=grid)
    pspecs, _ = tts.grid_specs(tspec, ocfg, grid)
    for a, b in zip(tree_leaves(tcm.unshard_tree(pg, pspecs, grid)), tree_leaves(p1)):
        assert torch.equal(a, b.detach())
    pod = make_cpu_mesh(2, 2, pod=2)
    step, ef_init, _ = tts.make_compressed_train_step(tspec, pod, ocfg)
    params, opt = tts.init_pod_state(tspec, ocfg, pod, seed=2)
    tok = _tokens(8, 16, seed=5)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    _, _, m, _ = step(params, opt, batch, ef_init(params))
    plain, _ = tts.init_state(tspec, ocfg, seed=2, grid=pod)
    _, _, mp = tts.make_train_step(tspec, ocfg, grid=pod)(
        plain, [toptim.make_optimizer(ocfg)[0](t) for t in plain], batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx(float(mp["loss"]), rel=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve_view(tspec, np_tree, rules, grid):
    tree = tlm.param_dict(lm_params_from_numpy(tspec, np_tree, "cpu"))
    specs = tcm.sanitize_specs(tlm.param_specs(tspec, rules), tree, grid)
    tiles = lm_grid_params_from_numpy(tspec, np_tree, specs, grid)
    return tlm.grid_view(tspec, tiles, specs, grid, stacked=False), tiles


def _jax_prefill_decode(arch, prompts, nxt, mesh):
    jspec, _ = _specs(arch)
    params, _ = _weights(arch)
    rules = jcm.attach_axis_sizes(jcm.arch_rules(jspec.cfg, dict(jcm.DEFAULT_RULES)), mesh)
    with mesh:
        lg, cache = jax.jit(lambda p, b: jlm.prefill(jspec, p, b, 16, rules=rules))(
            params, {"tokens": jnp.asarray(prompts)})
        lg2, _ = jax.jit(lambda p, t, c: jlm.decode_step(jspec, p, t, c, rules=rules))(
            params, jnp.asarray(nxt), cache)
    return np.asarray(lg), np.asarray(lg2), jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_prefill_and_decode_logits_match_jax(arch, mesh22):
    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    prompts, nxt = _tokens(4, 8, seed=1), np.array([3, 17, 250, 9], np.int32)
    want_pf, want_dec, _ = _jax_prefill_decode(arch, prompts, nxt, mesh22)
    for shape in ((2, 2), (1, 4), (4, 1)):
        grid = make_cpu_mesh(*shape)
        rules = serve_rules(tspec, grid)
        view, _ = _serve_view(tspec, np_tree, rules, grid)
        run = tcm.GridRun(rules)
        with torch.inference_mode():
            lg, cache = tlm.prefill(tspec, view, run.place(
                torch.as_tensor(prompts, dtype=torch.int64), ("batch", "seq")), 16, rules=rules)
            lg2, _ = tlm.decode_step(tspec, view, run.place(torch.as_tensor(nxt).long(),
                                                            ("batch",)), cache, rules=rules)
        _close(_rows(lg, grid), want_pf, 1e-5)
        _close(_rows(lg2, grid), want_dec, 1e-5)


def _jax_greedy(arch, prompts, mesh, n_new):
    """Greedy tokens of the JAX package's ``prefill`` and ``decode_step``,
    each jitted on ``mesh`` under the JAX engine's decode rules."""
    jspec, _ = _specs(arch)
    params, _ = _weights(arch)
    rules = jcm.attach_axis_sizes({**jcm.arch_rules(jspec.cfg, dict(jcm.DEFAULT_RULES)),
                                   "moe_gathered": True, "embed_p": None, "embed_d": None},
                                  mesh)
    with mesh:
        lg, cache = jax.jit(lambda p, b: jlm.prefill(jspec, p, b, 16, rules=rules))(
            params, {"tokens": jnp.asarray(prompts)})
        step = jax.jit(lambda p, t, c: jlm.decode_step(jspec, p, t, c, rules=rules))
        out = []
        for _ in range(n_new):
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            out.append(np.asarray(tok))
            lg, cache = step(params, tok, cache)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_serve_matches_jax_mesh22_and_1x1(arch, mesh22):
    """Greedy tokens on 2x2, 1x4, 4x1 and 1x1 against JAX on ``mesh22``: its
    ``ServeEngine`` for rwkv6; for zamba2 its ``prefill`` and ``decode_step``
    jitted on the mesh (the JAX engine's decode step declares the Mamba2
    conv cache split over model on its last dim, and refuses the cache its
    own prefill returns on ``mesh22``)."""
    jspec, tspec = _specs(arch)
    params, np_tree = _weights(arch)
    prompts = _tokens(4, 8, seed=1)
    if arch == RWKV:
        want = JServeEngine(jspec, mesh22, params, s_max=16, batch=4,
                            cfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    else:
        want = _jax_greedy(arch, prompts, mesh22, 4)
    tparams = lm_params_from_numpy(tspec, np_tree, "cpu")
    for grid in (None, make_cpu_mesh(2, 2), make_cpu_mesh(1, 4), make_cpu_mesh(4, 1)):
        eng = ServeEngine(tspec, tparams, s_max=16, batch=4, device="cpu", grid=grid,
                          cfg=ServeConfig(max_new_tokens=4))
        np.testing.assert_array_equal(eng.generate(prompts), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_rules_serve_like_1x1(arch):
    """The long_500k cells' rules (batch whole, the KV positions over every
    axis, heads and inner over model) on 2x2 and 2x2x2: prefill and decode
    logits within 1e-5 of the 1x1 ones, greedy tokens equal."""
    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    prompts = _tokens(1, 12, seed=4)
    tparams = lm_params_from_numpy(tspec, np_tree, "cpu")
    one = ServeEngine(tspec, tparams, s_max=24, device="cpu", cfg=ServeConfig(max_new_tokens=6))
    want = one.generate(prompts)
    with torch.inference_mode():
        pf1, c1 = tlm.prefill(tspec, one.params, torch.as_tensor(prompts).long(), 24)
        dec1, _ = tlm.decode_step(tspec, one.params, torch.tensor([5]), c1)
    for grid in (make_cpu_mesh(2, 2), make_cpu_mesh(2, 2, pod=2)):
        rules = tdry.long_context_rules(grid)
        eng = ServeEngine(tspec, tparams, s_max=24, device="cpu", grid=grid, rules=rules,
                          cfg=ServeConfig(max_new_tokens=6))
        np.testing.assert_array_equal(eng.generate(prompts), want)
        run = tcm.GridRun(eng.rules)
        with torch.inference_mode():
            pf, cache = tlm.prefill(tspec, eng.params, run.place(torch.as_tensor(prompts).long(),
                                                                 ("batch", "seq")), 24,
                                    rules=eng.prefill_rules)
            dec, _ = tlm.decode_step(tspec, eng.params, run.place(torch.tensor([5]), ("batch",)),
                                     cache, rules=eng.rules)
        if arch == ZAMBA:  # the shared block's K/V positions over every axis
            k = cache["layers"][3]["k"]
            assert k.spec[1] == tuple(grid.axis_names) and k[0].shape[1] == 24 // grid.n_tiles
        _close(pf[0].numpy(), pf1.numpy(), 1e-5)
        _close(dec[0].numpy(), dec1.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the caches
# ---------------------------------------------------------------------------


def _jax_cache_per_layer(tspec, jcache):
    """The JAX prefill's cache (stacked per group) in the port's layout: one
    dict a block in execution order, each shared-block invocation its own."""
    layers = []
    for g, gc in zip(tspec.groups, jcache["groups"]):
        for i in range(g.count):
            for bi, _ in enumerate(g.block_types):
                layers.append({k: torch.from_numpy(np.array(v[i]))
                               for k, v in gc[str(bi)].items()})
    return {"layers": layers, "pos": int(jcache["pos"])}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_jax_conv_cache_cut_onto_grid_equals_grid_prefill(shape, mesh22):
    """zamba2's Mamba2 conv cache is (B, 3, d_inner + 2N) split over inner on
    its last dim, a boundary that is not the heads' (SMOKE: 160 columns,
    80 or 40 a tile, the x channels 128): the JAX prefill's cache, cut by
    ``cache_to_grid``, against the port's grid prefill cache, tile by tile;
    the SSD states (heads over inner) and the shared block's K/V too."""
    _, tspec = _specs(ZAMBA)
    _, np_tree = _weights(ZAMBA)
    prompts = _tokens(4, 8, seed=1)
    _, _, jcache = _jax_prefill_decode(ZAMBA, prompts, np.zeros(4, np.int32), mesh22)
    grid = make_cpu_mesh(*shape)
    rules = serve_rules(tspec, grid)
    cut = tlm.cache_to_grid(tspec, _jax_cache_per_layer(tspec, jcache), rules)
    view, _ = _serve_view(tspec, np_tree, rules, grid)
    with torch.inference_mode():
        _, cache = tlm.prefill(tspec, view, tcm.GridRun(rules).place(
            torch.as_tensor(prompts, dtype=torch.int64), ("batch", "seq")), 16, rules=rules)
    assert cut["pos"] == cache["pos"] == 8
    conv = cache["layers"][0]["conv"]
    assert conv.spec == (("data",), None, ("model",)) and conv.shape == (4, 3, 160)
    assert conv[0].shape == (4 // shape[0], 3, 160 // shape[1])
    for a, b in zip(cut["layers"], cache["layers"], strict=True):
        assert set(a) == set(b)
        for k in a:
            assert a[k].spec == b[k].spec
            for x, y in zip(a[k], b[k]):
                _close(y.numpy(), x.numpy(), 1e-5)


def test_rwkv_prefill_moves_counted_by_hand():
    """rwkv6 SMOKE's prefill of 4 x 8 tokens on 2x2 under the serve rules
    (batch rows over data, 2 a tile; inner, ff and vocab over model, 2 heads
    a tile): each tile's (2, 8, 64) fp32 rows (4096 B) are all-reduced over
    the 2-wide model axis five times -- the vocab-sharded embedding, then
    each layer's time-mix (``wo``'s partials) and channel-mix (``kv``'s
    partials) -- 5 x 4 x 4096 B; each layer's channel-mix gathers its
    (2, 8, 32) gated slices (2048 B) over model, 2 x 4 x 2048 B, and the
    last position's (2, 1, 256) logits (2048 B) are gathered over model,
    4 x 2048 B.  The WKV states stay on their heads' tiles."""
    _, tspec = _specs(RWKV)
    _, np_tree = _weights(RWKV)
    grid = make_cpu_mesh(2, 2)
    rules = serve_rules(tspec, grid)
    view, _ = _serve_view(tspec, np_tree, rules, grid)
    tok = tcm.GridRun(rules).place(torch.as_tensor(_tokens(4, 8), dtype=torch.int64),
                                   ("batch", "seq"))
    before = coll.lm_moves()["lm.serve"]
    with torch.inference_mode():
        logits, cache = tlm.prefill(tspec, view, tok, 16, rules=rules)
    after = coll.lm_moves()["lm.serve"]
    d = {k: after[k] - before[k] for k in after}
    assert d["reduce_bytes"] == 5 * 4 * 4096 and d["reduces"] == 5
    assert d["gather_bytes"] == 2 * 4 * 2048 + 4 * 2048 and d["gathers"] == 3
    assert d["reduce_scatter_bytes"] == 0 and d["permute_bytes"] == 0
    wkv = cache["layers"][0]["wkv"]
    assert wkv.spec == (("data",), ("model",), None, None) and wkv[0].shape == (2, 2, 16, 16)
    assert cache["layers"][0]["tm_prev"][0].shape == (2, 1, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_tile_bytes_equal_dry_run(arch):
    """2x2: the engine's parameter tiles and the grid cache's tiles at a
    small decode cell (batch 4, 16 positions), and the training state's
    tiles (AdamW), against the dry run's ``argument_bytes``."""
    _, tspec = _specs(arch)
    _, np_tree = _weights(arch)
    grid = make_cpu_mesh(2, 2)
    eng = ServeEngine(tspec, lm_params_from_numpy(tspec, np_tree, "cpu"), s_max=16,
                      device="cpu", grid=grid)
    cell = tconfigs.ShapeSpec("decode_small", "decode", 16, 4)
    want = tdry.argument_bytes(tspec, cell, grid, dict(tcm.DEFAULT_RULES), "adamw",
                               compute_cast=True)
    nbytes = [sum(x.numel() * x.element_size() for x in tree_leaves(t)) for t in eng.tiles]
    assert set(nbytes) == {want["param_bytes_per_tile"]}
    cache = tlm.init_cache(tspec, 4, 16, rules=eng.rules)
    cb = {sum(c[k][t].numel() * c[k][t].element_size() for c in cache["layers"] for k in c)
          for t in range(4)}
    assert cb == {want["cache_bytes_per_tile"]}
    ocfg = toptim.OptConfig()
    params, state = tts.init_state(tspec, ocfg, seed=0, grid=grid)
    tw = tdry.argument_bytes(tspec, tconfigs.SHAPES_BY_NAME["train_4k"], grid,
                             dict(tcm.DEFAULT_RULES), "adamw")
    assert {sum(x.numel() * x.element_size() for x in tree_leaves(p)) for p in params} \
        == {tw["param_bytes_per_tile"]}
    assert {sum(x.numel() * x.element_size() for x in tree_leaves(s)) for s in state} \
        == {tw["opt_state_bytes_per_tile"]}


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_grid(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--data", "2", "--model", "2",
                 "--max-new", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "grid 2x2" in out and "moved between grid positions" in out
    ttrain.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
                 "--device", "cpu", "--data", "2", "--model", "2"])
    assert "[train] done" in capsys.readouterr().out
