"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``) against
the JAX package's, on the CPU.

- ``hlo_analysis.analyze``: the mirrors of tests/test_hlo_analysis.py (a
  loop counts what the unrolled program and the analytic count give,
  nested loops multiply, batched dots count right) exactly, and a meta run
  counts exactly what the CPU run counts.
- Per-tile argument bytes of the SMOKE granite-3-2b train cell (b=4, s=32,
  2x2, DEFAULT_RULES, AdamW; tests/test_dryrun_mini.py) equal JAX's
  ``compiled.memory_analysis().argument_size_in_bytes`` exactly (348420 on
  this CPU); the SMOKE granite-moe decode cell's with its cache equal it
  less 4 bytes, the JAX cache's ``pos`` (a 0-dim int32; a host int in the
  port's cache).
- Global ``dot_flops`` of SMOKE train and prefill cells on 1x1 against the
  JAX module's trip-corrected HLO count on a 1x1 mesh.  The forwards agree
  exactly but for MoE: the port's dispatch buffer keeps one spare slot an
  expert (dropped tokens land there), so its expert products are
  (cap + 1) / cap of JAX's -- prefill is JAX's plus exactly that share.  The
  train steps' backwards differ by op order under autograd and XLA's remat:
  equal for dense and encoder-decoder, within 1e-3 for rwkv6 (+3.1e-4),
  1e-2 for zamba2 (-8.1e-3) and, with the spare slot, 1.2e-2 for MoE.
- The depth extrapolation gives a full-depth run's FLOPs exactly and its
  activation peak within 1e-3.
- The grid counter of ``core/distmatrix.py`` gives the same bytes on meta,
  on the CPU and from the analytic count, for every schedule.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import hlo_analysis as jha
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.serving.engine import make_prefill, make_serve_step
from repro.training.optim import OptConfig, make_optimizer
from repro.training.train_step import _named, make_train_step
from repro_torch import configs as tconfigs
from repro_torch.core.chain import chain_product
from repro_torch.core.distmatrix import SCHEDULES, grid_moves, make_context
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch.mesh import LogicalGrid, make_device_grid
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm

ROOT = Path(__file__).resolve().parents[1]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _sds(shapes, shardings):
    return jax.tree.map(lambda x, s: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=s), shapes,
                        shardings)


# ---------------------------------------------------------------------------
# hlo_analysis: the mirrors of tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------


def test_loop_equals_unroll_equals_analytic():
    def f_loop(x, w):
        h = x
        for _ in range(10):
            h = torch.tanh(h @ w)
        return h

    def f_unroll(x, w):
        h = torch.tanh(x @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        h = torch.tanh(h @ w)
        return torch.tanh(h @ w)

    x, w = _meta(256, 256), _meta(256, 256)
    rl, ru = tha.analyze(f_loop, x, w), tha.analyze(f_unroll, x, w)
    assert rl["dot_flops"] == ru["dot_flops"] == 20 * 256**3
    assert rl["n_ops"] == ru["n_ops"] == 20
    assert rl["collective_bytes"] is None and rl["collective_total_bytes"] is None


def test_nested_loops_multiply():
    def f(x, w):
        h = x
        for _ in range(5):
            for _ in range(3):
                h = h @ w
        return h

    r = tha.analyze(f, _meta(128, 128), _meta(128, 128))
    assert r["dot_flops"] == 15 * 2 * 128**3


def test_dot_flops_with_batch_dims():
    r = tha.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b), _meta(4, 64, 32),
                    _meta(4, 32, 16))
    assert r["dot_flops"] == 2 * 4 * 64 * 32 * 16
    assert r["flops_by_op"] == {"bmm": 2 * 4 * 64 * 32 * 16}


def test_checkpoint_recompute_counts_in_the_backward():
    """A checkpointed body runs again in the backward: 1 forward + 1 recompute
    + 2 backward products (dX and dW) of one matmul."""
    from torch.utils.checkpoint import checkpoint

    def f(x, w):
        y = checkpoint(lambda a: torch.tanh(a @ w), x, use_reentrant=False)
        return torch.autograd.grad(y.sum(), [x, w])

    x = torch.empty((64, 32), device="meta", requires_grad=True)
    w = torch.empty((32, 16), device="meta", requires_grad=True)
    assert tha.analyze(f, x, w)["dot_flops"] == 4 * 2 * 64 * 32 * 16


def test_meta_run_counts_what_the_cpu_run_counts():
    """The same program on meta and on the CPU: FLOPs, op count and the live
    bytes' peak equal."""
    def f(x, w, b):
        h = x
        for _ in range(4):
            h = torch.where(h > 0, h @ w + b, 0.5 * h).to(torch.bfloat16).float()
        return torch.softmax(h, -1).sum(0)

    gen = torch.Generator().manual_seed(0)
    cpu = [torch.randn(s, generator=gen) for s in ((48, 32), (32, 32), (32,))]
    rc = tha.analyze(f, *cpu)
    rm = tha.analyze(f, *[t.to("meta") for t in cpu])
    for key in ("dot_flops", "flops_by_op", "n_ops", "peak_live_bytes"):
        assert rc[key] == rm[key], key


def test_smoke_train_step_meta_counts_what_cpu_counts():
    spec = tlm.build_spec(tconfigs.get_smoke("granite-3-2b"))
    from repro_torch.training import optim, train_step
    from repro_torch.tree import tree_map

    out = {}
    for dev in ("cpu", "meta"):
        params = tree_map(lambda t: t.requires_grad_(True),
                          tlm.params_tree(spec, tlm.init_params(spec, seed=0, device=dev)))
        state = optim.adamw_init(params)
        batch = tconfigs.input_specs(spec.cfg, tconfigs.ShapeSpec("m", "train", 32, 2),
                                     device=dev)
        if dev == "cpu":
            batch = {k: torch.zeros_like(v) for k, v in batch.items()}
        step = train_step.make_train_step(spec, optim.OptConfig(), device=dev)
        out[dev] = tha.analyze(step, params, state, batch)
    for key in ("dot_flops", "flops_by_op", "n_ops", "peak_live_bytes"):
        assert out["cpu"][key] == out["meta"][key], key


def test_share_goes_by_identity_not_shape():
    """An activation of a parameter's shape counts whole; the parameter's
    gradient at the parameter's share.  By hand: y = x @ w (8x4 fp32, 128 B,
    whole), its sum and the backward's ones (4 B each), then dW = x^T @ 1
    (128 B at 1/4); y and the sum stay alive to the end."""
    w = torch.empty((8, 4), device="meta", requires_grad=True)
    x = _meta(8, 8)

    def f(x, w):
        y = x @ w
        loss = y.sum()
        (g,) = torch.autograd.grad(loss, [w])
        return y, loss, g

    c = tha.count(f, x, w, shares=[(w, 0.25)])
    by_op = [(c.ops[r.made][0], c.ops[r.made][1], r.nbytes, r.share) for r in c.storages]
    assert (0, "mm", 128, 1.0) in by_op  # the activation of w's shape
    assert (1, "mm", 128, 0.25) in by_op  # the gradient
    r = tha.analyze(f, x, w, shares=[(w, 0.25)])
    assert r["peak_live_bytes"] == 128 + 4 + 4 + 32
    assert tha.analyze(f, x, w)["peak_live_bytes"] == 128 + 4 + 4 + 128


def test_accumulator_written_with_a_share_counts_at_it():
    """A buffer made whole (``torch.zeros``) into which a gradient's share is
    written in place, as ``--accum`` sums microbatch gradients, counts at
    that share from its birth."""
    w = torch.empty((8, 4), device="meta", requires_grad=True)
    x = _meta(8, 8)

    def f(x, w):
        acc = torch.zeros(w.shape, device="meta")
        for _ in range(2):
            (g,) = torch.autograd.grad((x @ w).sum(), [w])
            acc.copy_(acc + g)
        return acc

    c = tha.count(f, x, w, shares=[(w, 0.25)])
    assert [r.share for r in c.storages if c.ops[r.made][1] == "zeros"] == [0.25]


def test_train_cell_on_a_grid_weighs_by_identity():
    """SMOKE granite-3-2b's train step on 2x2 at a tile's 4 x 128 tokens =
    its 512-row vocab: the forward's products of the embedding's shape
    (512, 64) count whole, every parameter's gradient at its tile share
    (the embedding's 1/4), AdamW's temporaries at a share."""
    from repro_torch.training import optim, train_step
    from repro_torch.tree import tree_leaves, tree_map

    spec = tlm.build_spec(tconfigs.get_smoke("granite-3-2b"))
    params = tree_map(lambda t: t.requires_grad_(True),
                      tlm.params_tree(spec, tlm.init_params(spec, device="meta")))
    state = optim.adamw_init(params)
    shares = tdry.tile_shares(spec, params, state, "adamw", GRID22, dict(tcm.DEFAULT_RULES))
    share = {id(t): w for t, w in shares}
    embed = params["embed"]
    assert embed.shape == (512, 64) and share[id(embed)] == 0.25
    batch = tconfigs.input_specs(spec.cfg, tconfigs.ShapeSpec("m", "train", 128, 4))
    step = train_step.make_train_step(spec, optim.OptConfig(), device="meta")
    c = tha.count(step, params, state, batch, shares=shares)
    made = [(c.ops[r.made], r) for r in c.storages]
    embed_bytes = embed.numel() * 4
    fwd_products = [r for (seg, op), r in made if seg == 0 and op in ("mm", "addmm", "bmm")]
    assert any(r.nbytes == embed_bytes for r in fwd_products)
    assert all(r.share == 1.0 for r in fwd_products)
    grads = [r for (seg, _), r in made if seg == 1 and r.share < 1.0]
    leaf_shares = sorted(w for t, w in shares if t.requires_grad and w < 1.0)
    assert len(grads) >= len(leaf_shares) > 0
    assert any(r.nbytes == embed_bytes and r.share == 0.25 for r in grads)
    opt = [r for (seg, _), r in made if seg == 2 and r.nbytes >= embed_bytes]
    assert opt and all(r.share < 1.0 for r in opt)
    assert len(tree_leaves(params)) == sum(1 for t, _ in shares if t.requires_grad)


# ---------------------------------------------------------------------------
# per-tile argument bytes against JAX's memory_analysis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jmesh22():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


GRID22 = LogicalGrid(("data", "model"), (2, 2))


def test_train_cell_argument_bytes_equal_jax_exactly(jmesh22):
    cfg = jconfigs.get_smoke("granite-3-2b")
    spec = jlm.build_spec(cfg)
    step_fn, pspecs, ospecs, _ = make_train_step(spec, jmesh22, OptConfig(),
                                                 rules=dict(jcm.DEFAULT_RULES))
    pshape = jax.eval_shape(lambda k: jlm.init_params(spec, k), jax.random.PRNGKey(0))
    oshape = jax.eval_shape(make_optimizer(OptConfig())[0], pshape)
    b, s = 4, 32
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32,
                                     sharding=NamedSharding(jmesh22, P("data", None)))
             for k in ("tokens", "labels")}
    compiled = step_fn.lower(_sds(pshape, _named(jmesh22, pspecs)),
                             _sds(oshape, _named(jmesh22, ospecs)), batch).compile()
    want = compiled.memory_analysis().argument_size_in_bytes

    tspec = tlm.build_spec(tconfigs.get_smoke("granite-3-2b"))
    got = tdry.argument_bytes(tspec, tconfigs.ShapeSpec("mini", "train", s, b), GRID22,
                              dict(tcm.DEFAULT_RULES), "adamw")
    assert got["argument_bytes_per_tile"] == want == 348420
    assert got["batch_bytes_per_tile"] == 2 * (b // 2) * s * 4
    assert got["opt_state_bytes_per_tile"] == 2 * got["param_bytes_per_tile"] + 4  # m, v, count
    assert got["per_tile_batch"] == 2


def test_decode_cell_argument_bytes_equal_jax_but_pos(jmesh22):
    """The JAX serve step's arguments hold the cache's ``pos``, a 0-dim int32
    (4 bytes); the port's cache keeps it on the host."""
    spec = jlm.build_spec(jconfigs.get_smoke("granite-moe-3b-a800m"))
    step_fn, cache_shapes, cache_sh, pspecs = make_serve_step(spec, jmesh22, batch=4, s_max=64,
                                                              donate_cache=False)
    pshape = jax.eval_shape(lambda k: jlm.init_params(spec, k), jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((4,), jnp.int32, sharding=NamedSharding(jmesh22, P(("data",))))
    compiled = step_fn.lower(_sds(pshape, _named(jmesh22, pspecs)), tok,
                             _sds(cache_shapes, cache_sh)).compile()
    want = compiled.memory_analysis().argument_size_in_bytes

    tspec = tlm.build_spec(tconfigs.get_smoke("granite-moe-3b-a800m"))
    got = tdry.argument_bytes(tspec, tconfigs.ShapeSpec("mini", "decode", 64, 4), GRID22,
                              dict(tcm.DEFAULT_RULES), "adamw")
    pos_bytes = 4
    assert got["argument_bytes_per_tile"] + pos_bytes == want
    assert got["batch_bytes_per_tile"] == 2 * 4  # the token, split over data
    assert got["cache_bytes_per_tile"] > 0 and got["opt_state_bytes_per_tile"] == 0


# ---------------------------------------------------------------------------
# global dot_flops against the JAX module's HLO count (1x1)
# ---------------------------------------------------------------------------

B, S = 2, 64
# (arch, train tolerance) -- the module docstring says where each comes from
FLOP_CELLS = [("granite-3-2b", 0.0), ("seamless-m4t-medium", 0.0), ("rwkv6-3b", 1e-3),
              ("zamba2-7b", 1e-2), ("granite-moe-3b-a800m", 1.2e-2)]


def _spare_slot_flops(cfg) -> float:
    """The forward's expert products on the port's spare dispatch slot: one
    row an expert in each of the three (gate, up, down), every layer MoE."""
    return 3 * 2 * cfg.n_experts * cfg.d_model * (cfg.d_expert or cfg.d_ff) * cfg.n_layers


@pytest.fixture(scope="module")
def jmesh11():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("arch,train_tol", FLOP_CELLS)
def test_global_dot_flops_against_jax_hlo(jmesh11, arch, train_tol):
    jcfg = jconfigs.get_smoke(arch)
    spec = jlm.build_spec(jcfg)
    oc = OptConfig(name=jcfg.optimizer)
    pshape = jax.eval_shape(lambda k: jlm.init_params(spec, k), jax.random.PRNGKey(0))
    step_fn, pspecs, ospecs, _ = make_train_step(spec, jmesh11, oc, rules=dict(jcm.DEFAULT_RULES))
    oshape = jax.eval_shape(make_optimizer(oc)[0], pshape)
    ins = jconfigs.input_specs(jcfg, jconfigs.ShapeSpec("m", "train", S, B))
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=NamedSharding(jmesh11, P()))
             for k, v in ins.items()}
    j_train = jha.analyze(step_fn.lower(_sds(pshape, _named(jmesh11, pspecs)),
                                        _sds(oshape, _named(jmesh11, ospecs)),
                                        batch).compile().as_text())["dot_flops"]
    pf, pspecs = make_prefill(spec, jmesh11, s_max=S)
    ins = jconfigs.input_specs(jcfg, jconfigs.ShapeSpec("m", "prefill", S, B))
    j_prefill = jha.analyze(pf.lower(
        _sds(pshape, _named(jmesh11, pspecs)),
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in ins.items()}).compile().as_text()
    )["dot_flops"]

    tcfg = tconfigs.get_smoke(arch)
    tspec = tlm.build_spec(tcfg)
    grid = LogicalGrid(("data", "model"), (1, 1))
    t_train = tdry.extrapolated_step(tspec, tconfigs.ShapeSpec("m", "train", S, B), B,
                                     opt_name=tcfg.optimizer, grid=grid,
                                     rules=dict(tcm.DEFAULT_RULES))["dot_flops"]
    t_prefill = tdry.extrapolated_step(tspec, tconfigs.ShapeSpec("m", "prefill", S, B),
                                       B)["dot_flops"]
    spare = _spare_slot_flops(tcfg) if tcfg.family == "moe" else 0.0
    assert t_prefill - spare == j_prefill
    assert t_train == pytest.approx(j_train, rel=train_tol, abs=0)


# ---------------------------------------------------------------------------
# the depth extrapolation
# ---------------------------------------------------------------------------

DEEP = [("granite-3-2b", {"n_layers": 6}), ("zamba2-7b", {"n_layers": 14}),
        ("seamless-m4t-medium", {"enc_layers": 5, "dec_layers": 4}),
        ("llama4-maverick-400b-a17b", {"n_layers": 8}), ("rwkv6-3b", {"n_layers": 5})]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,deep", DEEP, ids=[a for a, _ in DEEP])
def test_extrapolation_equals_full_depth(arch, deep, kind):
    cfg = tconfigs.get_smoke(arch).replace(**deep)
    spec = tlm.build_spec(cfg)
    shape = tconfigs.ShapeSpec("m", kind, 64, 2)
    full = tdry.run_step(spec, shape, 2, opt_name=cfg.optimizer)
    ex = tdry.extrapolated_step(spec, shape, 2, opt_name=cfg.optimizer)
    assert ex["flops_by_op"] == full["flops_by_op"]
    assert ex["dot_flops"] == full["dot_flops"]
    assert ex["peak_live_bytes"] == pytest.approx(full["peak_live_bytes"], rel=1e-3)
    assert max(max(c) for c in ex["depths_run"]) <= 2


# ---------------------------------------------------------------------------
# the grid counter and the chain cell
# ---------------------------------------------------------------------------


def _chain_moves(dev: str, schedule: str, n: int, d: int) -> dict:
    ctx = make_context([dev] * 4, 2)
    if dev == "meta":
        a = torch.empty((n, n), device="meta")
    else:
        x = np.random.default_rng(0).random((n, n)).astype(np.float32)
        a = torch.from_numpy((x + x.T) / 2)
        a.fill_diagonal_(0.0)
    before = grid_moves()[schedule]
    op = chain_product(ctx.put_matrix(a) if dev != "meta" else a, d, schedule=schedule,
                       fuse_l=True, ctx=ctx)
    after = grid_moves()[schedule]
    assert (op.rho is None) == (dev == "meta")
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_chain_counter_meta_equals_cpu_equals_analytic(schedule):
    n, d = 64, 3
    meta, cpu = _chain_moves("meta", schedule, n, d), _chain_moves("cpu", schedule, n, d)
    want = {k: float(v) for k, v in tdry.chain_moves(n, 2, 2, d, schedule).items()}
    assert meta == cpu == want
    kind = "permute" if schedule == "cannon" else "gather"
    assert want[f"{kind}_bytes"] > 0
    # one GEMM's count by hand: summa, each of 4 tiles gathers 1 A tile and 1 B tile
    tile = (n // 2) ** 2 * 4
    per_gemm = 4 * 2 * tile if kind == "gather" else (2 + 2 + 2 * 1 * 4) * tile
    assert want[f"{kind}_bytes"] == tdry.chain_gemms(d) * per_gemm


def test_dry_chain_on_a_small_grid():
    rec = tdry.dry_chain(n=64, d_len=3, rows=2, cols=2, log=lambda _: None)
    for sched in SCHEDULES:
        r = rec["schedules"][sched]
        assert r["dot_flops"] >= r["gemm_flops_analytic"] == tdry.chain_gemms(3) * 2.0 * 64**3
        assert r["collective_total_bytes"] == sum(
            tdry.chain_moves(64, 2, 2, 3, sched)[k] for k in ("gather_bytes", "permute_bytes"))
        assert r["peak_live_bytes"] > 0
    assert rec["schedules"]["xla"]["collective_bytes"] == rec["schedules"]["summa"][
        "collective_bytes"]


# ---------------------------------------------------------------------------
# meta across the port: the device, the grid, the wrappers
# ---------------------------------------------------------------------------


def test_meta_device_resolves_and_grids():
    assert resolve_device("meta").type == "meta"
    ctx = make_device_grid(2, 2, "meta")
    assert all(d.type == "meta" for row in ctx.devices for d in row)
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_kernel_wrappers_take_the_plain_version_on_meta():
    """Every wrapper's meta result has its CPU result's shape and dtype; no
    launch is counted."""
    from repro_torch import kernels
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import cad_score as cs
    from repro_torch.kernels import edge_projection as ep
    from repro_torch.kernels import emb_query as eq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stream_gemm as sg
    from repro_torch.kernels import wkv

    gen = torch.Generator().manual_seed(0)

    def both(fn, *shapes_dtypes):
        cpu = [torch.rand(s, generator=gen).to(dt) for s, dt in shapes_dtypes]
        rc, rm = fn(*cpu), fn(*[t.to("meta") for t in cpu])
        flat_c = rc if isinstance(rc, tuple) else (rc,)
        flat_m = rm if isinstance(rm, tuple) else (rm,)
        for c, m in zip(flat_c, flat_m, strict=True):
            assert m.device.type == "meta" and (m.shape, m.dtype) == (c.shape, c.dtype)

    f32 = torch.float32
    kernels.reset_launch_counts()
    both(bm.block_matmul, ((8, 4), f32), ((4, 6), f32))
    both(bm.split_tf32, ((8, 4), f32))
    both(lambda a: ep.edge_projection(a, seed=0, k=3), ((16, 16), f32))
    both(lambda *t: cs.cad_scores_tile(*t, 2.0, 3.0), ((8, 8), f32), ((8, 8), f32),
         ((8, 3), f32), ((8, 3), f32), ((8, 3), f32), ((8, 3), f32))
    both(lambda a, b, c: sg.stream_gemm(a, b, c, sign=-1.0), ((8, 4), f32), ((4, 6), f32),
         ((8, 6), f32))
    both(sg.fused_panel_matvec, ((4, 8), f32), ((8, 2), f32), ((4, 2), f32), ((4, 2), f32))
    both(lambda q, k, v: fa.flash_attention(q, k, v, groups=2), ((4, 16, 8), f32),
         ((2, 16, 8), f32), ((2, 16, 8), f32))
    both(lambda r, k, v, lw, u: wkv.wkv(r, k, v, -lw, u, return_state=True), ((2, 8, 4), f32),
         ((2, 8, 4), f32), ((2, 8, 4), f32), ((2, 8, 4), f32), ((2, 4), f32))
    for dev in ("cpu", "meta"):
        zq = torch.rand((2, 3), generator=gen).to(dev)
        topk = eq.PanelTopk(zq, torch.ones((2, 1), device=dev), torch.ones((1, 8), device=dev),
                            torch.full((2, 1), -1, dtype=torch.int32, device=dev), 1.0,
                            panel_rows=8, topk=3)
        topk.update(torch.rand((8, 3), generator=gen).to(dev), 0)
        vals, ids = topk.result()
        assert (vals.shape, ids.shape, vals.device.type) == ((2, 3), (2, 3), dev)
    assert all(v == 0 for v in kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_single_cell_writes_its_json(tmp_path):
    records = tdry.main(["--arch", "granite-3-2b", "--shape", "train_4k", "--mesh", "single",
                         "--out", str(tmp_path)])
    path = tmp_path / "granite-3-2b__train_4k__single.json"
    rec = json.loads(path.read_text())
    assert [r["status"] for r in records] == ["ok"] and rec["status"] == "ok"
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["per_tile_batch"] == 16 and rec["n_params"] > 2_000_000_000
    assert rec["argument_bytes_per_tile"] == sum(rec[k] for k in (
        "param_bytes_per_tile", "opt_state_bytes_per_tile", "batch_bytes_per_tile",
        "cache_bytes_per_tile"))
    assert rec["dot_flops"] > 6 * rec["n_params"] * 256 * 4096  # forward + backward + recompute
    ana = rec["analysis"]
    assert set(ana["collective_bytes"]) == set(ana["collective_counts"]) == set(
        tha.COLLECTIVES)
    assert sum(ana["collective_bytes"].values()) == ana["collective_total_bytes"] > 0
    for op in ("all-gather", "all-reduce", "reduce-scatter"):  # FSDP gathers, TP sums, grads
        assert ana["collective_bytes"][op] > 0 and ana["collective_counts"][op] > 0
    assert ana["collective_bytes"]["all-to-all"] == 0
    assert ana["collective_bytes"]["collective-permute"] == 0
    assert rec["moved_bytes_per_tile"] == ana["collective_total_bytes"] / 256
    assert isinstance(rec["fits_80gb"], bool)


@pytest.mark.slow
def test_cli_all_cells_both_grids_and_the_chain(tmp_path):
    """The whole dry run: 32 cells on both production grids, each LM cell's
    collectives counted on 256 or 512 meta tiles, and the 16x16 chain cell,
    every one ``ok``.  The run is about 8200 process-seconds of work
    (1018.2 s in 8 processes on an 8-core Xeon); its time limit is three
    times that over the processes it runs in, one a core, and 1200 s at
    least."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both", "--chain",
         "--out", str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
        text=True, timeout=max(1200.0, 3 * 8200 / tdry.worker_count()))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(files) == 65
    for p in tmp_path.glob("*.json"):
        assert json.loads(p.read_text())["status"] == "ok", p.name
