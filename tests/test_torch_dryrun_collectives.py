"""The dry run's collective bytes for the LM cells: the port's grid step on
meta tiles (``repro_torch.launch.dryrun.grid_step_moves`` /
``extrapolated_moves`` / ``cell_moves``) against the same step executed on
CPU tiles, against a full-depth run, against a count by hand, and against
the JAX package's HLO count.

Models: ``tests/test_sharding.py``'s TINY (dense, 2 layers, d_model 64, 4 q
heads over 2 KV heads, fp32) and the SMOKE config of every family.  Inputs
and weights are drawn from seeds (numpy for the batch, ``lm.init_params``'s
generator for the weights).  Tolerances are stated per test.
"""

import dataclasses
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.launch import hlo_analysis as jha
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models.common import ArchConfig as JArch
from repro.serving.engine import make_prefill, make_serve_step
from repro.training.optim import OptConfig as JOptConfig
from repro.training.optim import make_optimizer as j_make_optimizer
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch.mesh import LogicalGrid, make_cpu_mesh
from repro_torch.models import lm as tlm
from repro_torch.models.common import ArchConfig

_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=256, remat=False, compute_dtype="float32")
TSPEC = tlm.build_spec(ArchConfig(**_TINY))
JSPEC = jlm.build_spec(JArch(**_TINY))

# one SMOKE config a family (both MoE branches: granite-moe shards the FFN
# dim, llama4 runs expert parallelism with Adafactor)
FAMILIES = {
    "dense": "granite-3-2b",
    "moe": "granite-moe-3b-a800m",
    "moe-ep": "llama4-maverick-400b-a17b",
    "rwkv6": "rwkv6-3b",
    "zamba2": "zamba2-7b",
    "encdec": "seamless-m4t-medium",
    "chameleon": "chameleon-34b",
}
GRIDS = {"2x2": dict(data=2, model=2), "2x2x2": dict(pod=2, data=2, model=2)}
KINDS = ("train", "prefill", "decode")
B, S = 8, 32


def _spec(name: str):
    return TSPEC if name == "tiny" else tlm.build_spec(configs.get_smoke(FAMILIES[name]))


def _shape(kind: str, long: bool = False):
    if long:  # long_500k's rules: kv_seq over every axis, batch 1
        return configs.ShapeSpec("long_t", "decode", S, 1)
    return configs.ShapeSpec(f"{kind}_t", kind, S, B)


def _step_rules(spec, shape, grid):
    return tdry.step_rules(spec, shape, grid, tdry.rules_for(grid, shape))


def _moves(spec, shape, grid_kw, device):
    grid = make_cpu_mesh(**grid_kw, device=device)
    return tdry.grid_step_moves(spec, shape, grid, _step_rules(spec, shape, grid),
                                opt_name=spec.cfg.optimizer, seed=3)


def _nonzero(moves):
    return any(v for m in moves.values() for v in m.values())


_CASES = ([(f, k, g, False) for f in ["tiny", *FAMILIES] for k in KINDS for g in GRIDS]
          + [(f, "decode", g, True) for f in ("rwkv6", "zamba2") for g in GRIDS])


@pytest.mark.parametrize("family,kind,grid,long", _CASES,
                         ids=[f"{f}-{'long' if lg else k}-{g}" for f, k, g, lg in _CASES])
def test_meta_count_equals_executed(family, kind, grid, long):
    """(a) The dry run's count on meta tiles equals ``lm_moves()`` read around
    the same step executed on CPU tiles (the same spec, batch, length, grid
    and rules; weights and tokens from seeds), kind by kind and path by path:
    exactly.  The decode step runs at the cache's last slot."""
    spec, shape = _spec(family), _shape(kind, long)
    meta = _moves(spec, shape, GRIDS[grid], "meta")
    cpu = _moves(spec, shape, GRIDS[grid], "cpu")
    assert meta == cpu
    assert _nonzero(meta)


def _deep(spec, depth: int = 3):
    return tdry._with_counts(spec, [depth] * len(tdry._counts(spec)))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_extrapolation_equals_full_depth(family, kind):
    """(b) At 3 layers in every group (zamba2: 3 Mamba2-and-shared-attention
    groups and 3 trailing Mamba2 layers; seamless: 3 encoder and 3 decoder
    layers), the count extrapolated from depths 1 and 2 equals a full-depth
    run on the 2x2x2 meta grid: exactly, every path and kind."""
    spec, shape = _deep(_spec(family)), _shape(kind)
    grid = make_cpu_mesh(pod=2, data=2, model=2, device="meta")
    rules = _step_rules(spec, shape, grid)
    kw = dict(opt_name=spec.cfg.optimizer)
    got, runs = tdry.extrapolated_moves(spec, shape, grid, rules, **kw)
    want = tdry.grid_step_moves(spec, shape, grid, rules, **kw)
    assert got == want
    assert max(max(r) for r in runs) == 2 and _nonzero(want)


def _record(kind):
    moves, _ = tdry.cell_moves(TSPEC, configs.ShapeSpec(f"{kind}_t", kind, 8, 4),
                               LogicalGrid(("data", "model"), (2, 2)))
    return tha.collectives_of(moves)


def test_hand_count_train():
    """(c) TINY's AdamW train step on 4 x 8 tokens on 2x2 under DEFAULT_RULES:
    weights FSDP-sharded over data on d_model, heads / d_ff / vocab over
    model, 2 batch rows a data shard.

    Gathers (forward, over data, one partner): the embedding and the head,
    (128, 32) fp32 tiles of 16384 B, 4 x 16384 each; per layer wq, wk, wv,
    wo (32 x 32, 4096 B) 4 x 4096 each and w_gate, w_up, w_down (8192 B)
    4 x 8192 each: 2 x 65536 + 2 x (4 x 16384 + 3 x 32768) = 458752 B in
    16.  Their backward reduce-scatters move the same 458752 B in 16.

    All-reduces, 24 (x = (2, 8, 64) fp32 rows, 4096 B a tile): forward, over
    model, the embedding's rows and each layer's attention and MLP output,
    5 x 4 x 4096; the cross-entropy's max, exp-sum and label logit over the
    vocab shards, 3 x 4 x 64 B; the mean loss over data, 4 x 4 B.  Backward
    (``pvary``): each of the 4 blocks' and the head's input over model,
    5 x 4 x 4096; wk and wv (whole over model: 2 KV heads), 4 x 4 x 4096;
    the 5 norm scales over data, 5 x 4 x 256.  The clip's norm over all 4
    tiles, 4 x 3 x 4 B.  Sum: 81920 + 768 + 16 + 81920 + 65536 + 5120 + 48 =
    235328 B.  Exact."""
    nbytes, counts = _record("train")
    assert nbytes["all-gather"] == 458752 and counts["all-gather"] == 16
    assert nbytes["reduce-scatter"] == 458752 and counts["reduce-scatter"] == 16
    assert nbytes["all-reduce"] == 235328 and counts["all-reduce"] == 24
    assert nbytes["all-to-all"] == nbytes["collective-permute"] == 0


def test_hand_count_prefill():
    """(c) TINY's prefill of 4 x 8 tokens on 2x2 under the dry run's prefill
    rules (weights FSDP-sharded over data, as the JAX ``make_prefill``).

    Gathers over data: the embedding and head tiles, 4 x 16384 B each; per
    layer 4 x 4096 B for each of wq, wk, wv, wo and 4 x 8192 B for each of
    w_gate, w_up, w_down (327680 B for both layers); the last position's
    (2, 128) fp32 logits over model, 4 x 1024 B: 462848 B in 17.
    All-reduces over model of the (2, 8, 64) fp32 rows (4096 B): the
    embedding and each layer's attention and MLP, 5 x 4 x 4096 = 81920 B
    (``tests/test_torch_grid_lm.py``'s count).  Exact."""
    nbytes, counts = _record("prefill")
    assert nbytes["all-gather"] == 462848 and counts["all-gather"] == 17
    assert nbytes["all-reduce"] == 81920 and counts["all-reduce"] == 5
    assert nbytes["reduce-scatter"] == nbytes["all-to-all"] == nbytes["collective-permute"] == 0


def test_hand_count_decode():
    """(c) TINY's decode step, 4 tokens against a cache of 8 on 2x2 under the
    decode rules (weights whole over data, the KV sequence over model for
    flash-decode, 2 rows a data shard).

    All-reduces over model: the embedding's (2, 1, 64) fp32 rows, 4 x 512 B;
    per layer the attention and MLP outputs, 2 x 4 x 512 B, and the
    flash-decode merge of (m, l, o) = (2, 1, 4) + (2, 1, 4) + (2, 1, 4, 16)
    fp32, 4 x 576 B: 2048 + 2 x 6400 = 14848 B in 7.  Gathers over model: per
    layer each tile's two query heads (2, 1, 2, 16), 4 x 256 B; the
    logits' (2, 128) vocab halves, 4 x 1024 B: 6144 B in 3.  Exact."""
    nbytes, counts = _record("decode")
    assert nbytes["all-reduce"] == 14848 and counts["all-reduce"] == 7
    assert nbytes["all-gather"] == 6144 and counts["all-gather"] == 3
    assert nbytes["reduce-scatter"] == nbytes["all-to-all"] == nbytes["collective-permute"] == 0


def test_extrapolated_record_is_linear_in_depth():
    """A cell's count is affine in its depth: TINY at 2, 3 and 4 layers
    (``cell_moves`` runs depths 1 and 2 and extrapolates) gives equal steps."""
    g = LogicalGrid(("pod", "data", "model"), (2, 2, 2))
    totals = []
    for n in (2, 3, 4):
        spec = dataclasses.replace(TSPEC, groups=(dataclasses.replace(TSPEC.groups[0], count=n),))
        moves, _ = tdry.cell_moves(spec, _shape("train"), g)
        totals.append(sum(tha.collectives_of(moves)[0].values()))
    assert totals[2] - totals[1] == totals[1] - totals[0] > 0
    assert np.isfinite(totals).all()


# ---------------------------------------------------------------------------
# against the JAX package's HLO count
# ---------------------------------------------------------------------------


def _jax_hlo(kind: str, mesh, b: int = 4, s: int = 8) -> str:
    """``lower_cell``'s way for TINY on ``mesh``: the kind's JAX step lowered
    against sharded ``ShapeDtypeStruct``s under DEFAULT_RULES and compiled;
    its HLO text."""
    rules = dict(jcm.DEFAULT_RULES)
    pshape = jax.eval_shape(partial(jlm.init_params, JSPEC), jax.random.PRNGKey(0))

    def sds(shapes, specs):
        return jax.tree.map(lambda x, sp: jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=NamedSharding(mesh, sp)), shapes, specs,
            is_leaf=lambda x: isinstance(x, P))

    def ids(shape, spec):
        return jax.ShapeDtypeStruct(shape, jnp.int32, sharding=NamedSharding(mesh, spec))

    if kind == "train":
        oc = JOptConfig()
        step, pspecs, ospecs, _ = j_make_train_step(JSPEC, mesh, oc, rules=rules)
        oshape = jax.eval_shape(j_make_optimizer(oc)[0], pshape)
        batch = {k: ids((b, s), P("data", None)) for k in ("tokens", "labels")}
        lowered = step.lower(sds(pshape, pspecs), sds(oshape, ospecs), batch)
    elif kind == "prefill":
        pf, pspecs = make_prefill(JSPEC, mesh, s_max=s, rules=rules)
        lowered = pf.lower(sds(pshape, pspecs), {"tokens": ids((b, s), P("data", None))})
    else:
        step, cshapes, cshard, pspecs = make_serve_step(JSPEC, mesh, batch=b, s_max=s,
                                                        rules=rules, donate_cache=False)
        cache = jax.tree.map(lambda x, sh: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sh),
                             cshapes, cshard)
        lowered = step.lower(sds(pshape, pspecs), ids((b,), P(("data",))), cache)
    return lowered.compile().as_text()


def _jax_collectives(kind: str, mesh) -> dict:
    """``repro.launch.hlo_analysis.analyze`` of :func:`_jax_hlo`."""
    return jha.analyze(_jax_hlo(kind, mesh))


# the 2x2 mesh's replica groups in the HLO's iota form -> the axis reduced over
_GROUP_AXIS = {"[2,2]<=[4]": "model", "[2,2]<=[2,2]T(1,0)": "data"}


def _jax_ops(text: str) -> list[tuple[str, float, str, str]]:
    """(op type, bytes, axis, op_name) of every collective of an HLO text,
    its bytes in the JAX record's convention times its computation's trip
    count, as ``analyze`` weighs them; axis is ``data``, ``model`` or ``""``
    (a permute)."""
    comps = jha.parse_hlo(text)
    mult = jha.multipliers(comps)
    out, comp = [], None
    for ln in text.splitlines():
        head = jha._COMP_HEADER.match(ln.strip()) if ln.rstrip().endswith("{") else None
        if head:
            comp = head.group(2)
            continue
        parsed = jha._parse_op_line(ln)
        if parsed is None or parsed[2].endswith("-done"):
            continue
        op = parsed[2].replace("-start", "")
        if op in jha.COLLECTIVES:
            groups = re.search(r"replica_groups=(\S+?),? ", ln)
            name = re.search(r'op_name="([^"]*)"', ln)
            out.append((op, jha._shape_bytes(parsed[1]) * jha.RING_MULTIPLIER[op] * mult[comp],
                        _GROUP_AXIS[groups.group(1)] if groups else "",
                        name.group(1) if name else ""))
    return out


def _port_in_jax_convention(kind: str) -> dict:
    """The port's record for the same cell, per tile, converted to the JAX
    convention for groups of n = 2 (``dryrun``'s table): all-reduce
    x 2 / (n - 1) = 2, all-gather x n / (n - 1) = 2, reduce-scatter
    x 1 / (n - 1) = 1."""
    nbytes, _ = _record(kind)
    factor = {"all-reduce": 2.0, "all-gather": 2.0, "reduce-scatter": 1.0}
    return {k: v / 4 * factor.get(k, 1.0) for k, v in nbytes.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_against_jax_hlo_count(kind, mesh22, record_property):
    """(d) TINY, 4 x 8 tokens (decode: 4 tokens against a cache of 8), on the
    2x2 mesh of CPU devices: the JAX package's HLO count against the port's
    record converted to the JAX convention (n = 2), op type by op type.

    - decode: all-reduce equal, exactly (the flash-decode merge's max, sum
      and output, which the port counts as one); all-gather equal, exactly,
      once the port's gather of the logits' vocab halves (R = (2, 256) fp32
      = 2048 B a device) is taken out: the JAX step leaves its logits
      sharded (``out_shardings=None``), the port's returns them whole.
    - prefill: all-gather and all-reduce within 5% relative (GSPMD gathers
      the activations and the ids in other pieces than the port's explicit
      collectives).
    - train: see :func:`test_train_against_jax_hlo_count_by_structure`.
    - all-to-all and collective-permute: GSPMD's resharding only; the port
      issues none.  Their JAX bytes are recorded as test properties."""
    j = _jax_collectives(kind, mesh22)["collective_bytes"]
    t = _port_in_jax_convention(kind)
    for op in ("all-to-all", "collective-permute"):
        record_property(f"jax_{op}_bytes", j[op])
        assert t[op] == 0
    if kind == "decode":
        assert t["all-reduce"] == j["all-reduce"] > 0
        assert t["all-gather"] - 2 * 256 * 4 == j["all-gather"] > 0
    elif kind == "prefill":
        assert j["all-to-all"] + j["collective-permute"] > 0
        for op in ("all-gather", "all-reduce"):
            assert t[op] == pytest.approx(j[op], rel=0.05)
    else:
        assert j["all-to-all"] + j["collective-permute"] > 0
        record_property("jax_over_port_all_gather", j["all-gather"] / t["all-gather"])
        record_property("jax_over_port_reductions", (j["all-reduce"] + j["reduce-scatter"])
                        / (t["all-reduce"] + t["reduce-scatter"]))


def test_train_against_jax_hlo_count_by_structure(mesh22, record_property):
    """(d) TINY's train step, 4 x 8 tokens, on the 2x2 mesh: the JAX
    package's HLO count (1.786 x the port's all-gather bytes and 2.129 x its
    reductions, recorded as test properties) follows from the port's record
    (in the JAX convention, n = 2: all-gather P_ag, all-reduce P_ar,
    reduce-scatter P_rs) by what each side does differently.  Sizes, fp32:

    - M = the embedding table's vocab shard, 128 x 64 x 4 = 32768 B: the
      port gathers it over data (FSDP) and reduce-scatters its gradient;
      GSPMD looks the rows up with an all-to-all and an all-reduce instead
      and sums the gradient with a scatter-add;
    - K = the KV heads a model shard's query heads do not use, 2 layers x
      (wk, wv) x 64 x 16 x 4 = 16384 B: the port gathers wk and wv whole
      (``kv_heads`` is unsharded) and reduce-scatters their gradients whole;
      GSPMD slices its shard's KV head off before it gathers;
    - A = one (2, 8, 64) activation all-reduced, 2 x 4096 = 8192 B: GSPMD
      reduces the gradient of the MLP's input from gate and up apart (in
      every layer), the port sums the two on the tile and reduces once.

    Asserted:

    - GSPMD gathers every FSDP weight again for the backward: its weight
      gathers (those feeding a ``dot_general``) in the backward equal those
      in the forward, exactly;
    - those in the forward equal P_ag - M - K, exactly; the JAX gathers
      that feed no product (resharding) are recorded;
    - the reductions: JAX all-reduce (it reduce-scatters nothing) equals
      P_ar + 4 P_rs - 2 (M + K) + 2 A (it all-reduces each weight gradient,
      2 R = 4 S, where the port reduce-scatters it) within 256 B: the loss's,
      the softmax statistics' and the clip norm's scalars and the final
      norm's gradient, which each side reduces in its own pieces (measured
      120 B of 494616)."""
    text = _jax_hlo("train", mesh22)
    ops = _jax_ops(text)
    j = jha.analyze(text)["collective_bytes"]
    for op in jha.COLLECTIVES:  # the per-op reading sums as ``analyze`` does
        assert sum(b for o, b, _, _ in ops if o == op) == j[op]
    t = _port_in_jax_convention("train")
    cfg = TSPEC.cfg
    m_tab = cfg.vocab // 2 * cfg.d_model * 4
    k_kv = cfg.n_layers * 2 * cfg.d_model * cfg.hd * (cfg.n_kv_heads - cfg.n_kv_heads // 2) * 4
    act = 2 * (4 // 2) * 8 * cfg.d_model * 4
    assert (m_tab, k_kv, act) == (32768, 16384, 8192)
    weight = [(b, "transpose(" in name) for o, b, _, name in ops
              if o == "all-gather" and name.endswith("dot_general")]
    fwd = sum(b for b, back in weight if not back)
    bwd = sum(b for b, back in weight if back)
    assert fwd == bwd > 0
    assert fwd == t["all-gather"] - m_tab - k_kv
    record_property("jax_resharding_gather_bytes", j["all-gather"] - fwd - bwd)
    assert j["reduce-scatter"] == 0
    want = t["all-reduce"] + 4 * t["reduce-scatter"] - 2 * (m_tab + k_kv) + cfg.n_layers * act
    record_property("jax_all_reduce_minus_structure", j["all-reduce"] - want)
    assert abs(j["all-reduce"] - want) <= 256
    record_property("jax_over_port_all_gather", j["all-gather"] / t["all-gather"])
    record_property("jax_over_port_reductions", j["all-reduce"] / (t["all-reduce"]
                                                                  + t["reduce-scatter"]))


def test_run_cells_in_processes_equals_one_process(tmp_path):
    """``run_cells`` (each (arch, shape)'s records and each depth run of a
    count a task, in spawned processes when there are cores for them) gives
    the record ``dry_cell`` gives in this process: granite-3-2b's decode_32k
    on the 16x16 grid counted, qwen2-1.5b's not; collective fields equal
    exactly, every other field but the seconds too."""
    cells = [("granite-3-2b", configs.DECODE_32K), ("qwen2-1.5b", configs.DECODE_32K)]
    want = {("granite-3-2b", "decode_32k", "single")}
    got = tdry.run_cells(cells, ["single"], str(tmp_path), collectives=want, log=lambda _: None)
    one = tdry.dry_cell("granite-3-2b", configs.DECODE_32K,
                        LogicalGrid(("data", "model"), (16, 16)))
    untimed = ("seconds", "collective_seconds", "status")
    assert {k: v for k, v in got[0].items() if k not in untimed} == {
        k: v for k, v in one.items() if k not in untimed}
    assert got[0]["analysis"]["collective_total_bytes"] > 0
    assert got[1]["status"] == "ok" and got[1]["analysis"]["collective_bytes"] is None


def test_meta_memo_answers_as_the_op_does():
    """``MetaMemo`` answers a repeated op with a tensor of the shape, strides
    and dtype the op gives (exactly), never memoizes a view (a repeated
    transpose still aliases its input), and passes tensors off meta through."""
    import torch

    def f(x, w):
        y = x @ w
        z = torch.cat([y, y.transpose(0, 1)[: y.shape[0]]], dim=1)
        z.add_(1.0)
        return [y, z, z.sum(-1), y.to(torch.bfloat16), y.t()]

    x = torch.empty((6, 6), device="meta")
    w = torch.empty((6, 6), device="meta")
    want = f(x, w)
    memo = tha.MetaMemo()
    with memo:
        f(x, w)
        got = f(x, w)
        cpu = torch.ones(2, 2) + 1
    for a, b in zip(got, want, strict=True):
        assert (a.shape, a.stride(), a.dtype, a.device.type) == (
            b.shape, b.stride(), b.dtype, b.device.type)
    assert got[4].untyped_storage()._cdata == got[0].untyped_storage()._cdata
    assert memo._memo and float(cpu[0, 0]) == 2.0
