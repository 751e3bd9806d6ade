"""Dry run: every (arch x shape x grid) cell, and the CADDeLaG chain, on the meta device.

Port of :mod:`repro.launch.dryrun`.  The JAX package lowers and compiles
each cell for the 16x16 single-pod mesh and the 2x16x16 multi-pod mesh
against ``ShapeDtypeStruct`` inputs and reads XLA's memory and cost
analyses.  The port builds each cell on PyTorch's shape-only ``meta``
device, where nothing is allocated, and records:

- per-tile bytes of the parameters, the optimizer state (train), the batch
  inputs and the KV cache (decode), and their sum
  ``argument_bytes_per_tile``: exact arithmetic on the sanitized sharded
  shapes (the sharding rules of :mod:`repro_torch.models.common` on a
  :class:`~repro_torch.launch.mesh.LogicalGrid`), the quantity the JAX
  package reads as ``memory_analysis().argument_size_in_bytes``;
- ``activation_bytes_estimate``: the peak of live meta bytes while the
  port's own step (``training.train_step``, ``lm.prefill`` or
  ``lm.decode_step``) runs at the per-tile batch (global batch / the batch
  axes' product), the train step's gradients and optimizer temporaries
  at a tile's share of their parameter, known by what each tensor is and
  not by its shape (:mod:`~repro_torch.launch.hlo_analysis`) -- an
  estimate: it sees no tensor-parallel split of activations and no
  allocator;
- ``dot_flops`` of the global step (:func:`repro_torch.launch.hlo_analysis.analyze`);
- whether arguments plus activations fit one H100's 80 GB, and the seconds.

Depth.  Eager meta execution costs ~0.1-0.3 ms of host time an op, and a
full-depth step is 10^4-10^5 ops, so a cell runs its step at depth 1 and at
depth 2 of each layer group (every other group at 1) and extrapolates
to the config's counts.  FLOPs are exactly linear in each group's count
(every layer of a group runs the same ops).  The peak is not: at depth 1-4
granite-3-2b's train step peaks in the logits' backward, at 40 layers in
the optimizer over the stacked gradients.  So the peak is extrapolated
event by event (``_extrapolated_peak``): the live bytes after each op of
the shallow runs, matched between depths, each along its own line.  That
gives the full-depth run's peak wherever every layer of a group adds the
same bytes; it is part of the estimate.  ``depths_run`` lists the counts run.

Host reads.  The train step reads nothing back (``float(loss)`` is the
launcher's, not the step's).  The chain's ``estimate_rho`` runs its power
iterations on meta and returns None instead of reading the norm back.

Collectives.  An LM cell's collective bytes come from the port's own grid
step (:func:`grid_step_moves`): the train step (``make_train_step(grid=)``),
``lm.prefill`` or ``lm.decode_step`` against a full cache, at the global
batch, on a :class:`~repro_torch.launch.mesh.DeviceGrid` of meta tiles
shaped as the cell's logical grid (:func:`meta_grid`: 16x16, or 2x16x16
pod x data x model), under the cell's rules (:func:`step_rules`: decode
under the serve engine's rules, prefill with FSDP kept).  The moves are
read from :func:`repro_torch.core.collectives.lm_moves` around the step,
every path summed (``lm.train``, ``lm.serve``, ``lm.pod``), at depths 1
and 2 of each layer group and extrapolated
linearly (:func:`extrapolated_moves`; exact: every layer of a group issues
the same collectives).  They land in ``analysis`` as the chain cell's:
``collective_bytes`` by JAX op type (``gather`` as ``all-gather``,
``reduce`` as ``all-reduce``, ``reduce_scatter`` as ``reduce-scatter``),
``collective_total_bytes`` and ``collective_counts``, and
``moved_bytes_per_tile`` is the total over the tiles.  A count is the bytes
that cross between logical grid positions over the whole grid.  The JAX
record counts each collective's result bytes per device times its ring
multiplier; for a group of n tiles and a result of R bytes a tile (S a
tile's slice of a reduce-scatter):

==================  ===============  ==============
collective          JAX, per device  port, per tile
==================  ===============  ==============
all-reduce          2 R              (n - 1) R
all-gather          R                (n - 1) R / n
reduce-scatter      S                (n - 1) S
==================  ===============  ==============

GSPMD's all-to-alls and resharding permutes have no port counterpart (the
port issues only its explicit collectives).  The grid steps run under
:class:`~repro_torch.launch.hlo_analysis.MetaMemo`; a 16x16 step still
dispatches every op once per tile, so ``collectives=False`` leaves the
count out (the fields stay None), and :func:`run_cells` runs the cells and
each depth run of a count as tasks on every core the process may use.

The chain cell (``--chain``; ``--n 65536 --d 6`` as
``benchmarks/bench_chain_dryrun.py``) runs ``chain_product`` (``fuse_l``) on
meta tiles of a 16x16 :class:`~repro_torch.core.distmatrix.DistContext` for
each schedule and records its FLOPs and the tile bytes the schedule moves
between grid positions (:func:`repro_torch.core.distmatrix.grid_moves`).

Usage::

  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --chain
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import hlo_analysis
from repro_torch.core import collectives as coll
from repro_torch.launch.mesh import (DeviceGrid, LogicalGrid, make_cpu_mesh, make_production_mesh,
                                     mesh_chip_count)
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serving import engine
from repro_torch.tree import tree_leaves, tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
TILE_MEMORY_BYTES = 80 * 10**9  # one H100 80GB per tile


# ---------------------------------------------------------------------------
# rule presets
# ---------------------------------------------------------------------------


def long_context_rules(grid: LogicalGrid) -> dict:
    """long_500k (batch 1): the batch does not shard; the KV sequence spreads
    over every grid axis instead, heads and inner channels over ``model``."""
    r = dict(cm.DEFAULT_RULES)
    r["batch"] = None
    r["kv_seq"] = tuple(grid.axis_names)
    r["heads"] = "model"
    r["inner"] = "model"
    return r


def fsdp_rules(grid: LogicalGrid) -> dict:
    """Pure FSDP / ZeRO-3: the batch over both grid axes, no tensor
    parallelism; every weight's d_model dim shards over the whole grid."""
    r = dict(cm.DEFAULT_RULES)
    r["batch"] = ("data", "model")
    r["batch_inner"] = ("data", "model")
    r["heads"] = None
    r["ff"] = None
    r["inner"] = None
    r["vocab"] = None
    r["embed_p"] = ("data", "model")
    r["embed_d"] = ("data", "model")
    r["kv_seq"] = "model"
    return r


def seqshard_rules(grid: LogicalGrid) -> dict:
    """The sequence over ``model`` instead of tensor parallelism (prefill);
    parameters ZeRO-sharded over the whole grid."""
    r = dict(cm.DEFAULT_RULES)
    r["batch"] = ("pod", "data") if "pod" in grid.axis_names else ("data",)
    r["batch_inner"] = r["batch"]
    r["seq"] = "model"
    r["heads"] = None
    r["ff"] = None
    r["inner"] = None
    r["vocab"] = None
    r["embed_p"] = ("data", "model")
    r["embed_d"] = ("data", "model")
    r["kv_seq"] = "model"
    return r


RULE_PRESETS = {"baseline": None, "fsdp": fsdp_rules, "seqshard": seqshard_rules}


def rules_for(grid: LogicalGrid, shape: configs.ShapeSpec, preset: str = "baseline") -> dict:
    if shape.name.startswith("long"):
        return long_context_rules(grid)
    if preset != "baseline" and shape.kind in ("train", "prefill"):
        return RULE_PRESETS[preset](grid)
    return cm.multipod_rules() if "pod" in grid.axis_names else dict(cm.DEFAULT_RULES)


# ---------------------------------------------------------------------------
# per-tile bytes: exact arithmetic on sanitized specs
# ---------------------------------------------------------------------------


def _leaf_bytes(spec, x, grid) -> int:
    return cm.tile_bytes(spec, x, grid) if isinstance(x, torch.Tensor) else 0


def tree_tile_bytes(specs, tree, grid) -> int:
    """Per-tile bytes of a tree of tensors under a tree of (sanitized) specs;
    a leaf that is no tensor (the cache's host ``pos``) holds no device bytes."""
    return sum(tree_leaves(cm.map_axes(lambda s, x: _leaf_bytes(s, x, grid), specs, tree)))


def batch_specs(inputs: dict, rules: dict, grid) -> dict:
    """The batch inputs' specs: (batch, seq, embed)[:ndim], sanitized."""
    return {k: cm.sanitize_spec(cm.logical_to_spec(("batch", "seq", "embed")[: v.ndim], rules),
                                v.shape, grid) for k, v in inputs.items()}


def step_rules(spec: lm.LMSpec, shape: configs.ShapeSpec, grid, rules: dict) -> dict:
    """The rules a cell's step runs under on ``grid`` (logical or of
    devices), from the cell's ``rules``: train ``rules`` as the train step
    takes them; decode the serve engine's
    (:func:`repro_torch.serving.engine.serve_rules`: every weight resident,
    the experts gathered); prefill the arch's rules with FSDP kept, as the
    JAX package's ``make_prefill``, the grid attached and moves counted
    under ``lm.serve``."""
    if shape.kind == "train":
        return rules
    if shape.kind == "decode":
        return engine.serve_rules(spec, grid, rules)
    return {**cm.attach_axis_sizes(cm.arch_rules(spec.cfg, rules), grid), "_path": "lm.serve"}


def _stacked_meta_tree(spec: lm.LMSpec, compute_cast: bool = False) -> dict:
    """``lm.params_tree``'s layout on meta at the spec's full counts, built
    from a one-layer-a-group tree (stacking meta layers one by one is slow);
    with ``compute_cast`` the :data:`cm.COMPUTE_NAMES` leaves in the compute
    dtype, as ``ServeEngine`` stores them."""
    one = _with_counts(spec, [1] * len(_counts(spec)))
    params = lm.init_params(one, device="meta")
    if compute_cast:
        params = cm.cast_for_compute(params, spec.cfg.cdtype, "meta")
    tree = lm.params_tree(one, params)

    def widen(gtrees, gspecs):
        return [tree_map(lambda t, c=g.count: t.new_empty((c, *t.shape[1:])), gt)
                for gt, g in zip(gtrees, gspecs, strict=True)]

    tree["groups"] = widen(tree["groups"], spec.groups)
    if spec.is_encdec:
        tree["enc_groups"] = widen(tree["enc_groups"], spec.enc_groups)
    return tree


def argument_bytes(spec: lm.LMSpec, shape: configs.ShapeSpec, grid, rules: dict,
                   opt_name: str, *, compute_cast: bool = False) -> dict:
    """Per-tile bytes of every argument of the cell's step, by kind, and the
    per-tile batch.  The parameters count in the parameter dtype, or with
    ``compute_cast`` (a serve cell) as ``ServeEngine`` holds them: the
    matrices (:data:`cm.COMPUTE_NAMES`) in the compute dtype."""
    cfg = spec.cfg
    inputs = configs.input_specs(cfg, shape)
    bspecs = batch_specs(inputs, rules, grid)
    out = {"batch_bytes_per_tile": tree_tile_bytes(bspecs, inputs, grid), "cache_bytes_per_tile": 0,
           "opt_state_bytes_per_tile": 0}
    first = next(iter(inputs))
    out["per_tile_batch"] = cm.tile_shape(bspecs[first], inputs[first].shape, grid)[0]
    train = shape.kind == "train"
    r = cm.arch_rules(cfg, rules) if train else step_rules(spec, shape, grid, rules)
    tree = _stacked_meta_tree(spec, compute_cast)
    pspecs = cm.sanitize_specs(cm.tree_specs(lm.params_tree_axes(spec), r), tree, grid)
    out["param_bytes_per_tile"] = tree_tile_bytes(pspecs, tree, grid)
    out["n_params"] = sum(x.numel() for x in tree_leaves(tree))
    if train:
        from repro_torch.training import optim

        ostate = optim.make_optimizer(optim.OptConfig(name=opt_name))[0](tree)
        ospecs = (optim.adamw_state_specs(pspecs) if opt_name == "adamw"
                  else optim.adafactor_state_specs(pspecs, tree))
        out["opt_state_bytes_per_tile"] = tree_tile_bytes(ospecs, ostate, grid)
    elif shape.kind == "decode":
        cache = _meta_cache(spec, shape, shape.global_batch)
        cspecs = cm.tree_specs(lm.cache_axes(spec), r)
        if spec.is_encdec:
            cspecs["enc_out"] = cm.logical_to_spec(("batch", "seq", "embed"), r)
        cache = {k: cache[k] for k in cspecs}
        out["cache_bytes_per_tile"] = tree_tile_bytes(cm.sanitize_specs(cspecs, cache, grid),
                                                      cache, grid)
    out["argument_bytes_per_tile"] = (out["param_bytes_per_tile"] + out["opt_state_bytes_per_tile"]
                                      + out["batch_bytes_per_tile"] + out["cache_bytes_per_tile"])
    return out


# ---------------------------------------------------------------------------
# the step on meta, at reduced depth
# ---------------------------------------------------------------------------


def _counts(spec: lm.LMSpec) -> list[int]:
    return [g.count for g in spec.groups + spec.enc_groups]


def _with_counts(spec: lm.LMSpec, counts) -> lm.LMSpec:
    n = len(spec.groups)
    groups = tuple(dataclasses.replace(g, count=c) for g, c in zip(spec.groups, counts[:n]))
    enc = tuple(dataclasses.replace(g, count=c) for g, c in zip(spec.enc_groups, counts[n:]))
    return dataclasses.replace(spec, groups=groups, enc_groups=enc)


def _meta_cache(spec: lm.LMSpec, shape: configs.ShapeSpec, batch: int, device="meta",
                pos: int | None = None, enc_len: int | None = None) -> dict:
    """The decode cell's cache on ``device`` (zeros off meta): full (``pos``
    at its last slot unless given); an encoder-decoder's holds the encoder
    output over ``enc_len`` frames (default ``seq_len``), as the JAX
    package's serve step does."""
    enc_len = (enc_len or shape.seq_len) if spec.is_encdec else 0
    cache = lm.init_cache(spec, batch, shape.seq_len, device=device, enc_len=enc_len)
    cache["pos"] = shape.seq_len - 1 if pos is None else pos
    if spec.is_encdec:
        cache["enc_out"] = torch.zeros((batch, enc_len, spec.cfg.d_model), dtype=spec.cfg.cdtype,
                                       device=device)
    return cache


def tile_shares(spec: lm.LMSpec, params: dict, state: dict, opt_name: str, grid,
                rules: dict) -> list[tuple[torch.Tensor, float]]:
    """(tensor, a tile's share of it) of every parameter and optimizer state
    leaf of the train step on ``grid`` (sanitized specs): the counter weighs
    their gradients and the optimizer's temporaries by them."""
    from repro_torch.training import optim

    r = cm.arch_rules(spec.cfg, rules)
    pspecs = cm.sanitize_specs(cm.tree_specs(lm.params_tree_axes(spec), r), params, grid)
    ospecs = (optim.adamw_state_specs(pspecs) if opt_name == "adamw"
              else optim.adafactor_state_specs(pspecs, params))
    out = []

    def add(s, x):
        if isinstance(x, torch.Tensor) and x.numel():
            out.append((x, math.prod(cm.tile_shape(s, x.shape, grid)) / x.numel()))

    cm.map_axes(add, pspecs, params)
    cm.map_axes(add, ospecs, state)
    return out


def run_step(spec: lm.LMSpec, shape: configs.ShapeSpec, batch: int, *, accum: int = 1,
             opt_name: str = "adamw", grid=None, rules: dict | None = None) -> dict:
    """:func:`hlo_analysis.analyze` of the port's step for ``shape`` at
    ``batch`` on meta: the train step (``training.train_step``, its
    optimizer's update included), ``lm.prefill`` of ``seq_len`` tokens, or
    one ``lm.decode_step`` against a full cache of ``seq_len``.  Arguments
    are made before the count starts; serving runs on the parameters cast
    for compute, as ``ServeEngine`` holds them.  With ``grid`` and ``rules``
    the train step's gradients and optimizer temporaries count at a tile's
    share (:func:`tile_shares`)."""
    cfg = spec.cfg
    inputs = configs.input_specs(cfg, shape, batch=batch)
    if shape.kind == "train":
        from repro_torch.training import optim, train_step

        opt_cfg = optim.OptConfig(name=opt_name)
        one = lm.params_tree(spec, lm.init_params(spec, device="meta"))
        params = tree_map(lambda t: t.requires_grad_(True), one)
        init, _ = optim.make_optimizer(opt_cfg)
        state = init(params)
        step = train_step.make_train_step(spec, opt_cfg, accum=accum, device="meta")
        shares = tile_shares(spec, params, state, opt_name, grid, rules) if grid is not None else ()
        return hlo_analysis.analyze(step, params, state, inputs, shares=shares)
    params = cm.cast_for_compute(lm.init_params(spec, device="meta"), cfg.cdtype, "meta")
    with torch.no_grad():
        if shape.kind == "prefill":
            tokens = inputs["tokens"].to(torch.int64)
            return hlo_analysis.analyze(lm.prefill, spec, params, tokens, shape.seq_len,
                                        frames=inputs.get("frames"))
        cache = _meta_cache(spec, shape, batch)
        return hlo_analysis.analyze(lm.decode_step, spec, params,
                                    inputs["token"].to(torch.int64), cache)


def _segments(timeline) -> list[tuple[list, list]]:
    """A timeline cut into its segments: (op names, live bytes) of each."""
    out: dict[int, tuple[list, list]] = {}
    for seg, name, live in timeline:
        names, lives = out.setdefault(seg, ([], []))
        names.append(name)
        lives.append(live)
    return [out[k] for k in sorted(out)]


def _common_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _extrapolated_peak(base: list, grown: list, steps: list) -> int:
    """The live-bytes peak at the full counts, event by event.

    ``base`` is the timeline at depth 1 of every group; ``grown[g]`` the one
    with group g at depth 2, which is ``base`` with the ops of one more layer
    inserted in each segment; ``steps[g]`` is the group's count less 1.  An
    op of ``base`` matches the op at its index in ``grown[g]`` where the two
    agree up to it (the layer next to the segment's start: at depth L, layer
    L's forward and backward) and the op as far from the end where they agree
    from it to the end (the layer next to its end: layer 1, with the
    gradients of layers 2..L behind it).  Each such event's live bytes are
    linear in the count, so each is extrapolated along its line; an op with
    both matches takes the larger.  The layers between lie between the two
    ends, so the largest extrapolated event is the full-depth peak wherever
    every layer adds the same bytes."""
    segs0 = _segments(base)
    segs_g = [_segments(t) for t in grown]
    peak = 0
    for si, (names0, live0) in enumerate(segs0):
        matches = []
        for segs, step in zip(segs_g, steps, strict=True):
            names, lives = segs[si]
            p = _common_prefix(names0, names)
            q = _common_prefix(names0[::-1], names[::-1])
            matches.append((p, q, lives, step))
        n0 = len(names0)
        for j in range(n0):
            v = live0[j]
            for p, q, lives, step in matches:
                opts = [lives[j]] if j < p else []
                if n0 - 1 - j < q:
                    opts.append(lives[len(lives) - n0 + j])
                v += step * (max(opts) - live0[j]) if opts else 0
            peak = max(peak, v)
    return peak


def extrapolated_step(spec: lm.LMSpec, shape: configs.ShapeSpec, batch: int, **kw) -> dict:
    """:func:`run_step` at depth 1 of every layer group, and at depth 2 of
    each group whose count exceeds 1, extrapolated to the spec's counts:
    ``dot_flops`` and ``flops_by_op`` linearly (exact), ``peak_live_bytes``
    event by event (:func:`_extrapolated_peak`)."""
    full = _counts(spec)
    base = [1] * len(full)
    r0 = run_step(_with_counts(spec, base), shape, batch, **kw)
    runs, grown, steps = [base], [], []
    flops = dict(r0["flops_by_op"])
    for g, c in enumerate(full):
        if c <= 1:
            continue
        counts = base.copy()
        counts[g] = 2
        rg = run_step(_with_counts(spec, counts), shape, batch, **kw)
        runs.append(counts)
        grown.append(rg["timeline"])
        steps.append(c - 1)
        for op in set(flops) | set(rg["flops_by_op"]):
            d = rg["flops_by_op"].get(op, 0) - r0["flops_by_op"].get(op, 0)
            flops[op] = flops.get(op, 0) + (c - 1) * d
    peak = _extrapolated_peak(r0["timeline"], grown, steps) if grown else r0["peak_live_bytes"]
    return {"dot_flops": float(sum(flops.values())), "flops_by_op": flops,
            "peak_live_bytes": peak, "depths_run": runs}


# ---------------------------------------------------------------------------
# collectives: the grid step on a grid of meta tiles
# ---------------------------------------------------------------------------


def meta_grid(grid: LogicalGrid | DeviceGrid) -> DeviceGrid:
    """A :class:`DeviceGrid` of ``meta`` tiles shaped as ``grid``: data x
    model, or pod x data x model."""
    sizes = grid.shape
    return make_cpu_mesh(sizes["data"], sizes["model"], pod=sizes.get("pod", 0), device="meta")


def _step_inputs(cfg, shape: configs.ShapeSpec, batch: int, device, seed: int,
                 enc_len: int | None = None) -> dict:
    """The step's inputs on ``device``: empty on meta, else drawn from
    numpy with ``seed`` (ids below the vocab, frames standard normal); an
    encoder's frames over ``enc_len`` positions (default ``seq_len``)."""
    specs = configs.input_specs(cfg, shape, batch=batch)
    if enc_len and "frames" in specs:
        specs["frames"] = specs["frames"].new_empty((batch, enc_len, cfg.d_model))
    if torch.device(device).type == "meta":
        return specs
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in specs.items():
        x = (rng.standard_normal(tuple(v.shape)) if v.is_floating_point()
             else rng.integers(0, cfg.vocab, size=tuple(v.shape)))
        out[k] = torch.as_tensor(x).to(dtype=v.dtype, device=device)
    return out


def grid_step_moves(spec: lm.LMSpec, shape: configs.ShapeSpec, grid: DeviceGrid,
                    rules: dict | None = None, *, batch: int | None = None,
                    s_max: int | None = None, pos: int | None = None,
                    enc_len: int | None = None, opt_name: str = "adamw", accum: int = 1,
                    store_rules: dict | None = None, seed: int = 0) -> dict:
    """The moves of one step of the port on ``grid`` (any device; on meta
    under :class:`~repro_torch.launch.hlo_analysis.MetaMemo`):
    :func:`~repro_torch.core.collectives.lm_moves` read around it, by path.

    - train: ``make_train_step(grid=, rules=rules)`` (``rules`` the base
      rules, as the step takes them) on ``init_state(grid=)``'s state;
    - prefill: ``lm.prefill`` of ``batch x seq_len`` tokens into a cache of
      ``s_max`` (default ``seq_len``);
    - decode: one ``lm.decode_step`` at ``pos`` (default the last slot)
      against a cache of ``seq_len``, cut onto the grid by
      ``lm.cache_to_grid``.

    An encoder-decoder's encoder runs over ``enc_len`` frames (default
    ``seq_len``), its decode cache holds as many.  A serve step runs under
    ``rules`` (the step's rules, as ``lm.prefill`` takes them; any grid in
    them is replaced by ``grid``) on weights stored by ``store_rules``
    (default ``rules``), cast for compute.  Weights come from
    ``lm.init_params(seed=)``, inputs from :func:`_step_inputs`; reading the
    logits or the loss back is not the step's."""
    from repro_torch.training import optim, train_step

    cfg, dev = spec.cfg, grid.home
    batch = batch or shape.global_batch
    inputs = _step_inputs(cfg, shape, batch, dev, seed, enc_len)
    with hlo_analysis.MetaMemo() if dev.type == "meta" else contextlib.nullcontext():
        if shape.kind == "train":
            oc = optim.OptConfig(name=opt_name)
            params, state = train_step.init_state(spec, oc, seed, grid=grid, rules=rules)
            step = train_step.make_train_step(spec, oc, accum=accum, grid=grid, rules=rules)
            before = coll.lm_moves()
            step(params, state, inputs)
        else:
            r = cm.attach_axis_sizes(rules, grid)
            store = cm.attach_axis_sizes(store_rules or rules, grid)
            weights = cm.cast_for_compute(lm.init_params(spec, seed, device=dev), cfg.cdtype, dev)
            tree = lm.param_dict(weights)
            specs = cm.sanitize_specs(lm.param_specs(spec, store), tree, grid)
            view = lm.grid_view(spec, cm.shard_tree(tree, specs, grid), specs, grid,
                                stacked=False)
            run = cm.GridRun(r)
            with torch.no_grad():
                if shape.kind == "prefill":
                    tok = run.place(inputs["tokens"].to(torch.int64), ("batch", "seq"))
                    fr = inputs.get("frames")
                    fr = None if fr is None else run.place(fr, ("batch", "seq", "embed"))
                    before = coll.lm_moves()
                    lm.prefill(spec, view, tok, s_max or shape.seq_len, frames=fr, rules=r)
                else:
                    cache = lm.cache_to_grid(
                        spec, _meta_cache(spec, shape, batch, dev, pos, enc_len), r)
                    tok = run.place(inputs["token"].to(torch.int64), ("batch",))
                    before = coll.lm_moves()
                    lm.decode_step(spec, view, tok, cache, rules=r)
        after = coll.lm_moves()
    return hlo_analysis.moves_between(before, after)


def depth_plan(spec: lm.LMSpec) -> list[list[int]]:
    """The layer-group counts a count runs: 1 in every group, then 2 in each
    group whose count exceeds 1 (the others at 1)."""
    full = _counts(spec)
    plan = [[1] * len(full)]
    for g, c in enumerate(full):
        if c > 1:
            plan.append([2 if i == g else 1 for i in range(len(full))])
    return plan


def extrapolate(spec: lm.LMSpec, plan: list, runs: list) -> dict:
    """Moves by path at the spec's counts from ``runs`` (each a
    :func:`grid_step_moves` reading) at :func:`depth_plan`'s counts: each
    counter along its group's count, linearly."""
    full = _counts(spec)
    m0 = runs[0]
    out = {p: dict(v) for p, v in m0.items()}
    for counts, mg in zip(plan[1:], runs[1:], strict=True):
        c = full[counts.index(2)]
        for p, v in mg.items():
            for k, x in v.items():
                out[p][k] += (c - 1) * (x - m0[p][k])
    return out


def extrapolated_moves(spec: lm.LMSpec, shape: configs.ShapeSpec, grid: DeviceGrid,
                       rules: dict | None = None, **kw) -> tuple[dict, list]:
    """(moves by path at the spec's counts, the counts run):
    :func:`grid_step_moves` at :func:`depth_plan`'s counts, extrapolated
    (:func:`extrapolate`)."""
    plan = depth_plan(spec)
    runs = [grid_step_moves(_with_counts(spec, c), shape, grid, rules, **kw) for c in plan]
    return extrapolate(spec, plan, runs), plan


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _no_moves() -> dict:
    return {p: {f"{k}{x}": 0.0 for k in coll.KINDS for x in ("_bytes", "s")} for p in coll.PATHS}


def count_plan(spec: lm.LMSpec, grid: LogicalGrid) -> list[list[int]]:
    """The depth runs of a cell's count: :func:`depth_plan`, or none on one
    tile (every collective is the identity there)."""
    return depth_plan(spec) if mesh_chip_count(grid) > 1 else []


def depth_run(spec: lm.LMSpec, shape: configs.ShapeSpec, grid: LogicalGrid, counts: list,
              accum: int = 1, preset: str = "baseline") -> tuple[dict, float]:
    """One run of a cell's count (a task of :func:`run_cells`): the grid step
    at the layer-group ``counts`` on :func:`meta_grid` under the cell's
    rules (:func:`step_rules`); its moves by path and its host seconds."""
    t0 = time.perf_counter()
    mg = meta_grid(grid)
    rules = step_rules(spec, shape, mg, rules_for(grid, shape, preset))
    moves = grid_step_moves(_with_counts(spec, counts), shape, mg, rules, accum=accum,
                            opt_name=spec.cfg.optimizer)
    return moves, time.perf_counter() - t0


def _extrapolated(spec: lm.LMSpec, plan: list, runs: list) -> tuple[dict, float]:
    """(moves by path at the spec's counts, host seconds) of a count's
    :func:`depth_run` results ``runs`` at ``plan``'s counts."""
    if not plan:
        return _no_moves(), 0.0
    return extrapolate(spec, plan, [m for m, _ in runs]), sum(t for _, t in runs)


def cell_moves(spec: lm.LMSpec, shape: configs.ShapeSpec, grid: LogicalGrid, *,
               accum: int = 1, preset: str = "baseline") -> tuple[dict, float]:
    """A cell's moves by path at the spec's depth and their host seconds:
    :func:`count_plan`'s :func:`depth_run` s, extrapolated."""
    plan = count_plan(spec, grid)
    return _extrapolated(spec, plan, [depth_run(spec, shape, grid, c, accum, preset)
                                      for c in plan])


def _with_moves(rec: dict, moves: dict, seconds: float) -> dict:
    """``rec`` with its collective fields from ``moves`` (module docstring)."""
    nbytes, counts = hlo_analysis.collectives_of(moves)
    total = sum(nbytes.values())
    rec["analysis"].update(collective_bytes=nbytes, collective_total_bytes=total,
                           collective_counts=counts)
    rec.update(moved_bytes_per_tile=total / rec["chips"], moves_by_path=moves,
               collective_seconds=seconds)
    rec["seconds"] += seconds
    return rec


def dry_cell(arch_id: str, shape: configs.ShapeSpec, grid: LogicalGrid, *, accum: int = 1,
             preset: str = "baseline", flops_cache: dict | None = None,
             collectives: bool = True) -> dict:
    """One cell's record (module docstring).  ``flops_cache`` (a caller's dict)
    keeps the global step's counts between grids: they do not depend on it.
    ``collectives=False`` leaves the grid step's count out (None); a 1x1
    grid moves nothing."""
    t0 = time.perf_counter()
    cfg = configs.get_config(arch_id)
    spec = lm.build_spec(cfg)
    rules = rules_for(grid, shape, preset)
    args = argument_bytes(spec, shape, grid, rules, cfg.optimizer)
    kw = {"accum": accum, "opt_name": cfg.optimizer}
    tile = extrapolated_step(spec, shape, args["per_tile_batch"], grid=grid, rules=rules, **kw)
    key = (arch_id, shape, accum)
    glob = (flops_cache or {}).get(key)
    if glob is None:  # the per-tile run's FLOPs are the global step's when the batch is whole
        glob = (tile if args["per_tile_batch"] == shape.global_batch
                else extrapolated_step(spec, shape, shape.global_batch, **kw))
        if flops_cache is not None:
            flops_cache[key] = glob
    per_tile = args["argument_bytes_per_tile"] + tile["peak_live_bytes"]
    rec = {
        "arch": arch_id, "shape": shape.name, "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "mesh": grid.shape, "chips": mesh_chip_count(grid),
        "preset": preset, "accum": accum, **args,
        "activation_bytes_estimate": tile["peak_live_bytes"],
        "per_tile_bytes_estimate": per_tile,
        "fits_80gb": per_tile <= TILE_MEMORY_BYTES,
        "dot_flops": glob["dot_flops"],
        "analysis": {"dot_flops": glob["dot_flops"], "flops_by_op": glob["flops_by_op"],
                     "collective_bytes": None, "collective_total_bytes": None,
                     "collective_counts": None},
        "moved_bytes_per_tile": None, "moves_by_path": None, "collective_seconds": None,
        "depths_run": glob["depths_run"],
    }
    rec["seconds"] = time.perf_counter() - t0
    if collectives:
        _with_moves(rec, *cell_moves(spec, shape, grid, accum=accum, preset=preset))
    return rec


def _cell_line(rec: dict) -> str:
    gb = rec["per_tile_bytes_estimate"] / 1e9
    coll_total = rec["analysis"]["collective_total_bytes"]
    moved = ("" if coll_total is None else
             f", coll {coll_total / 1e9:.3f} GB ({rec['moved_bytes_per_tile'] / 1e9:.4f} GB a "
             f"tile, {rec['collective_seconds']:.2f} s)")
    return (f"args {rec['argument_bytes_per_tile'] / 1e9:.3f} GB + act "
            f"{rec['activation_bytes_estimate'] / 1e9:.3f} GB = {gb:.3f} GB a tile of "
            f"{TILE_MEMORY_BYTES / 1e9:.0f} GB ({'fits' if rec['fits_80gb'] else 'DOES NOT FIT'}), "
            f"dot_flops {rec['dot_flops']:.4e}{moved}, {rec['seconds']:.2f} s")


def _write(out_dir: str, tag: str, rec: dict) -> None:
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _counted(collectives, arch_id: str, shape: configs.ShapeSpec, mesh_name: str) -> bool:
    return (collectives is True
            or (collectives is not False and (arch_id, shape.name, mesh_name) in collectives))


def _error_record(arch_id: str, shape: configs.ShapeSpec, mesh_name: str,
                  e: Exception) -> dict:
    """A failed cell's record, the traceback's tail kept."""
    return {"arch": arch_id, "shape": shape.name, "mesh": mesh_name, "status": "error",
            "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-2000:]}


def _cell_records(arch_id: str, shape: configs.ShapeSpec, meshes, accum: int,
                  preset: str) -> list[dict]:
    """The records of one (arch, shape) on each grid, their collectives not
    yet counted (a task of :func:`run_cells`); a cell's failure is recorded
    and the others still run."""
    out = []
    flops_cache: dict = {}
    for mesh_name in meshes:
        grid = make_production_mesh(multi_pod=mesh_name == "multi")
        try:
            rec = dry_cell(arch_id, shape, grid, accum=accum, preset=preset,
                           flops_cache=flops_cache, collectives=False)
            rec["status"] = "ok"
        except Exception as e:
            rec = _error_record(arch_id, shape, mesh_name, e)
        out.append(rec)
    return out


def _run_cost(spec: lm.LMSpec, shape: configs.ShapeSpec, grid: LogicalGrid, counts: list) -> int:
    """A depth run's rough cost, to start the longest first: its blocks x
    its kind x the grid's tiles."""
    spec = _with_counts(spec, counts)
    blocks = len(spec.layers()) + len(spec.enc_layers())
    return blocks * {"train": 3, "prefill": 2, "decode": 1}[shape.kind] * mesh_chip_count(grid)


def worker_count() -> int:
    """The processes :func:`run_cells` runs its tasks in: the cores this
    process may run on."""
    return len(os.sched_getaffinity(0))


def run_cells(cells, meshes, out_dir: str, accum: int = 1, preset: str = "baseline",
              log=print, *, collectives=True) -> list[dict]:
    """Every cell on every grid in ``meshes``: one record each, written to
    ``out_dir`` and returned grid by grid.  ``collectives``: count every
    cell's collectives (True), none (False), or only those of the
    ``(arch, shape name, mesh name)`` triples it holds.  The work runs as
    tasks in :func:`worker_count` processes (spawned: each imports the port
    anew; in this process when there is one core): each (arch, shape)'s
    records on every grid one task, each :func:`depth_run` of a count one,
    the costliest first.  A script that calls it guards its top level with
    ``if __name__ == "__main__":`` (the workers import it again)."""
    os.makedirs(out_dir, exist_ok=True)
    counts: dict = {}  # (arch, shape name, mesh name) -> (spec, plan, {counts: its task})
    runs = []  # (cost, key, spec, shape, grid, counts)
    for arch_id, shape in cells:
        spec = lm.build_spec(configs.get_config(arch_id))
        for m in meshes:
            if _counted(collectives, arch_id, shape, m):
                grid = make_production_mesh(multi_pod=m == "multi")
                key = (arch_id, shape.name, m)
                counts[key] = (spec, count_plan(spec, grid), {})
                runs += [(_run_cost(spec, shape, grid, c), key, spec, shape, grid, c)
                         for c in counts[key][1]]
    runs.sort(key=lambda r: -r[0])
    n = min(worker_count(), len(runs) + len(cells))
    pool = (ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) if n > 1
            else ThreadPoolExecutor(1))
    done: dict = {}
    with pool as ex:
        for _, key, spec, shape, grid, c in runs:
            counts[key][2][tuple(c)] = ex.submit(depth_run, spec, shape, grid, c, accum, preset)
        recs = [(arch_id, shape, ex.submit(_cell_records, arch_id, shape, tuple(meshes), accum,
                                           preset)) for arch_id, shape in cells]
        for arch_id, shape, fut in recs:
            for mesh_name, rec in zip(meshes, fut.result(), strict=True):
                key = (arch_id, shape.name, mesh_name)
                if rec["status"] == "ok" and key in counts:
                    spec, plan, futs = counts[key]
                    try:
                        _with_moves(rec, *_extrapolated(spec, plan,
                                                        [futs[tuple(c)].result() for c in plan]))
                    except Exception as e:  # a depth run failed: the cell fails
                        rec = _error_record(arch_id, shape, mesh_name, e)
                tag = "__".join(key)
                log(f"[dryrun] {tag}: " + (_cell_line(rec) if rec["status"] == "ok"
                                           else f"ERROR {rec['error'][:200]}"))
                _write(out_dir, tag, rec)
                done[key] = rec
    return [done[arch_id, shape.name, m] for m in meshes for arch_id, shape in cells]


# ---------------------------------------------------------------------------
# the CADDeLaG chain on meta tiles
# ---------------------------------------------------------------------------


def chain_gemms(d_len: int) -> int:
    """``chain_product``'s n x n GEMMs: 2 (d - 1) squarings and products and
    the P2 product."""
    return 2 * (d_len - 1) + 1


def chain_moves(n: int, rows: int, cols: int, d_len: int, schedule: str,
                itemsize: int = 4) -> dict:
    """The tile bytes ``schedule`` moves between grid positions in one
    ``chain_product`` (its GEMMs only), counted as
    :mod:`repro_torch.core.distmatrix` counts them."""
    tile = (n // rows) * (n // cols) * itemsize
    g = chain_gemms(d_len)
    if schedule in ("xla", "summa"):
        per = rows * cols * (cols - 1 + rows - 1)
        return {"gather_bytes": g * per * tile, "gathers": g * per, "permute_bytes": 0,
                "permutes": 0}
    skew_a = sum(1 for r in range(rows) for c in range(cols) if (c - r) % cols != c)
    skew_b = sum(1 for r in range(rows) for c in range(cols) if (r - c) % rows != r)
    shifts = 2 * (rows - 1) * rows * cols if cols > 1 else 0
    per = skew_a + skew_b + shifts
    return {"gather_bytes": 0, "gathers": 0, "permute_bytes": g * per * tile,
            "permutes": g * per}


def dry_chain(n: int = 65536, d_len: int = 6, rows: int = 16, cols: int = 16,
              schedules=("xla", "summa", "cannon"), log=print) -> dict:
    """``chain_product(fuse_l=True)`` of an n x n fp32 matrix on meta tiles of a
    ``rows x cols`` grid, per schedule: FLOPs (whole grid and per tile, the
    GEMMs' analytic count beside), the bytes moved between grid positions
    (counted and analytic), and the peak of live meta bytes (every tile on
    the one meta device, spread evenly per tile; SUMMA's gathered panels are
    cached per device, so a grid of distinct cards holds
    ``gather_panel_bytes_per_tile`` more at a time)."""
    from repro_torch.core.chain import chain_product
    from repro_torch.core.distmatrix import DistMatrix
    from repro_torch.launch.mesh import make_device_grid

    ctx = make_device_grid(rows, cols, "meta")
    tiles = rows * cols
    t_all = time.perf_counter()
    out = {"n": n, "d": d_len, "grid": [rows, cols], "gemms": chain_gemms(d_len), "schedules": {}}
    for sched in schedules:
        if sched == "cannon" and rows != cols:
            continue
        t0 = time.perf_counter()
        a = DistMatrix(ctx, [[torch.empty((n // rows, n // cols), device="meta")
                              for _ in range(cols)] for _ in range(rows)])
        ana = hlo_analysis.analyze(chain_product, a, d_len, schedule=sched, fuse_l=True, ctx=ctx,
                                   grid=ctx)
        moves = chain_moves(n, rows, cols, d_len, sched)
        gemm_flops = chain_gemms(d_len) * 2.0 * float(n) ** 3
        rec = {
            "dot_flops": ana["dot_flops"], "dot_flops_per_tile": ana["dot_flops"] / tiles,
            "gemm_flops_analytic": gemm_flops, "flops_by_op": ana["flops_by_op"],
            "collective_bytes": ana["collective_bytes"],
            "collective_total_bytes": ana["collective_total_bytes"],
            "collective_counts": ana["collective_counts"],
            "moved_bytes_per_tile": ana["collective_total_bytes"] / tiles,
            "moves_analytic": moves,
            "peak_live_bytes": ana["peak_live_bytes"],
            "peak_bytes_per_tile": ana["peak_live_bytes"] / tiles,
            "gather_panel_bytes_per_tile": (
                (n // rows) * n * 4 + n * (n // cols) * 4 if sched != "cannon" else 0),
            "seconds": time.perf_counter() - t0,
        }
        if rec["collective_total_bytes"] != moves["gather_bytes"] + moves["permute_bytes"]:
            raise RuntimeError(f"chain {sched}: counted {rec['collective_total_bytes']} moved "
                               f"bytes, the schedule's analytic count is {moves}")
        out["schedules"][sched] = rec
        log(f"[dryrun] chain n={n} d={d_len} {rows}x{cols} {sched}: dot_flops "
            f"{rec['dot_flops']:.4e} ({rec['dot_flops_per_tile']:.4e} a tile; GEMMs "
            f"{gemm_flops:.4e}), moved {rec['collective_total_bytes'] / 1e9:.3f} GB "
            f"({rec['moved_bytes_per_tile'] / 1e9:.4f} GB a tile), peak "
            f"{rec['peak_bytes_per_tile'] / 1e9:.3f} GB a tile (+ "
            f"{rec['gather_panel_bytes_per_tile'] / 1e9:.3f} GB of panels), {rec['seconds']:.2f} s")
    out["seconds"] = time.perf_counter() - t_all
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all supported)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--rules", default="baseline", choices=list(RULE_PRESETS),
                    help="sharding preset for train / prefill cells")
    ap.add_argument("--out", default=None,
                    help="output directory (default experiments/dryrun_torch)")
    ap.add_argument("--chain", action="store_true",
                    help="add the CADDeLaG chain cell (16x16 grid; alone, it runs by itself)")
    ap.add_argument("--n", type=int, default=65536, help="the chain cell's n")
    ap.add_argument("--d", type=int, default=6, help="the chain cell's length d")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    out_dir = args.out or os.path.normpath(OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    cells = []
    if args.all or args.arch is not None or not args.chain:
        if args.all or args.arch is None:
            cells = configs.all_cells()
        else:
            cfg = configs.get_config(args.arch)
            shapes = ([configs.SHAPES_BY_NAME[args.shape]] if args.shape
                      else list(configs.supported_shapes(cfg)))
            cells = [(args.arch, s) for s in shapes]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = run_cells(cells, meshes, out_dir, accum=args.accum, preset=args.rules)
    n_ok = sum(r["status"] == "ok" for r in records)
    if args.chain:
        try:
            rec = dry_chain(args.n, args.d)
            rec["status"] = "ok"
        except Exception as e:  # recorded like a cell's failure
            rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] chain: ERROR {type(e).__name__}: {str(e)[:200]}")
        _write(out_dir, f"chain__n{args.n}__d{args.d}__16x16", rec)
        records.append(rec)
        n_ok += rec["status"] == "ok"
    slowest = max((r for r in records if "seconds" in r), key=lambda r: r["seconds"], default=None)
    print(f"\n{n_ok}/{len(records)} cells ok in {time.perf_counter() - t0:.1f} s"
          + (f"; slowest {slowest.get('arch', 'chain')} {slowest.get('shape', '')} "
             f"{slowest['seconds']:.2f} s" if slowest else ""))
    if n_ok < len(records):
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
