"""The training step on one device: gradient accumulation, clipping, update.

Port of :mod:`repro.training.train_step`.  ``make_train_step`` returns

    step(params, opt_state, batch) -> (params, opt_state, metrics)

where ``params`` is the model's parameter tree (``lm.params_tree``, the JAX
package's layout, leaves that require grad), ``opt_state`` its optimizer
state and ``batch`` a dict of numpy arrays or tensors (tokens, labels
[, frames]).  The global batch is split into ``accum`` microbatches run one
after another; their gradients are averaged in fp32.  Gradients come from
autograd; the kernels on the path (``flash_attention``, ``wkv``) go through
their ``autograd.Function``s, whose backward recomputes the plain chunked
forms, as the JAX package differentiates its plain scans.  Parameters and
moments are updated in place.

On a device grid (``make_train_step(..., grid=)``: every family) the parameters and optimizer state are per-tile trees laid out
by the sanitized ``lm.params_tree_axes`` specs and the optimizer's state specs
(:func:`init_state` makes them, ``models.common.shard_tree`` /
``unshard_tree`` convert), the batch is laid out by ``(batch, seq)`` (an
encoder-decoder's frames by ``(batch, seq, embed)``), and
the forward is ``lm.loss_fn`` on the grid: autograd through its
collectives gives each tile the gradient of its own shard, already summed
over the data-parallel axes.  The global norm and Adafactor's statistics
reduce over the tiles (``optim.grid_update``).  Every move counts under
``lm.train``.

:func:`make_compressed_train_step` runs on a ``("pod", "data", "model")``
grid: each pod computes the gradient of its own batch rows on its
``data x model`` sub-grid with the JAX function's inner rules (the batch over
``data``, the embedding table whole), then :func:`compressed_pod_allreduce`
syncs the pods through int8 with error feedback (counted under ``lm.pod``).
The JAX package marks its version experimental on the CPU (XLA aborts when
it partitions it); the port has no partitioner and runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.training import optim as opt_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """(B, ...) -> ``accum`` dicts of (B / accum, ...) each, in row order."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} microbatches")
    n = b // accum
    return [{k: x[i * n : (i + 1) * n] for k, x in batch.items()} for i in range(accum)]


def batch_to_device(batch: dict, device) -> dict:
    """Numpy or tensor batch -> tensors on ``device``: integer arrays as int64
    (the embedding's and the loss's indices), the rest as they are."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out


def make_loss_and_grad(spec: lm.LMSpec, accum: int = 1):
    """(params, batch) -> (loss, metrics, grads): the mean over ``accum``
    microbatches; metrics are the last microbatch's, as the JAX package's."""

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        loss, metrics = lm.loss_fn(spec, lm.params_view(spec, params), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def accum_grads(params, batch):
        if accum == 1:
            return grad_fn(params, batch)
        grads_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        for mb in _split_microbatches(batch, accum):
            loss, metrics, grads = grad_fn(params, mb)
            for a, g in zip(tree_leaves(grads_acc), tree_leaves(grads), strict=True):
                a.copy_(a + g.to(torch.float32) / accum)
            loss_acc = loss_acc + loss / accum
        return loss_acc, metrics, grads_acc

    return accum_grads


def make_train_step(spec: lm.LMSpec, opt_cfg: opt_mod.OptConfig, *, accum: int = 1,
                    device="cuda", grid=None, rules=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient (mean over ``accum`` microbatches), clipped to the global norm
    ``opt_cfg.clip_norm``, then the optimizer's update in place; metrics
    ``loss``, ``grad_norm``, ``xent``, ``lb_loss`` and ``z_loss`` (0-dim
    tensors on the device; reading one waits for the step).

    With a ``grid`` larger than 1x1 (a ``DeviceGrid`` or ``DistContext``)
    ``params`` and ``opt_state`` are per-tile trees (:func:`init_state`),
    ``batch`` a dict of whole numpy arrays or tensors, or of per-tile values
    laid out by ``(batch, seq)`` (``data.pipeline.global_batch_for``);
    ``rules`` default to the JAX step's (``multipod_rules`` on a pod grid).
    Metrics are tile 0's.  A 1x1 grid takes the single-device step on its
    device.
    """
    if grid is not None:
        g = cm.device_grid(grid)
        if not g.is_trivial:
            return _GridStep(spec, opt_cfg, g, rules, accum)
        device = g.home
    dev = resolve_device(device)
    _, opt_update = opt_mod.make_optimizer(opt_cfg)
    accum_grads = make_loss_and_grad(spec, accum)

    def step(params, opt_state, batch):
        loss, metrics, grads = accum_grads(params, batch_to_device(batch, dev))
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, {**metrics, "loss": loss, "grad_norm": gnorm}

    return step


def init_state(spec: lm.LMSpec, opt_cfg: opt_mod.OptConfig, seed: int = 0, *, device="cuda",
               grid=None, rules=None):
    """(params, opt_state) on ``device``: the port's own random init
    (``lm.init_params`` with ``seed``) as a parameter tree whose leaves
    require grad, and the optimizer's zero state.

    With a ``grid`` larger than 1x1 both are per-tile trees, each tile's
    leaves exactly ``tile_shape`` of their sanitized specs (:func:`grid_specs`),
    drawn whole on the grid's home device and cut; a 1x1 grid gives the
    single-device state on its device; the optimizer's zero state is made
    per tile, at the tiles' shapes."""
    if grid is not None:
        g = cm.device_grid(grid)
        if not g.is_trivial:
            module = lm.init_params(spec, seed=seed, device=g.home)
            whole = lm.params_tree(spec, module)
            del module
            pspecs, _ = grid_specs(spec, opt_cfg, g, rules)
            params = cm.shard_tree(tree_map(lambda t: t.requires_grad_(True), whole), pspecs, g)
            del whole
            opt_init, _ = opt_mod.make_optimizer(opt_cfg)
            return params, [opt_init(p) for p in params]
        device = g.home
    dev = resolve_device(device)
    module = lm.init_params(spec, seed=seed, device=dev)
    params = tree_map(lambda t: t.requires_grad_(True), lm.params_tree(spec, module))
    del module
    opt_init, _ = opt_mod.make_optimizer(opt_cfg)
    return params, opt_init(params)


# ---------------------------------------------------------------------------
# on a device grid
# ---------------------------------------------------------------------------


def train_rules(spec: lm.LMSpec, grid, rules=None) -> dict:
    """The train step's rules on ``grid``: ``rules`` (by default the JAX
    step's: ``multipod_rules`` on a pod grid, else ``DEFAULT_RULES``) with
    the arch's overrides, the grid attached, and moves counted under
    ``lm.train``."""
    g = cm.device_grid(grid)
    rules = rules or (cm.multipod_rules() if "pod" in g.axis_names else dict(cm.DEFAULT_RULES))
    return {**cm.attach_axis_sizes(cm.arch_rules(spec.cfg, rules), g), "_path": "lm.train"}


def _stacked_shapes(spec: lm.LMSpec) -> dict:
    return lm.params_tree(spec, lm.init_params(spec, device="meta"))


def grid_specs(spec: lm.LMSpec, opt_cfg: opt_mod.OptConfig, grid, rules=None):
    """(parameter specs, optimizer state specs) of the training state on
    ``grid``, sanitized: ``lm.params_tree_axes`` by the rules, and the
    optimizer's ``*_state_specs`` of those."""
    r = train_rules(spec, grid, rules)
    shapes = _stacked_shapes(spec)
    pspecs = cm.sanitize_specs(cm.tree_specs(lm.params_tree_axes(spec), r), shapes, grid)
    ospecs = (opt_mod.adamw_state_specs(pspecs) if opt_cfg.name == "adamw"
              else opt_mod.adafactor_state_specs(pspecs, shapes))
    return pspecs, ospecs


def _is_tiled(batch: dict) -> bool:
    return isinstance(next(iter(batch.values())), coll.Sharded)


def place_batch(batch: dict, run: cm.GridRun) -> dict:
    """A whole batch (numpy or tensors) cut into its tiles by ``(batch, seq)``,
    ids as int64 (a placement: no move is counted)."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = run.place(t, ("batch", "seq", "embed")[: t.ndim])
    return out


def _microbatches(batch: dict, accum: int, run: cm.GridRun) -> list[dict]:
    """``accum`` microbatches of the global batch's rows (the JAX package's
    reshape to (accum, B / accum)), each laid out by ``(batch, seq)``: a
    per-tile batch is put back together on the home device first."""
    if _is_tiled(batch):
        if accum == 1:
            return [{k: v if v[0].is_floating_point() else coll.Sharded(
                [x.to(torch.int64) for x in v], v.spec, v.shape) for k, v in batch.items()}]
        batch = {k: cm.unshard_tree(list(v), cm.Spec(*v.spec), run.grid)
                 for k, v in batch.items()}
    return [place_batch(mb, run) for mb in _split_microbatches(batch, accum)]


def grid_loss_and_grad(spec: lm.LMSpec, params: list, batch: dict, pspecs, run: cm.GridRun):
    """(loss, metrics, grads) on every tile: ``lm.loss_fn`` on the grid and
    autograd through its collectives, the loss's copy on each tile seeded
    with 1 (it is the same value on every tile)."""
    view = lm.grid_view(spec, params, pspecs, run.grid)
    loss, metrics = lm.loss_fn(spec, view, batch, rules=run.rules)
    leaves = [tree_leaves(p) for p in params]
    flat = [x for lv in leaves for x in lv]
    grads = torch.autograd.grad(loss, flat, grad_outputs=[torch.ones_like(x) for x in loss],
                                allow_unused=True, materialize_grads=True)
    n = len(leaves[0])
    gtrees = [tree_unflatten(params[t], list(grads[t * n:(t + 1) * n]))
              for t in range(len(params))]
    metrics = {k: [x.detach() for x in v] for k, v in metrics.items()}
    return [x.detach() for x in loss], metrics, gtrees


class _GridStep:
    """The train step on a grid larger than 1x1 (:func:`make_train_step`)."""

    def __init__(self, spec, opt_cfg, grid, rules, accum: int):
        self.spec, self.opt_cfg, self.grid, self.accum = spec, opt_cfg, grid, accum
        self.run = cm.GridRun(train_rules(spec, grid, rules))
        self.pspecs, self.ospecs = grid_specs(spec, opt_cfg, grid, rules)

    def grads(self, params, batch):
        """(loss, metrics, grads) per tile, the mean over ``accum`` microbatches."""
        run = self.run
        micro = _microbatches(batch, self.accum, run)
        if len(micro) == 1:
            return grid_loss_and_grad(self.spec, params, micro[0], self.pspecs, run)
        acc = loss_acc = metrics = None
        for mb in micro:
            loss, metrics, grads = grid_loss_and_grad(self.spec, params, mb, self.pspecs, run)
            g32 = [tree_map(lambda g: g.to(torch.float32) / self.accum, tr) for tr in grads]
            acc = g32 if acc is None else [tree_map(torch.add, a, g) for a, g in zip(acc, g32)]
            part = [x / self.accum for x in loss]
            loss_acc = part if loss_acc is None else [a + b for a, b in zip(loss_acc, part)]
        return loss_acc, metrics, acc

    def __call__(self, params, opt_state, batch):
        loss, metrics, grads = self.grads(params, batch)
        grads, norms = opt_mod.grid_clip(grads, self.pspecs, self.grid, self.opt_cfg.clip_norm)
        opt_mod.grid_update(self.opt_cfg, grads, opt_state, params, self.pspecs, self.grid)
        out = {k: v[0] for k, v in metrics.items()}
        return params, opt_state, {**out, "loss": loss[0], "grad_norm": norms[0]}


# ---------------------------------------------------------------------------
# int8 error-feedback compression for the cross-pod gradient sync
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization; returns (q, scale), as the JAX
    package's: ``scale = max(amax, 1e-12) / 127``, ``q = clip(round(x /
    scale), -127, 127)`` with rounding half to even (``jnp.round``)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


POD_PATH = "lm.pod"


@torch.no_grad()
def compressed_pod_allreduce(grads: list, ef: list, grid, axis: str = "pod"):
    """The mean over ``axis`` of per-tile gradient trees through int8 with
    error feedback; returns (synced, new residuals), per-tile trees.

    For each leaf each pod adds its residual (``ef``, fp32, its own) to its
    gradient, quantizes the sum per tensor (the scale from the largest
    magnitude over the pod's tiles of the leaf, as the JAX package's over
    the whole leaf), keeps ``sum - dequantized`` as its next residual, and
    every tile takes the mean of the pods' dequantized tiles at its
    position, in pod order.  Moves count under ``lm.pod``: the max over a
    pod's tiles (4 bytes a tile), and the int8 tile and its scale from every
    other pod."""
    g_ = cm.device_grid(grid)
    n = g_.n_tiles
    pods = g_.groups((axis,))          # tiles at one position, one per pod
    within = g_.groups(tuple(a for a in g_.axis_names if a != axis))  # one pod's tiles
    n_pods = g_.shape[axis]
    gl = [tree_leaves(t) for t in grads]
    el = [tree_leaves(t) for t in ef]
    out_g = [[None] * len(gl[0]) for _ in range(n)]
    out_e = [[None] * len(gl[0]) for _ in range(n)]
    for i in range(len(gl[0])):
        g32 = [gl[t][i].to(torch.float32) + el[t][i] for t in range(n)]
        scales = [None] * n
        for tiles in within:
            amax = torch.max(torch.abs(g32[tiles[0]]))
            for t in tiles[1:]:
                amax = torch.maximum(amax, torch.max(torch.abs(g32[t])).to(amax.device))
            coll._count(POD_PATH, "reduce", 4 * len(tiles) * (len(tiles) - 1))
            scale = torch.clamp(amax, min=1e-12) / 127.0
            for t in tiles:
                scales[t] = scale.to(g32[t].device)
        q = [torch.clamp(torch.round(g32[t] / scales[t]), -127, 127).to(torch.int8)
             for t in range(n)]
        deq = [dequantize_int8(q[t], scales[t]) for t in range(n)]
        for t in range(n):
            out_e[t][i] = g32[t] - deq[t]
        coll._count(POD_PATH, "reduce", (n_pods - 1) * sum(x.numel() + 4 for x in q))
        for grp in pods:
            for t in grp:
                dev = deq[t].device
                acc = deq[grp[0]].to(dev)
                for j in grp[1:]:
                    acc = acc + deq[j].to(dev)
                out_g[t][i] = (acc / n_pods).to(gl[t][i].dtype)
    return ([tree_unflatten(grads[t], out_g[t]) for t in range(n)],
            [tree_unflatten(ef[t], out_e[t]) for t in range(n)])


def pod_inner_rules(spec: lm.LMSpec, grid, rules=None) -> dict:
    """The JAX compressed step's inner rules: ``multipod_rules`` (or
    ``rules``) with the batch over ``data`` alone inside a pod and the
    embedding table whole (``vocab`` and ``embed_d`` to None), the arch's
    overrides, attached to one pod's sub-grid."""
    r = dict(rules or cm.multipod_rules())
    r = cm.arch_rules(spec.cfg, r)
    r["batch"] = tuple(a for a in r["batch"] if a != "pod") or ("data",)
    r["batch_inner"] = r["batch"]
    r["vocab"] = None
    r["embed_d"] = None
    return r


def make_compressed_train_step(spec: lm.LMSpec, grid, opt_cfg: opt_mod.OptConfig, *,
                               rules=None, accum: int = 1):
    """The multi-pod train step with the int8 error-feedback pod sync.

    Returns (step, ef_init, param specs): ``step(params, opt_state, batch,
    ef) -> (params, opt_state, metrics, ef)`` on per-tile trees of the whole
    ``(pod, data, model)`` grid, every pod holding the same parameters and
    state laid out by :func:`pod_inner_rules` on its sub-grid
    (:func:`init_pod_state`); pod ``p`` computes the gradient of the batch
    rows ``[p B / P, (p + 1) B / P)``; the loss and metrics are the pods'
    mean (in pod order), the grad norm that of the synced gradient.
    ``step.pod_grads(params, batch)`` gives each pod's own (loss, metrics,
    gradient tiles) before the sync.  ``ef_init(params)`` gives zero
    residuals.
    """
    g = cm.device_grid(grid)
    if "pod" not in g.axis_names:
        raise ValueError("compressed sync needs a 'pod' grid axis")
    step = _CompressedStep(spec, opt_cfg, g, pod_inner_rules(spec, g, rules), accum)

    def ef_init(params):
        return [tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)
                for t in params]

    return step, ef_init, step.pspecs


class _CompressedStep:
    def __init__(self, spec, opt_cfg, grid, inner, accum: int):
        self.grid, self.opt_cfg = grid, opt_cfg
        self.n_pods = grid.shape["pod"]
        self.per = grid.n_tiles // self.n_pods
        self.subs = [_GridStep(spec, opt_cfg, _pod_grid(grid, p), inner, accum)
                     for p in range(self.n_pods)]
        self.pspecs = self.subs[0].pspecs

    def pod_grads(self, params, batch):
        """(loss, metrics, gradients) of every tile of the whole grid, each
        pod's its own (before the sync)."""
        b = next(iter(batch.values())).shape[0]
        if b % self.n_pods:
            raise ValueError(f"batch {b} does not split over {self.n_pods} pods")
        rows, per = b // self.n_pods, self.per
        losses, metrics, grads = [], {}, []
        for p, sub in enumerate(self.subs):
            mine = {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}
            loss, met, gr = sub.grads(params[p * per:(p + 1) * per], mine)
            losses += loss
            for k, v in met.items():
                metrics.setdefault(k, []).extend(v)
            grads += gr
        return losses, metrics, grads

    def __call__(self, params, opt_state, batch, ef):
        losses, metrics, grads = self.pod_grads(params, batch)
        grads, ef = compressed_pod_allreduce(grads, ef, self.grid)
        norm = None
        for p, sub in enumerate(self.subs):
            sl = slice(p * self.per, (p + 1) * self.per)
            gp, norms = opt_mod.grid_clip(grads[sl], self.pspecs, sub.grid,
                                          self.opt_cfg.clip_norm)
            opt_mod.grid_update(self.opt_cfg, gp, opt_state[sl], params[sl], self.pspecs,
                                sub.grid)
            norm = norms[0] if norm is None else norm
        met = {k: coll.pmean(v, self.grid, ("pod",), POD_PATH)[0] for k, v in metrics.items()}
        loss = coll.pmean(losses, self.grid, ("pod",), POD_PATH)[0]
        return params, opt_state, {**met, "loss": loss, "grad_norm": norm}, ef


def _pod_grid(grid, p: int):
    from repro_torch.launch.mesh import DeviceGrid

    return DeviceGrid((grid.context(p),))


def init_pod_state(spec: lm.LMSpec, opt_cfg: opt_mod.OptConfig, grid, seed: int = 0, *,
                   rules=None):
    """(params, opt_state) of :func:`make_compressed_train_step`: one init,
    laid out by :func:`pod_inner_rules` on each pod's sub-grid, every pod
    holding a copy; per-tile trees over the whole grid."""
    g = cm.device_grid(grid)
    inner = pod_inner_rules(spec, g, rules)
    params, _ = init_state(spec, opt_cfg, seed, device=g.home)
    pspecs, _ = grid_specs(spec, opt_cfg, _pod_grid(g, 0), inner)
    out = []
    for p in range(g.shape["pod"]):
        out += cm.shard_tree(params, pspecs, _pod_grid(g, p))
    opt_init, _ = opt_mod.make_optimizer(opt_cfg)
    return out, [opt_init(t) for t in out]
