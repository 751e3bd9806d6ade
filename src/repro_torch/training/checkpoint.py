"""Atomic, async checkpoints in the JAX package's layout; restore onto any device.

Port of :mod:`repro.training.checkpoint`.  Layout (one directory per step):

    ckpt_dir/step_000123/
        manifest.json        # step, leaf shapes/dtypes, user extra dict
        leaf_000000.npy ...  # one file per tree leaf, in flatten order

The leaves come in ``jax.tree.leaves`` order (dict keys sorted, lists by
index; :mod:`repro_torch.tree`) and a training state has the JAX package's
layout (``lm.params_tree``, the optimizer's ``m``/``v``/``count``), so a
checkpoint written by either package restores into the other.  A bf16 leaf
is stored as the JAX package's ``np.save`` stores one: its raw two-byte
values (``|V2``), with ``bfloat16`` in the manifest.

Write protocol: everything lands in ``step_X.tmp`` first, then one atomic
``rename`` commits it, so a crashed writer never corrupts the latest
committed checkpoint and :func:`latest_step` sees committed directories
only.  :class:`AsyncCheckpointer` copies the state to host memory on the
caller's thread (the optimizer updates the tensors in place right after)
and writes the files on a daemon thread.

Restore loads the leaves on the host and places them on ``device``: a
checkpoint written on the CPU resumes on the card and the other way round.
A state on a device grid (per-tile trees, ``models.common.shard_tree``) is
saved whole (``save(..., specs=, grid=)`` puts the tiles back together), so
a grid checkpoint, a one-device one and the JAX package's are one format;
``restore(..., grid=, specs=)`` cuts each leaf onto a grid by its sanitized
spec, which may be another grid than the one that wrote it: the JAX
package's elastic re-mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten


def _host(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of a tensor or numpy leaf, its dtype's name in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), name
        return t.numpy(), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _whole(tree, specs, grid):
    """``tree`` itself, or with ``grid`` its per-tile trees put back together
    on the host."""
    if grid is None:
        return tree
    from repro_torch.models.common import unshard_tree

    return unshard_tree(tree, specs, grid, device="cpu")


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None, specs=None,
         grid=None) -> str:
    """Synchronous atomic save of ``tree`` (tensors or numpy arrays); returns
    the committed directory.  With ``grid``, ``tree`` is per-tile trees laid
    out by ``specs``, written whole."""
    tree = _whole(tree, specs, grid)
    return _write(ckpt_dir, step, [_host(x) for x in tree_leaves(tree)], extra)


def _write(ckpt_dir: str, step: int, leaves: list, extra: dict | None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "n_leaves": len(leaves), "extra": extra or {}, "leaves": []}
    for i, (arr, dtype) in enumerate(leaves):
        path = f"leaf_{i:06d}.npy"
        np.save(os.path.join(tmp, path), arr)
        manifest["leaves"].append({"path": path, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


class AsyncCheckpointer:
    """Fire-and-forget saves on a daemon thread; at most one in flight."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, ckpt_dir: str, step: int, tree, *, extra: dict | None = None, specs=None,
             grid=None) -> None:
        self.wait()
        # the host copy on the caller's thread: the tensors change right after
        leaves = [_host(x) for x in tree_leaves(_whole(tree, specs, grid))]

        def work():
            try:
                _write(ckpt_dir, step, leaves, extra)
            except BaseException as e:  # surfaced at the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
        and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _load(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, template, *, device=None, grid=None, specs=None):
    """Load a checkpoint into the structure of ``template``.

    ``template`` (e.g. a freshly initialized state, or one on ``meta``) fixes
    the tree's structure and each leaf's whole shape and dtype; leaves are
    placed on ``device`` (by default the template leaf's own device) as new
    tensors, floating ones requiring grad where the template's do.  With
    ``grid`` and ``specs`` (the state's sanitized specs on that grid) the
    leaves are cut onto the grid instead: the tree comes back as per-tile
    trees.  Returns (tree, extra, step).
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    t_leaves = tree_leaves(template)
    if len(t_leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template has {len(t_leaves)}")
    leaves = []
    for entry, tl in zip(manifest["leaves"], t_leaves):
        if list(tl.shape) != entry["shape"]:
            raise ValueError(f"{entry['path']}: shape {entry['shape']} in the checkpoint, "
                             f"{list(tl.shape)} in the template")
        t = _load(os.path.join(d, entry["path"]), entry["dtype"])
        dev = "cpu" if grid is not None else device if device is not None else tl.device
        t = t.to(device=dev, dtype=tl.dtype)
        leaves.append(t.requires_grad_(True) if tl.requires_grad else t)
    tree = tree_unflatten(template, leaves)
    if grid is not None:
        from repro_torch.models.common import shard_tree

        tree = shard_tree(tree, specs, grid)
    return tree, manifest["extra"], manifest["step"]
