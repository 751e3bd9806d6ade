"""The int8 codecs and the cross-pod error-feedback sync against the JAX package's.

Tolerances:

- ``quantize_int8`` / ``dequantize_int8``: bitwise (q, the scale and the
  dequantized values), over seeds, scales and lengths that include the
  float32 edge where the JAX package's dequantized error exceeds half a
  step by one ulp (scale 105.86, n=24, seed 691): the port gives the same
  bits there, not a smaller error;
- ``compressed_pod_allreduce`` on a 2x2x2 CPU grid against the JAX function
  in full-manual ``shard_map`` on ``mesh_pod``: synced gradients and
  residuals within 1e-6 (both quantize the same fp32 sums with the same
  codec; the pods' mean is one add and one divide).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.tiles import shard_map
from repro.training.train_step import compressed_pod_allreduce as j_sync
from repro.training.train_step import dequantize_int8 as j_deq
from repro.training.train_step import quantize_int8 as j_quant
from repro_torch.core import collectives as coll
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.training.train_step import compressed_pod_allreduce as t_sync
from repro_torch.training.train_step import dequantize_int8 as t_deq
from repro_torch.training.train_step import quantize_int8 as t_quant

EDGE = (105.86, 24, 691)  # the JAX package's one-ulp edge (ROADMAP.md standing notes)


@pytest.mark.parametrize("scale,n,seed", [EDGE, (1e-6, 4, 0), (0.37, 257, 3), (1e4, 64, 11),
                                          (1.0, 256, 999), (3.3e-3, 5, 42)])
def test_int8_codecs_bitwise_jax(scale, n, seed):
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32) * scale
    jq, js = j_quant(jnp.asarray(x))
    tq, ts = t_quant(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd, td = np.asarray(j_deq(jq, js)), t_deq(tq, ts).numpy()
    assert td.tobytes() == jd.tobytes()


def test_int8_edge_matches_jax_not_tighter():
    """At the edge the JAX package's error is one ulp over half a step; the
    port's is the same value, bit for bit."""
    scale, n, seed = EDGE
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32) * scale
    jq, js = j_quant(jnp.asarray(x))
    tq, ts = t_quant(torch.from_numpy(x))
    j_err = float(jnp.max(jnp.abs(j_deq(jq, js) - x)))
    t_err = float(torch.max(torch.abs(t_deq(tq, ts) - torch.from_numpy(x))))
    assert t_err == j_err
    assert t_err > float(ts) * 0.5  # the edge itself: over half a step


def _jax_sync(mesh_pod, g, e):
    """JAX's sync in full-manual shard_map: pod p's devices hold row p."""
    def f(gg, ee):
        return j_sync(gg, ee, axis="pod")

    spec = ({"w": P("pod", None)}, {"w": P("pod", None)})
    return jax.jit(shard_map(f, mesh=mesh_pod, in_specs=spec, out_specs=spec, check=False))(
        {"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})


def _port_sync(grid, g, e):
    """The same on the port's 2x2x2 CPU grid: each pod's four tiles hold its row."""
    pods = grid.shape["pod"]
    per = grid.n_tiles // pods
    gt = [{"w": torch.from_numpy(g[t // per: t // per + 1].copy())} for t in range(grid.n_tiles)]
    et = [{"w": torch.from_numpy(e[t // per: t // per + 1].copy())} for t in range(grid.n_tiles)]
    return t_sync(gt, et, grid)


@pytest.mark.parametrize("seed", [0, 7])
def test_compressed_pod_allreduce_matches_jax(mesh_pod, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(2, 64)).astype(np.float32)
    e = np.zeros((2, 64), np.float32)
    grid = make_cpu_mesh(2, 2, pod=2)
    for _ in range(2):  # the second round carries the first's residuals
        jout, jef = _jax_sync(mesh_pod, g, e)
        tout, tef = _port_sync(grid, g, e)
        jo, je = np.asarray(jout["w"]), np.asarray(jef["w"])
        for t in range(grid.n_tiles):
            p = t // 4
            np.testing.assert_allclose(tout[t]["w"].numpy()[0], jo[p], rtol=0, atol=1e-6)
            np.testing.assert_allclose(tef[t]["w"].numpy()[0], je[p], rtol=0, atol=1e-6)
        # every pod holds the mean of the pods' dequantized rows, within int8 error
        np.testing.assert_allclose(jo[0], g.mean(axis=0), atol=0.05)
        e = je
        g = rng.normal(size=(2, 64)).astype(np.float32)


def test_pod_sync_counts_int8_bytes():
    """One leaf of 64 fp32 a tile on 2x2x2: each tile's 64 int8 values and
    its scale reach the other pod (8 x (64 + 4) bytes), and the pod's
    amax moves 4 bytes between each pair of its four tiles (2 x 4 x 3 x 4)."""
    grid = make_cpu_mesh(2, 2, pod=2)
    g = [{"w": torch.randn(1, 64, generator=torch.Generator().manual_seed(t))} for t in range(8)]
    e = [{"w": torch.zeros(1, 64)} for _ in range(8)]
    before = coll.lm_moves()["lm.pod"]
    t_sync(g, e, grid)
    after = coll.lm_moves()["lm.pod"]
    assert after["reduce_bytes"] - before["reduce_bytes"] == 8 * (64 + 4) + 2 * 4 * 3 * 4
