"""The port's chain product and resident solver against the JAX package.

The same numpy adjacency goes to both packages.  Tolerances:

* chain operator (P1, P2, deg, vol, rho): rtol 1e-4, with an absolute floor
  of 1e-4 x the largest entry for matrices whose entries cross zero;
* solver: the port runs from the JAX-built operator (through ``interop``);
  iteration counts within +/-1 of the JAX while_loop's, solutions within
  1e-4 x max|y| for fixed-q runs (same step count, same arithmetic) and
  1e-3 x max|y| for tolerance-targeted runs (either side may stop one step
  apart at the 1e-5 target).
"""

import numpy as np
import pytest
import torch

from repro.core import chain_product as j_chain_product
from repro.core import solve as j_solve
from repro.core.solvers import SolverSpec as JSpec
from repro.graphs import gmm_graph_sequence
from repro_torch.core import chain_product, laplacian
from repro_torch.core.solvers import METHODS, SolverSpec, solve
from repro_torch.interop import chain_operator_from_numpy


def _adj(ctx, n, seed=0) -> np.ndarray:
    """GMM similarity graph (well-separated clusters: the solve needs iterations)."""
    return np.array(gmm_graph_sequence(ctx, n=n, seed=seed).a1)


def _close(got, want, rtol, scale_tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_tol * np.abs(want).max())


@pytest.mark.parametrize("n", [64, 96])
@pytest.mark.parametrize("d", [3, 6])
def test_chain_product_matches_jax(ctx1, n, d):
    a = _adj(ctx1, n, seed=n)
    jop = j_chain_product(ctx1, ctx1.put_matrix(a), d, schedule="xla")
    op = chain_product(torch.from_numpy(a), d)
    _close(op.p1.numpy(), jop.p1, 1e-4, 1e-4)
    _close(op.p2.numpy(), jop.p2, 1e-4, 1e-4)
    _close(op.deg.numpy(), jop.deg, 1e-4, 0)
    _close(float(op.vol), float(jop.vol), 1e-4, 0)
    assert op.rho == pytest.approx(jop.rho, rel=1e-4, abs=1e-6)


def test_fuse_l_matches_materialized_laplacian(ctx1):
    a = torch.from_numpy(_adj(ctx1, 64))
    op = chain_product(a, 4)
    fused = chain_product(a, 4, fuse_l=True)
    _close(fused.p2.numpy(), op.p2.numpy(), 1e-4, 1e-5)


@pytest.mark.parametrize("d", [1, 3, 6])
@pytest.mark.parametrize("deflate", [True, False])
def test_telescoping_identity(d, deflate):
    """(I - S) P == I - S^(2^d), with P = D^{1/2} P1 D^{1/2} from the port's operator."""
    rng = np.random.default_rng(40 + d)
    a = np.abs(rng.normal(size=(32, 32))).astype(np.float32)
    a = (a + a.T) / 2
    np.fill_diagonal(a, 0.0)
    op = chain_product(torch.from_numpy(a), d, deflate=deflate)
    s = laplacian.normalized_adjacency(
        torch.from_numpy(a).double(), torch.from_numpy(a).double().sum(1), deflate=deflate,
        dtype=torch.float64,
    ).numpy()
    sq = np.sqrt(op.deg.double().numpy())
    p = sq[:, None] * op.p1.double().numpy() * sq[None, :]
    eye = np.eye(32)
    # fp32 chain vs float64 model: the error grows with the 2(d-1) GEMM depth
    np.testing.assert_allclose((eye - s) @ p, eye - np.linalg.matrix_power(s, 2**d),
                               rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module")
def jax_operator(ctx1):
    a = _adj(ctx1, 64)
    jop = j_chain_product(ctx1, ctx1.put_matrix(a), 6, schedule="xla")
    b = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    b -= b.mean(0, keepdims=True)
    return jop, b


def _both(ctx1, jop, b, spec_kw, fixed_q, y0=None):
    jy, jrep = j_solve(ctx1, jop, ctx1.put_rowblock(b), JSpec(**spec_kw), fixed_q=fixed_q,
                       y0=None if y0 is None else ctx1.put_rowblock(y0))
    op = chain_operator_from_numpy(np.asarray(jop.p1), np.asarray(jop.p2), np.asarray(jop.deg),
                                   np.asarray(jop.vol), jop.rho, device="cpu")
    ty, trep = solve(op, torch.from_numpy(b), SolverSpec(**spec_kw), fixed_q=fixed_q,
                     y0=None if y0 is None else torch.from_numpy(y0))
    return np.asarray(jy), jrep, ty.numpy(), trep


@pytest.mark.parametrize("method", METHODS)
def test_solver_fixed_q_matches_jax(ctx1, jax_operator, method):
    jop, b = jax_operator
    jy, jrep, ty, trep = _both(ctx1, jop, b, {"method": method}, fixed_q=8)
    assert trep.iterations == jrep.iterations == 7
    _close(ty, jy, 1e-4, 1e-4)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("warm", [False, True])
def test_solver_to_tolerance_matches_jax(ctx1, jax_operator, method, warm):
    jop, b = jax_operator
    y0 = None
    if warm:  # a nearby earlier solution, as a drifting sequence hands over
        cold, _, _, _ = _both(ctx1, jop, b, {"method": method, "tolerance": 1e-5}, None)
        y0 = (cold * 1.01 + 1e-3).astype(np.float32)
    spec = {"method": method, "tolerance": 1e-5}
    jy, jrep, ty, trep = _both(ctx1, jop, b, spec, None, y0=y0)
    assert jrep.converged and trep.converged
    assert abs(trep.iterations - jrep.iterations) <= 1, (trep.iterations, jrep.iterations)
    assert trep.warm_start == warm
    _close(ty, jy, 1e-3, 1e-3)
    if method == "chebyshev":
        assert trep.rho_final == pytest.approx(jrep.rho_final, rel=1e-3)


def test_zero_iteration_budget_reports_no_residual(jax_operator):
    jop, b = jax_operator
    op = chain_operator_from_numpy(np.asarray(jop.p1), np.asarray(jop.p2), np.asarray(jop.deg),
                                   np.asarray(jop.vol), jop.rho, device="cpu")
    y, rep = solve(op, torch.from_numpy(b), SolverSpec(max_iters=0))
    assert rep.iterations == 0 and not rep.converged and np.isnan(rep.residual)


def test_residual_ring_unrotates_past_cap():
    from repro_torch.core.solvers.driver import _unrotate_hist

    hist = np.arange(8, dtype=np.float32)
    assert _unrotate_hist(hist, 5) == [0, 1, 2, 3, 4]
    # 11 steps into a cap-8 ring: steps 3..10 survive, oldest at index 11 % 8 = 3
    ring = np.array([8, 9, 10, 3, 4, 5, 6, 7], np.float32)
    assert _unrotate_hist(ring, 11) == [3, 4, 5, 6, 7, 8, 9, 10]


def test_solver_rejects_mismatched_warm_start(jax_operator):
    jop, b = jax_operator
    op = chain_operator_from_numpy(np.asarray(jop.p1), np.asarray(jop.p2), np.asarray(jop.deg),
                                   np.asarray(jop.vol), jop.rho, device="cpu")
    with pytest.raises(ValueError, match="warm start"):
        solve(op, torch.from_numpy(b), y0=torch.zeros((64, 3)))


def test_chain_counts_builds_and_gemm_cost():
    from repro_torch.core import chain_build_count
    from repro_torch.obs import REGISTRY

    a = torch.rand((16, 16))
    a = (a + a.T) / 2
    a.fill_diagonal_(0.0)
    b0, f0 = chain_build_count(), REGISTRY.value("chain.gemm_flops")
    chain_product(a, 3)
    assert chain_build_count() == b0 + 1
    assert REGISTRY.value("chain.gemm_flops") - f0 == 5 * 2.0 * 16**3
