"""On-card tests of the port's CUDA kernels (``cuda`` marker; skip without a card).

This file imports neither JAX nor the JAX package, so it runs on the card's
machine too:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
inputs; tolerances are tests/test_kernels.py's.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import cad_score as cad
from repro_torch.kernels import edge_projection as ep
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from repro_torch import resolve_device

    kernels.reset_launch_counts()
    return resolve_device("cuda")


def _arr(rng, shape, dev, positive=False):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(np.abs(x) if positive else x).to(dev)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (129, 130, 131), (300, 77, 170)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_matmul_kernel(dev, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a, b = _arr(rng, (m, k), dev).to(dtype), _arr(rng, (k, n), dev).to(dtype)
    got = bm.block_matmul(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, ref.block_matmul(a, b, out_dtype=torch.float32),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(got, bm.block_matmul(a, b, out_dtype=torch.float32))
    assert kernels.launch_counts()["block_matmul"] == 2


@pytest.mark.parametrize("n,k", [(257, 17), (100, 40)])
def test_edge_projection_kernel(dev, n, k):
    a = _arr(np.random.default_rng(n), (n, n), dev, positive=True)
    torch.testing.assert_close(ep.edge_projection(a, seed=7, k=k),
                               ref.edge_projection(a, seed=7, k=k), rtol=1e-5, atol=1e-4)
    assert kernels.launch_counts()["edge_projection"] == 1


def test_in_kernel_rademacher_field_is_bitwise(dev):
    from repro_torch.core import rng

    for seed in (0, 2**31, 2**32 - 1):
        q = ep.rademacher_field(seed, range(90, 130), range(100, 140), 17)
        want = rng.edge_rademacher(
            seed, torch.arange(90, 130, device=dev)[:, None, None],
            torch.arange(100, 140, device=dev)[None, :, None],
            torch.arange(17, device=dev)[None, None, :])
        assert torch.equal(q, want)


@pytest.mark.parametrize("n,k", [(200, 17), (97, 33)])
def test_cad_scores_kernel(dev, n, k):
    rng = np.random.default_rng(n)
    a1, a2 = _arr(rng, (n, n), dev, positive=True), _arr(rng, (n, n), dev, positive=True)
    z1, z2 = _arr(rng, (n, k), dev), _arr(rng, (n, k), dev)
    got = cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5)
    torch.testing.assert_close(got, ref.cad_scores(a1, a2, z1, z2, 10.0, 12.5),
                               rtol=1e-4, atol=1e-2)
    assert torch.equal(got, cad.cad_scores(a1, a2, z1, z2, 10.0, 12.5))


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    a = torch.zeros((64, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        bm.block_matmul(a.T, a)
    z = torch.zeros((64, 65), device=dev)
    with pytest.raises(ValueError, match="k=65"):
        cad.cad_scores(a, a, z, z, 1.0, 1.0)
    assert kernels.launch_counts() == {"block_matmul": 0, "edge_projection": 0, "cad_scores": 0}


def test_sequence_on_card_matches_cpu(dev):
    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import gmm_snapshot_sequence

    cfg = CommuteConfig(d=6, q=10)
    runs = {}
    for d in ("cuda", "cpu"):
        seq = gmm_snapshot_sequence(256, 3, seed=4, inject_p=0.02, device=d)
        runs[d] = SequenceDetector(cfg, top_k=10, device=d).run(seq.snapshots())
    assert kernels.launch_counts() == {"block_matmul": 33, "edge_projection": 3, "cad_scores": 2}
    for g, c in zip(runs["cuda"].transitions, runs["cpu"].transitions):
        s_c = c.scores.numpy()
        np.testing.assert_allclose(g.scores.cpu().numpy(), s_c, rtol=1e-3,
                                   atol=1e-3 * np.abs(s_c).max())
        assert g.top_idx.tolist() == c.top_idx.tolist()
