"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card. This file
imports neither JAX nor the JAX package — the GPU host has no JAX — so it
runs there without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

from tpu_joints_torch.neighbors import pallas_knn as k1
from tpu_joints_torch.neighbors.bruteforce import knn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 2560, 0.0), (40960, 2048, 0.0),
                                   (70, 100, 0.25), (5000, 3333, 0.1),
                                   (64, 256, 1.0)])
def test_nn1_kernel_matches_plain_on_card(shape):
    """The CUDA kernel equals its plain version bit for bit, at the main
    path's ICP and coverage shapes and at the edge cases (masked sources,
    a source count off the tile, no valid source)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, N, masked = shape
    rng = np.random.default_rng(M + N)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.normal(size=(M, 3)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.uniform(size=N) >= masked).to(dev)
    before = k1.nn1.launches
    d, i = knn(q, s, 1, source_mask=m)      # the main path's entry to K1
    assert k1.nn1.launches == before + 1
    dr, ir = k1.nn1_reference(q, s, m)
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    assert torch.equal(d, dr)
    if masked == 1.0:
        assert bool((d >= 1e30).all()) and bool((i == 0).all())


@pytest.mark.cuda
def test_nn1_rejects_cpu_mask_with_cuda_points():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(4, 3, device="cuda")
    with pytest.raises(ValueError):
        k1.nn1(q, q, torch.ones(4, dtype=torch.bool))
