"""Port parity, organized ingest: tile selection, box-filtered moments and
moment normals of ``ingest_organized_blocks`` on a 320×240 raycast frame
(block 2, half-window 3), JAX package vs port on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_segment_organized import _raycast_frame
from tpu_joints.features import organized as jorg
from tpu_joints.pipelines.ingest import ingest_organized_blocks as jingest
from tpu_joints_torch.features import organized as torg
from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks as tingest

LO = np.array([-0.45, -0.5, 0.5], np.float32)
HI = np.array([0.5, 0.45, 1.55], np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["joint", "table"])
def frame(request):
    xyz, valid, _ = _raycast_frame(segment_table=request.param)
    return xyz, valid


@pytest.mark.parametrize("capacity", [3072, None])
def test_ingest_organized_blocks_matches(frame, capacity):
    """n_selected, mask and xyz exact; normals and curvature within 1e-4
    (measured 1.8e-7 and 1.1e-7)."""
    xyz, valid = frame
    sj, nj, cj, nsj = jingest(jnp.asarray(xyz), jnp.asarray(valid), block=2,
                              half_window=3, capacity=capacity,
                              crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI))
    st, nt, ct, nst = tingest(torch.from_numpy(xyz), torch.from_numpy(valid),
                              block=2, half_window=3, capacity=capacity,
                              crop_lo=torch.from_numpy(LO),
                              crop_hi=torch.from_numpy(HI))
    assert int(nsj) == int(nst)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-4)


def test_organized_moments_and_covariance_match(frame):
    """Box-filtered moments are bit-equal (each window sums its taps in the
    same order); the covariance, formed as XLA's fused E[ab] − E[a]E[b],
    too."""
    xyz, valid = frame
    Sj, rj = jorg.organized_moments(jnp.asarray(xyz), jnp.asarray(valid), 3)
    St, rt = torg.organized_moments(torch.from_numpy(xyz),
                                    torch.from_numpy(valid), 3)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    S = np.asarray(Sj).reshape(10, -1)[:, valid.reshape(-1)]
    cj = jax.jit(lambda s: jorg._cov_from_moments(s)[0])(jnp.asarray(S))
    ct = torg._cov_from_moments(torch.from_numpy(S))[0]
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
