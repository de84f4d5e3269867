"""The port's multi-process layer (``parallel/multihost.py``), run for real.

``launch_localhost_cluster`` spawns a 2-rank gloo cluster on localhost (one
process a rank, wired through ``initialize_multihost`` over tcp://), which
runs the chains-sharded and the data-sharded HMC self-tests over the global
mesh.  The gathered traces must match the port's unsharded runs of the
same problem in this process: the chains bit for bit, the data-summed run
within 1e-5 (the all-reduce reassociates the likelihood's sum), the JAX
package's tolerance class for its own cluster (tests/test_multihost.py).
"""

import numpy as np
import pytest
import torch

import hamiltorch_tpu_torch as tht
from hamiltorch_tpu_torch.parallel import multihost as mh

LAUNCH_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def cluster():
    return mh.launch_localhost_cluster(num_processes=2, devices_per_process=1,
                                       timeout=LAUNCH_TIMEOUT, device="cpu")


def test_cluster_wiring(cluster):
    infos = cluster["infos"]
    assert sorted(i["process_index"] for i in infos) == [0, 1]
    for info in infos:
        assert info["process_count"] == 2
        assert info["global_devices"] == 2
        assert info["local_devices"] == 1


def test_two_process_cluster_matches_the_single_process_runs(cluster):
    lp, loglik, prior, x, y, cfg_chains, cfg_psum = mh.selftest_problem("cpu")
    keys = mh.selftest_keys()
    chains = tht.run_hmc_chains(keys["chains"], lp, torch.zeros(3), cfg_chains,
                                mh.SELFTEST_CHAINS).samples.numpy()
    psum = tht.run_hmc_chains(keys["psum"], lambda t: prior(t) + loglik(t, x, y), torch.zeros(3),
                              cfg_psum, 1).samples.numpy()
    assert cluster["traces"]["chains"].shape == (8, 12, 3)
    assert cluster["traces"]["psum"].shape == (1, 12, 3)
    np.testing.assert_array_equal(cluster["traces"]["chains"], chains)
    np.testing.assert_allclose(cluster["traces"]["psum"], psum, rtol=0, atol=1e-5)
    assert np.isfinite(psum).all() and np.abs(psum).max() > 0.1


def test_single_process_needs_no_group():
    """Without a coordinator or more than one process it is a no-op."""
    import torch.distributed as dist

    info = mh.initialize_multihost()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="1 devices not divisible by data=2"):
        mh.global_chain_mesh(data_parallelism=2, device="cpu")


def test_a_cluster_on_the_cards_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mh.launch_localhost_cluster(num_processes=2, devices_per_process=1)
