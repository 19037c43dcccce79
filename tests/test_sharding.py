"""Multi-chip correctness: an 8-device 'domain'-sharded run must reproduce
the single-device solution (the multi-device analogue of the reference's DD-vs-noDD
oracle, and the actual correctness contract of MCONTACT.h:2511-2704's
shared-memory consensus when split across chips)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddpca_admm.admm.loop import admm_step, contact_analysis, init_state
from ddpca_admm.models.simple import chain_problem
from ddpca_admm.parallel.sharding import (
    assert_state_sharding,
    domain_mesh,
    shard_problem,
    shard_state,
)


@pytest.fixture(scope="module")
def chain8():
    return chain_problem(n_bodies=8, div=2, levels=0)


def test_eight_devices_match_single_device(chain8):
    prob, meta, _ = chain8
    modes = tuple(meta.group_modes)
    st1 = contact_analysis(prob, modes, max_iter=600)
    assert bool(st1.converged)

    mesh = domain_mesh(8)
    probs = shard_problem(prob, mesh)
    sts = contact_analysis(probs, modes, max_iter=600)
    assert bool(sts.converged)
    # same solution to solver tolerance (f64 on CPU: 1e-12 criteria)
    scale = float(jnp.abs(st1.u).max())
    np.testing.assert_allclose(
        np.asarray(sts.u), np.asarray(st1.u), atol=1e-9 * scale
    )
    assert int(sts.it) == int(st1.it)


def test_host_domain_mesh_matches_single_device(chain8):
    """2-axis (host, domain) = (2, 4) mesh: the DCN/ICI hierarchy placement
    (parallel/sharding.py::host_domain_mesh) must reproduce the single-device
    solution and iteration count exactly."""
    from ddpca_admm.parallel.sharding import host_domain_mesh

    prob, meta, _ = chain8
    modes = tuple(meta.group_modes)
    st1 = contact_analysis(prob, modes, max_iter=600)
    mesh = host_domain_mesh(2, 4)
    probs = shard_problem(prob, mesh)
    st0 = shard_state(init_state(probs), probs, mesh)
    sts = contact_analysis(probs, modes, max_iter=600, state0=st0)
    assert bool(sts.converged)
    scale = float(jnp.abs(st1.u).max())
    np.testing.assert_allclose(
        np.asarray(sts.u), np.asarray(st1.u), atol=1e-9 * scale
    )
    assert int(sts.it) == int(st1.it)
    assert_state_sharding(sts, mesh)


def test_step_preserves_designed_sharding(chain8):
    prob, meta, _ = chain8
    mesh = domain_mesh(8)
    probs = shard_problem(prob, mesh)
    state = shard_state(init_state(probs), probs, mesh)
    state = admm_step(probs, state, tuple(meta.group_modes))
    jax.block_until_ready(state)
    assert_state_sharding(state, mesh)


def test_indivisible_body_count_raises():
    prob, meta, _ = chain_problem(n_bodies=3, div=2, levels=0)
    mesh = domain_mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        shard_problem(prob, mesh)
