"""Precision policy validation (utils/precision.py).

The default solve is f64 with an f32 V-cycle on every backend.  The f32
solve stays selectable; these tests run it on the CPU against the f64
oracle to bound its accuracy cost.
"""

import jax.numpy as jnp
import numpy as np

from ddpca_admm.admm.loop import contact_analysis
from ddpca_admm.admm.problem import build_problem
from ddpca_admm.models.block import BlockConfig, build_block_model
from ddpca_admm.utils.precision import cast_pytree, floor_rtol, solve_dtype


def _solve(dtype):
    cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(cfg)
    prob, meta = build_problem(
        model.systems, model.regions,
        dole=[0] * len(model.systems), dtype=dtype,
    )
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=3000)
    return st, meta


def test_f32_matches_f64_solution():
    st64, _ = _solve(jnp.float64)
    st32, _ = _solve(jnp.float32)
    assert bool(st64.converged)
    assert bool(st32.converged)
    u64 = np.asarray(st64.u)
    u32 = np.asarray(st32.u, dtype=np.float64)
    ref = np.abs(u64).max()
    # f32 inner solves floor at ~40*eps*||b|| and the convergence criterion
    # is floored at (100*eps)^2 (stops a few ADMM iterations earlier), so the
    # fixed point shifts by O(1e-4) relative.  Engineering oracles (patch
    # test stress, Hertz p_max) tolerate far more (percent level).
    assert np.abs(u32 - u64).max() <= 3e-4 * ref


def test_f32_problem_dtypes():
    cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(cfg)
    prob, _ = build_problem(
        model.systems, model.regions,
        dole=[0] * len(model.systems), dtype=jnp.float32,
    )
    assert prob.cons_forc.dtype == jnp.float32
    # A_top may be Ell/BlockEll/BatchBlocks(Dia) — all expose .dtype
    assert jnp.dtype(prob.mg.A_top.dtype) == jnp.float32
    for g in prob.groups:
        assert g.Bp.vals.dtype == jnp.float32
        assert g.body_idx.dtype == jnp.int32   # ints untouched
    if prob.coarse:
        for co in prob.coarse:
            assert co.inv.dtype == jnp.float32


def test_floor_rtol():
    assert floor_rtol(1e-14, jnp.float64) == 1e-14
    assert floor_rtol(1e-14, jnp.float32) > 1e-6


def test_cast_pytree_preserves_ints():
    tree = {"a": jnp.zeros(3, jnp.float64), "b": jnp.zeros(3, jnp.int32),
            "c": 7, "d": np.zeros(2)}
    out = cast_pytree(tree, jnp.float32)
    assert out["a"].dtype == jnp.float32
    assert out["b"].dtype == jnp.int32
    assert out["c"] == 7
    assert out["d"].dtype == jnp.float32


def test_solve_dtype_explicit_override():
    assert solve_dtype(jnp.float32) == jnp.dtype(jnp.float32)
    # on the CPU test backend the default is f64
    assert solve_dtype() == jnp.dtype(jnp.float64)


def test_gpu_backend_defaults(monkeypatch):
    """The GPU gets the CPU's policy: an f64 solve and plain ELL."""
    import jax

    from ddpca_admm.sparse.bell import use_block_format

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("DDPCA_SOLVE_DTYPE", raising=False)
    monkeypatch.delenv("DDPCA_SPARSE_FORMAT", raising=False)
    assert solve_dtype() == jnp.dtype(jnp.float64)
    assert not use_block_format()
    monkeypatch.setenv("DDPCA_SPARSE_FORMAT", "bell")
    assert use_block_format()
    monkeypatch.setenv("DDPCA_SOLVE_DTYPE", "f32")
    assert solve_dtype() == jnp.dtype(jnp.float32)
