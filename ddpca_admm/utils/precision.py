"""Precision policy: one policy on every backend.

The reference runs everything in C++ double (Eigen defaults) and checks
convergence at 1e-12-relative squared norms (MCONTACT.h:2733-2760) with inner
Krylov tolerances of 1e-14*||b|| (MGPIS.h:175).

Default: the solve dtype is f64 on every backend (CPU and GPU both have
native f64), so the CPU tests check the arithmetic the GPU runs.  The
multigrid V-cycle is only a preconditioner and runs in f32
(solvers/mg.py); the Krylov residuals, interface updates and monitors are
f64 and keep the reference's tolerances untouched.

An f32 solve remains selectable (``DDPCA_SOLVE_DTYPE=float32`` or an
explicit ``dtype``), validated against the f64 oracle in
tests/test_precision.py.  To make the reference's *relative* criteria
meaningful in f32:
  - monitor norms are computed on per-lane max-normalized vectors, so
    squared norms stay in a comfortable f32 range (no underflow at
    ||du||^2 ~ 1e-24 m^2) and the convergence test is the scale-invariant
    ratio ||du||^2/||u||^2 <= 1e-12;
  - inner Krylov tolerances are floored at ~40*eps(f32)*||b|| — the
    achievable f32 residual floor — with the stall exit as backstop;
    the ADMM outer iteration is a fixed-point map and self-corrects
    inner-solve errors of this size (fixed point shifts O(1e-7) relative,
    far below the engineering tolerances of every example oracle).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def solve_dtype(explicit=None):
    """The device dtype for the ADMM solve path."""
    if explicit is not None:
        return jnp.dtype(explicit)
    env = os.environ.get("DDPCA_SOLVE_DTYPE")
    if env:
        return jnp.dtype({"f32": "float32", "f64": "float64"}.get(env, env))
    return jnp.dtype(jnp.float64)


def floor_rtol(rtol: float, dtype) -> float:
    """Clamp a relative residual tolerance to what ``dtype`` can reach."""
    eps = float(jnp.finfo(dtype).eps)
    return max(float(rtol), 40.0 * eps)


def floor_crit(crit: float, dtype) -> float:
    """Clamp the ADMM convergence criterion (a *squared*-norm ratio,
    MCONTACT.h:2733: ||du||^2 <= crit*||u||^2) to the dtype's floor.

    The inner solves floor at ~40*eps*||b|| residuals, so successive ADMM
    iterates differ by O(100*eps) relative even at the fixed point; the
    squared ratio floors near (100*eps)^2.  For f32 this yields ~1.4e-10
    (||du|| <= ~1.2e-5*||u||) — measured floor on the BLOCK patch problem is
    ~1.4e-11, so this includes a ~10x safety margin against churn at the
    floor.  f64 keeps the reference's 1e-12 untouched.
    """
    eps = float(jnp.finfo(dtype).eps)
    return max(float(crit), (100.0 * eps) ** 2)


def cast_pytree(tree, dtype):
    """Cast every floating-point array leaf of a pytree to ``dtype``.

    Integer/bool arrays (ELL column indices, body indices, masks) and static
    Python leaves pass through untouched.
    """
    dtype = jnp.dtype(dtype)

    def cast(x):
        if isinstance(x, (jnp.ndarray, np.ndarray)) and jnp.issubdtype(
            x.dtype, jnp.floating
        ):
            return jnp.asarray(x, dtype)
        return x

    return jax.tree_util.tree_map(cast, tree)
