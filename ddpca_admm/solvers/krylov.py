"""Batched Krylov solvers (CG / BiCGSTAB / GMRES) under jit.

Reference: MGPIS.h:163-225 (PCG, Shewchuk formulation, tol 1e-14*||b||),
:350-432 (preconditioned BiCGSTAB, tol 1e-14*||b||), :227-348 (restarted
GMRES(10), tol 1e-12*||b||).  Re-design: every solver runs a
``lax.while_loop`` over a *batch* of systems simultaneously; converged batch
lanes are frozen by masking so the loop exits when the slowest lane is done.
Preconditioners are passed as callables (multigrid V-cycle or Jacobi).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import (
    BICGSTAB_RTOL,
    CG_RTOL,
    GMRES_RESTART,
    GMRES_RTOL,
)


def _dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return (a * b).sum(axis=-1)


class CgResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    res_norm: jnp.ndarray


def pcg(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    precond: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    rtol: float = CG_RTOL,
    atol: float = 0.0,
    maxiter: int = 1000,
) -> CgResult:
    """Preconditioned CG over a batch: b (..., n); batch lanes converge
    independently (per-lane tolerance rtol*||b||, MGPIS.h:175)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    tol = jnp.maximum(rtol * jnp.sqrt(_dot(b, b)), atol)

    r0 = b - matvec(x0)
    d0 = precond(r0)
    delta0 = _dot(r0, d0)
    res0 = jnp.sqrt(_dot(r0, r0))
    stall0 = jnp.zeros(b.shape[:-1], jnp.int32)

    # stagnation exit (reference MGPIS stagnation monitors, MGPIS.h:141-155):
    # a lane that hasn't improved its best residual by >0.1% for STALL_LIMIT
    # iterations is frozen (preconditioner floor reached).
    STALL_LIMIT = 25

    def lane_active(r, best, stall):
        return (jnp.sqrt(_dot(r, r)) > tol) & (stall < STALL_LIMIT)

    def cond(state):
        x, r, d, delta, best, stall, it = state
        return jnp.logical_and(it < maxiter, jnp.any(lane_active(r, best, stall)))

    def body(state):
        x, r, d, delta, best, stall, it = state
        active = lane_active(r, best, stall)[..., None]
        q = matvec(d)
        dq = _dot(d, q)
        alpha = jnp.where(dq != 0.0, delta / jnp.where(dq == 0.0, 1.0, dq), 0.0)
        x = jnp.where(active, x + alpha[..., None] * d, x)
        r_new = jnp.where(active, r - alpha[..., None] * q, r)
        s = precond(r_new)
        delta_new = _dot(r_new, s)
        beta = jnp.where(
            delta != 0.0, delta_new / jnp.where(delta == 0.0, 1.0, delta), 0.0
        )
        d = jnp.where(active, s + beta[..., None] * d, d)
        rn = jnp.sqrt(_dot(r_new, r_new))
        improved = rn < 0.999 * best
        best = jnp.minimum(best, rn)
        stall = jnp.where(improved, 0, stall + 1)
        return x, r_new, d, delta_new, best, stall, it + 1

    x, r, d, delta, best, stall, it = jax.lax.while_loop(
        cond, body, (x0, r0, d0, delta0, res0, stall0, jnp.zeros((), jnp.int32))
    )
    return CgResult(x=x, iters=it, res_norm=jnp.sqrt(_dot(r, r)))


def bicgstab(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    precond: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    rtol: float = BICGSTAB_RTOL,
    maxiter: int = 2000,
) -> CgResult:
    """Right-preconditioned BiCGSTAB (MGPIS.h:350-432 semantics), batched."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    tol = rtol * jnp.sqrt(_dot(b, b))
    r0 = b - matvec(x0)
    rhat = r0

    def cond(state):
        x, r, p, v, rho, alpha, omega, it = state
        return jnp.logical_and(it < maxiter, jnp.any(jnp.sqrt(_dot(r, r)) > tol))

    def body(state):
        x, r, p, v, rho, alpha, omega, it = state
        active = (jnp.sqrt(_dot(r, r)) > tol)[..., None]
        rho_new = _dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = jnp.where(
            active, r + beta[..., None] * (p - omega[..., None] * v), p
        )
        phat = precond(p)
        v_new = matvec(phat)
        alpha_new = rho_new / _nz(_dot(rhat, v_new))
        s = r - alpha_new[..., None] * v_new
        shat = precond(s)
        t = matvec(shat)
        omega_new = _dot(t, s) / _nz(_dot(t, t))
        x = jnp.where(
            active,
            x + alpha_new[..., None] * phat + omega_new[..., None] * shat,
            x,
        )
        r = jnp.where(active, s - omega_new[..., None] * t, r)
        v = jnp.where(active, v_new, v)
        return x, r, p, v, rho_new, alpha_new, omega_new, it + 1

    ones = jnp.ones(b.shape[:-1], b.dtype)
    x, r, *_, it = jax.lax.while_loop(
        cond,
        body,
        (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), ones, ones, ones,
         jnp.zeros((), jnp.int32)),
    )
    return CgResult(x=x, iters=it, res_norm=jnp.sqrt(_dot(r, r)))


def _nz(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(x == 0.0, 1.0, x)


def gmres(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    precond: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    rtol: float = GMRES_RTOL,
    restart: int = GMRES_RESTART,
    max_restarts: int = 200,
) -> CgResult:
    """Left-preconditioned restarted GMRES(restart) (MGPIS::GMRES_SOLV,
    MGPIS.h:227-348: restart 10, tol 1e-12*||b||), batched over leading axes.

    Each restart cycle runs a fixed-size Arnoldi factorization (static shapes
    for XLA) and solves the small least-squares problem with a dense QR on
    device; outer restarts iterate in a while_loop until every batch lane
    meets its tolerance."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    tol = rtol * jnp.sqrt(_dot(b, b))
    batch = b.shape[:-1]
    n = b.shape[-1]

    def cycle(x):
        r = b - matvec(x)
        z = precond(r)
        beta = jnp.sqrt(_dot(z, z))
        v0 = z / _nz(beta)[..., None]
        V = jnp.zeros(batch + (restart + 1, n), b.dtype)
        V = V.at[..., 0, :].set(v0)
        H = jnp.zeros(batch + (restart + 1, restart), b.dtype)

        def arnoldi(carry, j):
            V, H = carry
            w = precond(matvec(V[..., j, :]))
            # modified Gram-Schmidt against all columns (masked j+1..)
            def mgs(w_h, i):
                w, hcol = w_h
                hij = jnp.where(i <= j, (V[..., i, :] * w).sum(-1), 0.0)
                w = w - hij[..., None] * V[..., i, :]
                return (w, hcol.at[..., i].set(hij)), None

            (w, hcol), _ = jax.lax.scan(
                mgs, (w, jnp.zeros(batch + (restart + 1,), b.dtype)),
                jnp.arange(restart),
            )
            hnext = jnp.sqrt(_dot(w, w))
            hcol = hcol.at[..., j + 1].set(hnext)
            V = V.at[..., j + 1, :].set(w / _nz(hnext)[..., None])
            H = H.at[..., :, j].set(hcol)
            return (V, H), None

        (V, H), _ = jax.lax.scan(arnoldi, (V, H), jnp.arange(restart))
        # least squares: min || beta e1 - H y ||
        e1 = jnp.zeros(batch + (restart + 1,), b.dtype)
        e1 = e1.at[..., 0].set(beta)
        # batched least squares via normal equations (H is (restart+1) x
        # restart and well conditioned at these sizes)
        HtH = jnp.einsum("...ij,...ik->...jk", H, H)
        Hte = jnp.einsum("...ij,...i->...j", H, e1)
        HtH = HtH + 1e-30 * jnp.eye(restart, dtype=b.dtype)
        y = jnp.linalg.solve(HtH, Hte[..., None])[..., 0]
        dx = jnp.einsum("...jn,...j->...n", V[..., :restart, :], y)
        return x + dx

    def cond(state):
        x, it = state
        r = b - matvec(x)
        return jnp.logical_and(
            it < max_restarts, jnp.any(jnp.sqrt(_dot(r, r)) > tol)
        )

    def body(state):
        x, it = state
        return cycle(x), it + 1

    x, it = jax.lax.while_loop(cond, body, (x0, jnp.zeros((), jnp.int32)))
    r = b - matvec(x)
    return CgResult(x=x, iters=it, res_norm=jnp.sqrt(_dot(r, r)))


def jacobi_preconditioner(diag: jnp.ndarray) -> Callable[[jnp.ndarray], jnp.ndarray]:
    inv = jnp.where(diag != 0.0, 1.0 / jnp.where(diag == 0.0, 1.0, diag), 1.0)
    return lambda r: inv * r
