"""The jitted ADMM contact-analysis loop (MCONTACT::CONTACT_ANALYSIS).

Reference semantics (MCONTACT.h:2493-2723), re-designed as a single
``lax.while_loop`` whose body runs entirely on device:

  1. x-update: every subdomain solves (K + rho B^T B) u = f + B_p^T z - B^T l
     — batched multigrid-preconditioned CG over the ``domain`` axis
     (replacing the reference's per-subdomain cached LDLT / MG-CG dispatch).
  2. gamma: interface traction trial at integral points + projection
     (max(0,.) for contact, Coulomb cone clip for friction; none for perfect
     interfaces) (MCONTACT.h:2632-2668).
  3. z-update: per region side solve rho M z = B_p^T u + M l + E gamma
     — batched Jacobi-PCG on the interface Gram matrices.
  4. lambda-update: l += M^{-1} (B_p^T u - rho M z).
  5. MONITOR: per-body ||du||^2 <= 1e-12 ||u||^2 and per-side
     ||dz||^2 <= 1e-12 ||z||^2, full-space norms via the Gram trick
     (MCONTACT.h:2725-2845); oscillation bookkeeping for freezing the coarse
     correction.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..solvers.krylov import pcg
from ..solvers.mg import vcycle
from ..utils.constants import (
    ADMM_CRIT_DISP,
    ADMM_CRIT_OSCI,
    ADMM_MAX_ITER,
    ADMM_MONI_CYCLE,
    CG_RTOL,
)
from .problem import AdmmProblem, RegionGroup


class GroupState(NamedTuple):
    z: jnp.ndarray       # (R,2,m)
    lam: jnp.ndarray     # (R,2,m)
    gamma: jnp.ndarray   # (R,i)


class AdmmState(NamedTuple):
    u: jnp.ndarray                    # (B,n)
    groups: tuple[GroupState, ...]
    it: jnp.ndarray                   # scalar int
    converged: jnp.ndarray            # scalar bool
    moni: jnp.ndarray                 # (cycle, n_monitors) rolling buffer
    mult_frozen: jnp.ndarray          # scalar bool (coarse correction freeze)
    inner_iters: jnp.ndarray          # total inner CG iterations
    coarse_x: tuple                   # per coarse correction: (Nc,) warm start
    moni_hist: jnp.ndarray            # (hist_rows, n_monitors) per-iteration
    # monitor RATIOS ||d.||^2/||.||^2 accumulated ON DEVICE (hist_rows=1 when
    # recording is off — the row is just overwritten).  Deliberate deviation
    # from resuMoni's raw squared norms (MCONTACT.h:2738-2742): raw values
    # underflow f32; the ratio test is the same convergence criterion
    # rearranged (see utils/io.py::write_moni), and the oscillation freeze
    # runs on ratios rather than raw values for the same reason.


def _gather_u(u: jnp.ndarray, body_idx: jnp.ndarray) -> jnp.ndarray:
    """u (B,n), body_idx (R,2) -> (R,2,n)."""
    return u[body_idx]


def _project_gamma(g: RegionGroup, gamma: jnp.ndarray, mode: str) -> jnp.ndarray:
    """Contact projection (MCONTACT.h:2637-2668)."""
    if mode == "scalar":
        # frictionless contact: gamma_n <- max(0, gamma_n)
        return jnp.maximum(gamma, 0.0) * g.i_mask
    # vector mode: fric<0 perfect (no projection); fric>0 Coulomb
    R, i_pad = gamma.shape
    gn = gamma[:, 0::3]
    gt1 = gamma[:, 1::3]
    gt2 = gamma[:, 2::3]
    is_contact = (g.fric >= 0.0)[:, None]
    is_fric = (g.fric > 0.0)[:, None]
    gn_p = jnp.where(is_contact, jnp.maximum(gn, 0.0), gn)
    # Coulomb cone: ||gt|| <= mu * gn; open gap -> zero tangential
    tnorm = jnp.sqrt(gt1**2 + gt2**2)
    slide = g.fric[:, None] * gn_p
    scale = jnp.where(tnorm >= jnp.maximum(slide, 0.0),
                      slide / jnp.where(tnorm == 0.0, 1.0, tnorm), 1.0)
    scale = jnp.where(gn_p > 0.0, scale, 0.0)
    gt1_p = jnp.where(is_fric, gt1 * scale, gt1)
    gt2_p = jnp.where(is_fric, gt2 * scale, gt2)
    out = jnp.zeros_like(gamma)
    out = out.at[:, 0::3].set(gn_p)
    out = out.at[:, 1::3].set(gt1_p)
    out = out.at[:, 2::3].set(gt2_p)
    return out * g.i_mask


def make_admm_step(prob: AdmmProblem, modes: tuple[str, ...],
                   inner_maxiter: int = 500, inner_rtol: float | None = None,
                   mass_maxiter: int = 200):
    """Build the jitted single-iteration function."""
    from ..utils.precision import floor_crit, floor_rtol

    mg = prob.mg
    dtype = prob.cons_forc.dtype
    tiny = float(jnp.finfo(dtype).tiny)
    crit_disp = floor_crit(ADMM_CRIT_DISP, dtype)
    if inner_rtol is None:
        # reference tolerance (1e-14*||b||, MGPIS.h:175), floored at the
        # solve dtype's achievable residual (utils/precision.py policy)
        inner_rtol = floor_rtol(CG_RTOL, dtype)
    # The interface mass solves gate the z/lambda MONITOR noise floor: at
    # 40*eps they leave ||dz||/||z|| ~ 2e-5 churn that keeps the z monitors
    # ~4x above floor_crit and doubles the outer iteration count at the f32
    # fixed point (6 vs the reference's 3 on bench-small).  They are cheap
    # (interface-sized, Jacobi-preconditioned, warm-started), so run them to
    # 4*eps — the tightest PCG reliably reaches — while the expensive body
    # solve keeps the 40*eps floor (its monitor passes there).
    mass_rtol = max(float(CG_RTOL), 4.0 * float(jnp.finfo(dtype).eps))

    def body_solve(rhs, x0):
        # warm start from the previous ADMM iterate: the solve is still run
        # to 1e-14*||b|| (reference-exact), but increments shrink as ADMM
        # converges, so late iterations cost only a few V-cycles.  Matvec in
        # f64, V-cycle preconditioner in f32 (see solvers/mg.py).
        res = pcg(mg.A_top.mv, lambda r: vcycle(mg, r), rhs,
                  x0=x0, rtol=inner_rtol, maxiter=inner_maxiter)
        return res.x, res.iters

    def step(state: AdmmState) -> AdmmState:
        # Once converged the step is a no-op (lax.cond skips the branch), so
        # every dispatch path — monolithic while_loop, chunked, stepwise —
        # reports the identical iterations-to-converge (the reference's
        # iterNumbReco, MCONTACT.h:2714) and identical final state, and
        # post-convergence dispatches cost only the predicate.
        return jax.lax.cond(state.converged, lambda s: s, _step_body, state)

    def _step_body(state: AdmmState) -> AdmmState:
        # ---------------------------------------------------- x-update rhs
        rhs_flat = prob.cons_forc.reshape(-1)
        for g, gs in zip(prob.groups, state.groups):
            # row-compacted TtP/Tt: scatter each (region, side)'s body-DOF
            # contributions into the stacked rhs (offsets baked into t_idx)
            contrib = g.TtP.mv(gs.z) - g.Tt.mv(gs.lam)       # (R,2,r)
            rhs_flat = rhs_flat.at[g.t_idx.ravel()].add(contrib.ravel())
        rhs = rhs_flat.reshape(prob.cons_forc.shape) * prob.u_mask
        u, inner_it = body_solve(rhs, state.u)

        # ------------------ coarse-space corrections (MULTISCALE variants A
        # and/or B, MCONTACT.h:2540-2624); applied until the oscillation
        # monitor freezes them (MULT_MAXI semantics).  Signs are baked into
        # the stored operators (see CoarseCorrection).
        new_coarse_x = list(state.coarse_x)
        if prob.coarse:
            for ci, co in enumerate(prob.coarse):   # tuple of CoarseCorrection

                def apply_coarse(args, co=co, ci=ci):
                    from .multiscale import ComposedAccu, ComposedTranD

                    u, x_prev = args
                    # tranL/tranZ are row-compacted (R,2,r_pad,k) with a
                    # scatter index into the coarse vector (padded rows
                    # produce exact zeros and scatter harmlessly to row 0)
                    gf = co.forc0
                    for gs, tl, ti in zip(state.groups, co.tranL,
                                          co.tranL_idx):
                        gf = gf.at[ti.ravel()].add(tl.mv(gs.lam).ravel())
                    if co.tranZ is not None:
                        for gs, tz, ti in zip(state.groups, co.tranZ,
                                              co.tranZ_idx):
                            gf = gf.at[ti.ravel()].add(tz.mv(gs.z).ravel())
                    if isinstance(co.tranD, ComposedTranD):
                        # F^T A u through the hierarchy (A_top + Pt chain)
                        gf = gf + co.tranD.apply(mg, u)
                    else:
                        gf = gf + co.tranD.mv(u.reshape(-1))
                    if co.mg is not None:
                        # DOUBLE_M(_1): MG-preconditioned CG on the coarse
                        # operator's own DD hierarchy (MCONTACT.h:1538-1670),
                        # warm-started from the previous iteration's coarse
                        # solution (the rhs changes little late in the run)
                        sol = pcg(
                            co.mg.A_top.mv,
                            lambda r: vcycle(co.mg, r),
                            gf[None],
                            x0=x_prev[None],
                            rtol=inner_rtol,
                            maxiter=500,
                        ).x[0]
                    else:
                        # inverse apply + one f64 refinement step
                        sol = co.inv @ gf
                        sol = sol + co.inv @ (gf - co.mat @ sol)
                    if isinstance(co.accu, ComposedAccu):
                        du = co.accu.apply(mg, sol)   # P chain from dole
                    else:
                        du = co.accu.mv(sol).reshape(u.shape)
                    return u + du, sol

                u, new_coarse_x[ci] = jax.lax.cond(
                    state.mult_frozen,
                    lambda args: args,
                    apply_coarse,
                    (u, state.coarse_x[ci]),
                )

        new_groups = []
        # body monitors: full-space ||du||^2 vs ||u||^2 via Gram, computed on
        # max-normalized vectors so squared norms stay in f32 range (scale
        # cancels in the ratio; see utils/precision.py)
        du = u - state.u
        s_u = jnp.maximum(jnp.abs(u).max(-1, keepdims=True), tiny)
        dus, us = du / s_u, u / s_u
        du2 = (dus * prob.gram.mv(dus)).sum(-1)
        u2 = (
            (us * prob.gram.mv(us)).sum(-1)
            + 2.0 * (prob.gram_lin * us).sum(-1) / s_u[..., 0]
            + prob.gram_const / s_u[..., 0] ** 2
        )
        moni_vals = [du2]
        moni_allow = [u2]

        for g, gs, mode in zip(prob.groups, state.groups, modes):
            u_rs = _gather_u(u, g.body_idx)                   # (R,2,n)
            bpu = g.Bp.mv(u_rs) + g.bp_const                  # (R,2,m)
            # ------------------------------------------------------ gamma
            lam_ip = g.L.mv(gs.lam)                           # (R,2,i)
            pd_u = g.Pd.mv(u_rs) + g.pd_const                 # (R,2,i)
            gamma = 0.5 * (
                lam_ip[:, 0] - lam_ip[:, 1] + pd_u[:, 0] - pd_u[:, 1] - g.rho_g
            )
            gamma = _project_gamma(g, gamma, mode)
            # ---------------------------------------------------- z-update
            gamma_b = jnp.broadcast_to(
                gamma[:, None, :], (gamma.shape[0], 2, gamma.shape[1])
            )
            e_gamma = g.E.tmv(gamma_b, g.m_mask.shape[-1])    # (R,2,m)
            z_rhs = (bpu + g.M.mv(gs.lam) + e_gamma) * g.m_mask
            z = pcg(
                g.Mp.mv,
                lambda r: r / g.Mp_diag,
                z_rhs,
                x0=gs.z,
                rtol=mass_rtol,
                maxiter=mass_maxiter,
            ).x
            # ----------------------------------------------- lambda-update
            l_rhs = (bpu - g.Mp.mv(z)) * g.m_mask
            dlam = pcg(
                g.M.mv,
                lambda r: r / g.M_diag,
                l_rhs,
                rtol=mass_rtol,
                maxiter=mass_maxiter,
            ).x
            lam = gs.lam + dlam
            new_groups.append(GroupState(z=z, lam=lam, gamma=gamma))
            # ---------------------------------------------------- monitors
            s_z = jnp.maximum(jnp.abs(z).max(-1, keepdims=True), tiny)
            dz2 = (((z - gs.z) / s_z) ** 2).sum(-1)           # (R,2)
            z2 = ((z / s_z) ** 2).sum(-1)
            moni_vals.append(dz2.reshape(-1))
            moni_allow.append(z2.reshape(-1))

        vals = jnp.concatenate(moni_vals)
        allow = jnp.concatenate(moni_allow)
        # the monitored quantity is the scale-invariant ratio (reference
        # semantics ||d.||^2 <= crit*||.||^2, MCONTACT.h:2760, rearranged —
        # robust in f32 and well-conditioned for the oscillation test)
        ratio = vals / jnp.maximum(allow, tiny)
        moni = state.moni.at[state.it % ADMM_MONI_CYCLE].set(ratio)
        hist_rows = state.moni_hist.shape[0]
        moni_hist = state.moni_hist.at[state.it % hist_rows].set(ratio)

        # convergence: every monitor ratio below crit (MCONTACT.h:2760;
        # dtype-floored, utils/precision.py)
        converged = jnp.all(ratio <= crit_disp)

        # oscillation freeze for the coarse correction (MCONTACT.h:2749-2758,
        # 2838-2840): all monitors' 10-sample oscillation < 0.1 * median
        medi = 0.5 * (moni.max(axis=0) + moni.min(axis=0))
        osci = moni.max(axis=0) - moni.min(axis=0)
        osc_ok = jnp.all(osci <= ADMM_CRIT_OSCI * medi)
        mult_frozen = jnp.logical_or(
            state.mult_frozen,
            jnp.logical_and(state.it >= ADMM_MONI_CYCLE, osc_ok),
        )

        return AdmmState(
            u=u,
            groups=tuple(new_groups),
            it=state.it + 1,
            converged=converged,
            moni=moni,
            mult_frozen=mult_frozen,
            inner_iters=state.inner_iters + inner_it,
            coarse_x=tuple(new_coarse_x),
            moni_hist=moni_hist,
        )

    return step


def init_state(prob: AdmmProblem, hist_rows: int = 1) -> AdmmState:
    B, n = prob.cons_forc.shape
    dtype = prob.cons_forc.dtype
    groups = []
    n_moni = B
    for g in prob.groups:
        R, _, m = g.bp_const.shape
        i = g.rho_g.shape[1]
        groups.append(
            GroupState(
                z=jnp.zeros((R, 2, m), dtype),
                lam=jnp.zeros((R, 2, m), dtype),
                gamma=jnp.zeros((R, i), dtype),
            )
        )
        n_moni += 2 * R
    return AdmmState(
        u=jnp.zeros((B, n), dtype),
        groups=tuple(groups),
        it=jnp.zeros((), jnp.int32),
        converged=jnp.zeros((), bool),
        moni=jnp.full((ADMM_MONI_CYCLE, n_moni), jnp.inf, dtype),
        mult_frozen=jnp.zeros((), bool),
        inner_iters=jnp.zeros((), jnp.int32),
        coarse_x=tuple(
            jnp.zeros(co.forc0.shape, dtype) for co in (prob.coarse or ())
        ),
        moni_hist=jnp.full((hist_rows, n_moni), jnp.inf, dtype),
    )


@partial(jax.jit, static_argnames=("modes", "inner_maxiter"))
def admm_step(prob: AdmmProblem, state: AdmmState, modes: tuple[str, ...],
              inner_maxiter: int = 500) -> AdmmState:
    """One jitted ADMM iteration with ``prob`` as a runtime argument (NOT a
    closure constant — embedding the operators as HLO constants triggers
    XLA's slow constant folding and bloats the executable).  No-ops once
    ``state.converged`` is set (see ``make_admm_step``)."""
    return make_admm_step(prob, modes, inner_maxiter=inner_maxiter)(state)


def contact_analysis_stepwise(
    prob: AdmmProblem,
    modes: tuple[str, ...],
    max_iter: int = ADMM_MAX_ITER,
    callback=None,
) -> AdmmState:
    """Host-driven variant of :func:`contact_analysis`: a Python loop around
    the jitted single iteration, checking convergence on host (the
    reference's own loop structure, MCONTACT.h:2504-2712).  Slightly more
    dispatch latency per iteration, but compiles faster, supports
    per-iteration callbacks (monitor output), and sidesteps outer-while
    compile pathologies on some backends."""
    state = init_state(prob)
    for it in range(max_iter):
        state = admm_step(prob, state, modes)
        if callback is not None:
            callback(state)
        if (it % 10 == 9 or it < 3) and bool(state.converged):
            break
    return state


def contact_analysis(
    prob: AdmmProblem,
    modes: tuple[str, ...],
    max_iter: int = ADMM_MAX_ITER,
    inner_maxiter: int = 500,
    record_moni: bool = False,
    state0: AdmmState | None = None,
    chunk: int | None = None,
) -> AdmmState:
    """Run the full ADMM loop to convergence (or max_iter).

    ``record_moni=True`` sizes the on-device history buffer to ``max_iter``
    rows so every iteration's monitor ratios survive the loop (resuMoni.txt
    parity, MCONTACT.h:2742, without leaving the fast path); rows past
    convergence stay +inf.  ``state0`` lets callers pass a pre-sharded or
    checkpointed initial state."""
    if state0 is None:
        state0 = init_state(prob, hist_rows=max_iter if record_moni else 1)
    if chunk is None or chunk >= max_iter:
        return _contact_analysis_jit(
            prob, modes, max_iter, inner_maxiter, state0
        )

    # chunked dispatch mode: ``chunk`` jitted single-iteration dispatches per
    # host convergence check (one scalar readback every chunk iterations;
    # dispatch itself is asynchronous and costs microseconds).  It compiles
    # only the step body, not an outer lax.while_loop around it.  ``prob``
    # is a jit ARGUMENT of admm_step (not a closure): closing over the
    # concrete problem would embed every operator as an HLO constant.
    # Because the step no-ops once converged, state.it and the final state
    # match the while_loop path exactly; overshoot dispatches within the
    # last chunk execute only the converged predicate.
    state = state0
    dispatched = int(state.it)
    while dispatched < max_iter:
        n = min(chunk, max_iter - dispatched)
        for _ in range(n):
            state = admm_step(prob, state, modes,
                              inner_maxiter=inner_maxiter)
        dispatched += n
        if bool(state.converged):
            break
    return state


@partial(
    jax.jit, static_argnames=("modes", "max_iter", "inner_maxiter")
)
def _contact_analysis_jit(prob, modes, max_iter, inner_maxiter, state0):
    step = make_admm_step(prob, modes, inner_maxiter=inner_maxiter)

    def cond(state: AdmmState):
        return jnp.logical_and(state.it < max_iter, ~state.converged)

    return jax.lax.while_loop(cond, step, state0)
