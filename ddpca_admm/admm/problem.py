"""Device-side ADMM problem: padded/stacked pytrees built from host operators.

This is the bridge between the host setup (meshes, ConstrainedSystem,
RegionOps) and the jitted solve loop.  Key design decision: every
operator the hot loop applies against body displacements is pre-composed with
the body's reduced-space expansion X (u_full = X u + d0), so loop state is
only (u_reduced per body, z/lambda per region side) — no 3N-DOF vectors, no
host round-trips.

  x-update rhs contribution:  TtP @ z - Tt @ lam    (TtP = X^T systTran_pena)
  interface trace:            Bp @ u + bp_const     (Bp = systTran_pena^T X)
  gamma displacement part:    Pd @ u + pd_const     (Pd = pemaInpo inpoDisp X)

Convergence monitoring reproduces the reference's *full-space* norms via the
precomputed Gram matrix G = X^T X:  ||du_full||^2 = du^T G du
(MCONTACT.h:2737-2743 semantics without materializing full vectors).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..fem.constraints import ConstrainedSystem
from ..solvers.mg import MgHierarchy, build_hierarchy
from ..sparse.bell import compact_device_sparse, device_sparse, round_up
from ..sparse.ell import Ell, stack_ells, to_device
from .operators import RegionOps


class RegionGroup(NamedTuple):
    """Stacked operators for all regions of one DOF mode ('scalar'/'vector').

    Leading axes: R regions x 2 sides.  m = interface DOFs, i = integral-point
    DOFs, n = body reduced DOFs (padded to group/batch maxima).
    """

    body_idx: jnp.ndarray    # (R,2) int32
    TtP: Ell                 # (R,2,r,kt): X^T systTran_pena, row-compacted
    Tt: Ell                  # (R,2,r,kt): X^T systTran, row-compacted
    t_idx: jnp.ndarray       # (R,2,r): scatter rows into stacked (B*n) rhs
    Bp: Ell                  # (R,2,m,kb): systTran_pena^T X
    bp_const: jnp.ndarray    # (R,2,m)
    M: Ell                   # (R,2,m,km) inteMass
    Mp: Ell                  # (R,2,m,km) inteMass_pena
    M_diag: jnp.ndarray      # (R,2,m)
    Mp_diag: jnp.ndarray
    L: Ell                   # (R,2,i,kl) inpoLagr
    Pd: Ell                  # (R,2,i,kp) pemaInpo inpoDisp X
    pd_const: jnp.ndarray    # (R,2,i)
    E: Ell                   # (R,2,i,ke) inteInpo TRANSPOSED (apply via tmv)
    rho_g: jnp.ndarray       # (R,i) pemaInpo @ inpoNgap
    fric: jnp.ndarray        # (R,)
    m_mask: jnp.ndarray      # (R,2,m) valid interface dof
    i_mask: jnp.ndarray      # (R,i) valid integral-point dof

    @property
    def n_regions(self) -> int:
        return self.body_idx.shape[0]


class AdmmProblem(NamedTuple):
    mg: MgHierarchy            # batched body hierarchies
    cons_forc: jnp.ndarray     # (B,n)
    gram: Ell                  # (B,n,kg) X^T X
    gram_lin: jnp.ndarray      # (B,n)   X^T d0
    gram_const: jnp.ndarray    # (B,)    ||d0||^2
    groups: tuple[RegionGroup, ...]   # scalar and/or vector groups
    u_mask: jnp.ndarray        # (B,n) valid reduced dof
    coarse: "tuple | None"     # CoarseCorrection tuple (A and/or B), or None


@dataclass
class AdmmMeta:
    """Host-side metadata for unpacking results."""

    systems: list[ConstrainedSystem]
    regions: list[RegionOps]
    group_modes: list[str]
    group_region_idx: list[list[int]]   # global region index per group slot
    n_pad: int


def _compose(ops, X: sp.csr_matrix, d0: np.ndarray, side: int):
    """Pre-compose one region side with the body expansion."""
    s = ops.sides[side]
    TtP = (X.T @ s.syst_tran_pena).tocsr()   # (n x m)
    Tt = (X.T @ s.syst_tran).tocsr()
    Bp = (s.syst_tran_pena.T @ X).tocsr()    # (m x n)
    bp_const = s.syst_tran_pena.T @ d0
    pema = sp.diags(ops.pema)
    Pd = (pema @ s.inpo_disp @ X).tocsr()    # (i x n)
    pd_const = pema @ (s.inpo_disp @ d0)
    return TtP, Tt, Bp, bp_const, Pd, pd_const


def build_problem(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    dole: Sequence[int] | None = None,
    musc_sett: int = 2,
    meshes: Sequence | None = None,
    precond_dtype=None,
    coarse_solver: str = "auto",
    dtype=None,
    structured: bool = True,
) -> tuple[AdmmProblem, AdmmMeta]:
    """Build the device problem.

    ``dole``: per-body coarse level for the coarse-space corrections
    (doleMcsc, MCONTACT.h:23); None disables them.  ``musc_sett`` is the
    reference's correction bitmask (MCONTACT.h:22): bit0 = MULTISCALE (A,
    LATIN macroscopic — requires ``meshes``), bit1 = MULTISCALE_1 (B,
    interface-eliminated).  ``dtype``: solve dtype (default: the
    precision policy, utils/precision.py — f64 on every backend)."""
    B = len(systems)
    import jax.numpy as _jnp

    from ..utils.precision import solve_dtype as _solve_dtype

    from ..utils.timing import phase as _phase

    sd = _solve_dtype(dtype)
    # Bodies untouched by contact AMR have fewer multigrid levels than the
    # refined ones (the reference's per-domain mgpi.maxiLeve varies freely,
    # MGPIS.h:10); the batched hierarchy needs a uniform count, so extend
    # shallow bodies at the finest end with identity prolongations (repeat
    # the finest operator — extra smoothing there is harmless).  Appending
    # at the top keeps coarse level indices (dole) stable.
    L_max = max(s.n_levels for s in systems)
    # extend local copies of the level lists — never mutate the caller's
    # ConstrainedSystem objects (they may be reused for run_apps or a second
    # build with different dole semantics)
    stif_lists, prol_lists = [], []
    for s in systems:
        stif = list(s.cons_stif)
        prol = list(s.real_prol)
        while len(stif) < L_max:
            stif.append(stif[-1])
            prol.append(sp.identity(stif[-1].shape[0], format="csr"))
        stif_lists.append(stif)
        prol_lists.append(prol)
    # structured-grid DIA fast path: only when EVERY body is a detected
    # uniform grid AND no body needed level extension (identity prolongations
    # are not nested-grid transfers).  ``structured=False`` opts out — the
    # BatchBlocks grouping shards per body-shape group, which is incompatible
    # with a 'domain'-sharded mesh when shapes are heterogeneous
    # (parallel/sharding.py::shard_problem raises in that case).
    grids = [getattr(s, "grid", None) for s in systems]
    if (
        not structured
        or any(g is None for g in grids)
        or any(len(s.cons_stif) != L_max for s in systems)
    ):
        grids = None
    with _phase("MGPIS::ESTABLISH (device hierarchy)"):
        mg = build_hierarchy(
            stif_lists, prol_lists,
            dtype=precond_dtype or _jnp.float32,
            a_top_dtype=sd,
            grids=grids,
        )
    n_pad = mg.levels[-1].A.n_rows
    cons_forc = np.zeros((B, n_pad))
    gram_mats, gram_lin, gram_const = [], np.zeros((B, n_pad)), np.zeros(B)
    u_mask = np.zeros((B, n_pad), dtype=bool)
    for b, s in enumerate(systems):
        nb = s.n_dof
        cons_forc[b, :nb] = s.cons_forc
        G = (s.expand.T @ s.expand).tocsr()
        gram_mats.append(G)
        gram_lin[b, :nb] = s.expand.T @ s.expand_const
        gram_const[b] = float(s.expand_const @ s.expand_const)
        u_mask[b, :nb] = True
    if all((G - sp.diags(G.diagonal())).nnz == 0 for G in gram_mats):
        # grid-mode expand is permutation x mask x prolongation-free, so
        # X^T X is exactly diagonal — store as a 1-offset Dia (no gather,
        # ~100x smaller than the ELL at the 8.8M-DOF scale)
        from ..sparse.dia import Dia as _Dia

        gd = np.ones((B, n_pad))
        for b, G in enumerate(gram_mats):
            gd[b, : G.shape[0]] = G.diagonal()
        gram = _Dia(_jnp.asarray(gd[:, None, :]), (0,), n_pad)
    else:
        gram = device_sparse(gram_mats, n_pad, n_pad)

    # Group regions by DOF mode, then split each mode into SIZE BUCKETS:
    # every group is padded to its largest member, so one group spanning a
    # heterogeneous region population (DEHW: ~4 large AMR contact zones among
    # ~90 small DD interfaces) would cost R x max instead of ~sum.  Sorting
    # by size and opening a new bucket whenever a region falls below half the
    # bucket leader bounds per-region padding waste to 2x at the price of
    # O(log(size range)) extra groups (dispatch/compile cost is per group,
    # negligible at <=8 buckets).
    modes_present = sorted({r.region.mode for r in regions})
    buckets: list[tuple[str, list[int]]] = []
    for mode in modes_present:
        idx = [i for i, r in enumerate(regions) if r.region.mode == mode]

        def _size(i):
            r = regions[i]
            m = max(r.sides[s].inte_mass.shape[0] for s in (0, 1))
            return m + r.pema.size

        idx.sort(key=_size, reverse=True)
        cur: list[int] = []
        for i in idx:
            if cur and _size(cur[0]) > 2 * _size(i):
                buckets.append((mode, cur))
                cur = []
            cur.append(i)
        if cur:
            buckets.append((mode, cur))

    modes = [m for m, _ in buckets]   # one entry PER GROUP (may repeat)
    groups = []
    group_region_idx = []
    for mode, idx in buckets:
        group_region_idx.append(idx)
        regs = [regions[i] for i in idx]
        R = len(regs)
        # pad interface/integral-point dims to the 128-lane tile; vector mode
        # additionally needs divisibility by 3 (gamma n/t1/t2 deinterleave in
        # loop.py) -> lcm(128,3) = 384
        align = 384 if mode == "vector" else 128
        m_pad = round_up(
            max(r.sides[s].inte_mass.shape[0] for r in regs for s in (0, 1)),
            align,
        )
        i_pad = round_up(max(r.pema.size for r in regs), align)

        body_idx = np.array([r.region.bodies for r in regs], dtype=np.int32)
        fric = np.array([r.region.fric for r in regs])

        def stacked(mats, n_rows, n_cols):
            return device_sparse(mats, n_rows, n_cols, batch_shape=(R, 2))

        comp = {
            (i, s): _compose(r, systems[r.region.bodies[s]].expand,
                             systems[r.region.bodies[s]].expand_const, s)
            for i, r in enumerate(regs) for s in (0, 1)
        }
        sides2 = [(i, s) for i in range(R) for s in (0, 1)]
        # TtP/Tt (X^T systTran(_pena)) are nonzero only on body DOFs near
        # the interface: store them row-compacted with a shared scatter
        # index into the stacked (B, n) rhs (body offset baked in) instead
        # of (R, 2, n_pad, k) stacks that scale with the BODY dimension.
        t_offsets = [
            regs[i].region.bodies[s] * n_pad for i, s in sides2
        ]
        (TtP, Tt), t_idx = compact_device_sparse(
            [[comp[k][0] for k in sides2], [comp[k][1] for k in sides2]],
            m_pad, (R, 2), row_offsets=t_offsets,
        )
        Bp = stacked([comp[k][2] for k in sides2], m_pad, n_pad)
        Pd = stacked([comp[k][4] for k in sides2], i_pad, n_pad)
        M = stacked([regs[i].sides[s].inte_mass for i, s in sides2], m_pad, m_pad)
        Mp = stacked(
            [regs[i].sides[s].inte_mass_pena for i, s in sides2], m_pad, m_pad
        )
        L = stacked([regs[i].sides[s].inpo_lagr for i, s in sides2], i_pad, m_pad)
        # E (inteInpo) is stored TRANSPOSED: a contact-zone interface node
        # can touch thousands of integral points (ELL k explodes to the max
        # over all regions), but every integral point touches exactly 4
        # nodes, so E^T has bounded row degree; applied via Ell.tmv scatter.
        E = device_sparse(
            [regs[i].sides[s].inte_inpo.T.tocsr() for i, s in sides2],
            i_pad, m_pad, batch_shape=(R, 2), force_ell=True,
        )

        bp_const = np.zeros((R, 2, m_pad))
        pd_const = np.zeros((R, 2, i_pad))
        M_diag = np.ones((R, 2, m_pad))
        Mp_diag = np.ones((R, 2, m_pad))
        m_mask = np.zeros((R, 2, m_pad), dtype=bool)
        i_mask = np.zeros((R, i_pad), dtype=bool)
        rho_g = np.zeros((R, i_pad))
        for i, r in enumerate(regs):
            i_mask[i, : r.pema.size] = True
            rho_g[i, : r.pema.size] = r.pema * r.ngap
            for s in (0, 1):
                mdof = r.sides[s].inte_mass.shape[0]
                m_mask[i, s, :mdof] = True
                bp_const[i, s, :mdof] = comp[(i, s)][3]
                pd_const[i, s, : r.pema.size] = comp[(i, s)][5]
                M_diag[i, s, :mdof] = r.sides[s].inte_mass.diagonal()
                Mp_diag[i, s, :mdof] = r.sides[s].inte_mass_pena.diagonal()

        groups.append(
            RegionGroup(
                body_idx=jnp.asarray(body_idx),
                TtP=TtP,
                Tt=Tt,
                t_idx=t_idx,
                Bp=Bp,
                bp_const=jnp.asarray(bp_const),
                M=M,
                Mp=Mp,
                M_diag=jnp.asarray(M_diag),
                Mp_diag=jnp.asarray(Mp_diag),
                L=L,
                Pd=Pd,
                pd_const=jnp.asarray(pd_const),
                E=E,
                rho_g=jnp.asarray(rho_g),
                fric=jnp.asarray(fric),
                m_mask=jnp.asarray(m_mask),
                i_mask=jnp.asarray(i_mask),
            )
        )

    coarse = None
    if dole is not None:
        from .multiscale import (
            build_coarse_correction,
            build_coarse_correction_a,
        )

        m_pads = [g.bp_const.shape[-1] for g in groups]
        parts = []
        if musc_sett & 1:
            with _phase("MCONTACT::MULTISCALE (coarse correction A)"):
                parts.append(
                    build_coarse_correction_a(
                        systems, regions, meshes or [], list(dole), n_pad,
                        group_region_idx, m_pads, coarse_solver=coarse_solver,
                    )
                )
        if musc_sett & 2:
            # LARGE structured uniform-dole problems compute the F^T A /
            # accuProl actions through the hierarchy (ComposedTranD /
            # ComposedAccu) instead of materializing them — 4.3 GB of the
            # 8.8M-DOF problem (artifacts/probe_full_breakdown.json: tranD
            # 3.6 GB + accu 0.7).  Small problems keep the materialized
            # (solve-dtype-exact) operators: the composed chain runs in the
            # f32 preconditioner dtype, whose restriction noise costs ~1
            # outer iteration — irrelevant at scale, wasteful at bench-small.
            import os as _os

            compose_min = int(
                _os.environ.get("DDPCA_COMPOSE_TRAND_MIN_DOFS", "2000000")
            )
            ndp = (
                mg.levels[dole[0]].A.n_rows
                if grids is not None
                and len(set(dole)) == 1
                and B * n_pad >= compose_min
                else None
            )
            with _phase("MCONTACT::MULTISCALE_1 (coarse correction B)"):
                parts.append(
                    build_coarse_correction(
                        systems, regions, list(dole), n_pad, group_region_idx,
                        m_pads, coarse_solver=coarse_solver,
                        compose_n_dole_pad=ndp,
                    )
                )
        coarse = tuple(parts) if parts else None

    prob = AdmmProblem(
        mg=mg,
        cons_forc=jnp.asarray(cons_forc),
        gram=gram,
        gram_lin=jnp.asarray(gram_lin),
        gram_const=jnp.asarray(gram_const),
        groups=tuple(groups),
        u_mask=jnp.asarray(u_mask),
        coarse=coarse,
    )
    from ..utils.precision import cast_pytree

    if sd != jnp.dtype(jnp.float64):
        # Downcast the whole problem to an explicitly requested f32 solve
        # dtype.  In the default f64 solve nothing is cast: operators are
        # already f64 and the V-cycle preconditioner intentionally stays f32.
        prob = cast_pytree(prob, sd)
    meta = AdmmMeta(
        systems=list(systems),
        regions=list(regions),
        group_modes=modes,
        group_region_idx=group_region_idx,
        n_pad=n_pad,
    )
    return prob, meta
