"""Coarse-space correction B: the interface-eliminated global coarse problem.

Re-design of MCONTACT::MULTISCALE_1 / DOUBLE_M_1 (MCONTACT.h:1672-2341), the
correction used by the BLOCK and TORSION examples (muscSett bit 1): a global
coarse problem on all bodies' level-``dole`` DOFs,

  globCoup_1 = blockdiag(A_c)  -  1/2 * sum_(ts,side) U_s (S_s) U_s^T
                                 -  1/2 * sum U_self C_cross U_mate^T

with U_v = (X_v F_v)^T the full->coarse projection (F_v = product of
realProl down to level dole), solved each ADMM iteration for

  globForc = globForc_1 + sum globTran_1 lam  -  sum globTran_D_1 u

and prolongated back as u_v += F_v sol_v (accuProl, MCONTACT.h:864-872).

Deviations from the reference (documented):
  * accuProl is realized as the product of realProl operators (intermediate
    Dirichlet selectors included) — identical whenever constrained fine DOFs
    have constrained parents, which holds for the face-aligned constraints of
    every example;
  * the coarse solve below DIRE_MAXI is a padded dense inverse-apply on
    device (the reference uses sparse LDLT below 120k DOF, MCONTACT.h:1858);
  * at/above DIRE_MAXI (or when forced via ``coarse_solver="ddmg"``) the
    DOUBLE_M / DOUBLE_M_1 path (MCONTACT.h:1538-1670, 2303-2341) kicks in:
    block-diagonal prolongations across subdomains (identity on the
    macroscopic interface unknowns in variant A) Galerkin-coarsen the global
    coarse operator into its own multigrid hierarchy, and the jitted loop
    solves it with MG-preconditioned CG instead of the dense inverse.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np
import scipy.linalg
import scipy.sparse as sp

from ..fem.constraints import ConstrainedSystem
from ..solvers.mg import MgHierarchy, build_hierarchy
from ..sparse.bell import device_sparse, round_up
from ..sparse.ell import Ell, ell_from_csr, stack_ells, to_device
from ..utils.constants import DENSE_COARSE_MAXI, DIRE_MAXI
from .operators import RegionOps


class CoarseCorrection(NamedTuple):
    """Device-side coarse correction (consumed inside the jitted loop).

    Covers both reference variants with sign conventions baked into the
    stored operators so the loop always *adds* contributions:
      rhs = forc0 + sum tranL.mv(lam) + sum tranZ.mv(z) + tranD.mv(u)
      du  = accu @ (globCoup^{-1} rhs)
    MULTISCALE_1 ("B", interface-eliminated): tranZ is None, forc0 constant;
    MULTISCALE  ("A", LATIN macroscopic): extra macroscopic interface
    unknowns appended to the coarse space, forc0 = 0.

    The solve is an explicit-inverse apply plus one step of f64 iterative
    refinement (two dense matvecs; sequential triangular
    substitution is latency-bound) — or, when ``mg`` is set (DOUBLE_M /
    DOUBLE_M_1, coarse spaces >= DIRE_MAXI), an MG-preconditioned CG on the
    coarse operator's own DD hierarchy."""

    inv: jnp.ndarray         # (Nc, Nc) inverse of globCoup ((1,1) when mg set)
    mat: jnp.ndarray         # (Nc, Nc) globCoup itself (refinement)
    forc0: jnp.ndarray       # (Nc,) constant part of the coarse rhs
    tranD: Ell               # (Nc, B*n_pad): maps stacked u (sign baked in)
    accu: Ell                # (B*n_pad, Nc): coarse solution -> stacked du
    # tranL/tranZ are stored ROW-COMPACTED: each (region, side) operator only
    # touches a handful of coarse rows (its macro block in variant A, its two
    # body blocks in variant B), so the stack is (R, 2, r_pad, k) with a
    # companion (R, 2, r_pad) scatter-index into the Nc vector — a full
    # (R, 2, Nc, k) stack is ~Nc/r_pad x larger and was the setup/memory
    # bottleneck of the 52-domain DEHW assembly.
    tranL: tuple[Ell, ...]   # per region group: (R,2,r_pad,k) maps lam
    tranL_idx: tuple[jnp.ndarray, ...]  # per group: (R,2,r_pad) coarse rows
    tranZ: tuple[Ell, ...] | None   # per group: maps z (None for variant B)
    tranZ_idx: tuple[jnp.ndarray, ...] | None
    mg: MgHierarchy | None = None   # DOUBLE_M(_1) DD hierarchy, or None


import jax


@jax.tree_util.register_pytree_node_class
class ComposedTranD:
    """globTran_D_1 action computed THROUGH the multigrid hierarchy instead
    of materialized.  The dominant block of globTran_D_1 is F^T A_finest
    (MCONTACT.h:1880-1906) — at the 8.8M-DOF scale its ELL is 3.6 GB
    (artifacts/probe_full_breakdown.json) while F^T is exactly the product
    of realProl transposes the hierarchy already stores as Pt operators.
    So:  -F^T(A u) = -(Pt chain)(A_top.mv(u)), plus the materialized region
    coupling part (interface-local rows only, small).

    ``level`` (static) is the coarse level dole; ``idx``/``mask`` map the
    restricted per-body (B, n_dole_pad) layout into the stacked coarse
    vector (Nc_pad,)."""

    def __init__(self, reg, idx, mask, level: int):
        self.reg = reg        # Ell (Nc_pad, B*n_pad) region part, sign baked
        self.idx = idx        # (Nc_pad,) int32 into flattened (B*n_dole_pad)
        self.mask = mask      # (Nc_pad,) 0/1 in solve dtype
        self.level = int(level)

    def tree_flatten(self):
        return (self.reg, self.idx, self.mask), (self.level,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])

    def apply(self, mg: "MgHierarchy", u: jnp.ndarray) -> jnp.ndarray:
        y = mg.A_top.mv(u)                                # (B, n_pad)
        for l in range(len(mg.levels) - 1, self.level, -1):
            y = mg.levels[l].Pt.mv(y)
        part_a = -jnp.take(y.reshape(-1), self.idx) * self.mask
        return part_a + self.reg.mv(u.reshape(-1))


@jax.tree_util.register_pytree_node_class
class ComposedAccu:
    """accuProl action through the hierarchy: du = F sol = (P chain) applied
    to the coarse solution scattered into the per-body level-dole layout —
    replaces the materialized block-diagonal F (0.7 GB at 8.8M DOF)."""

    def __init__(self, idx, mask, level: int, n_dole_pad: int, n_bodies: int):
        self.idx = idx
        self.mask = mask
        self.level = int(level)
        self.n_dole_pad = int(n_dole_pad)
        self.n_bodies = int(n_bodies)

    def tree_flatten(self):
        return (self.idx, self.mask), (
            self.level, self.n_dole_pad, self.n_bodies
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def apply(self, mg: "MgHierarchy", sol: jnp.ndarray) -> jnp.ndarray:
        y = jnp.zeros((self.n_bodies * self.n_dole_pad,), sol.dtype)
        y = y.at[self.idx].add(sol * self.mask)
        y = y.reshape(self.n_bodies, self.n_dole_pad)
        for l in range(self.level + 1, len(mg.levels)):
            y = mg.levels[l].P.mv(y)
        return y                                          # (B, n_pad)


class _SparseAccum:
    """COO accumulator for the global coarse operator (kept sparse so the
    DOUBLE_M path scales past DIRE_MAXI without densifying)."""

    def __init__(self, n: int):
        self.n = n
        self.parts: list[tuple[int, int, sp.spmatrix]] = []

    def add(self, r0: int, c0: int, m: sp.spmatrix) -> None:
        self.parts.append((r0, c0, m.tocoo()))

    def tocsr(self, n_cols: int | None = None) -> sp.csr_matrix:
        rows = np.concatenate([p[2].row + p[0] for p in self.parts])
        cols = np.concatenate([p[2].col + p[1] for p in self.parts])
        vals = np.concatenate([p[2].data for p in self.parts])
        return sp.coo_matrix(
            (vals, (rows, cols)), shape=(self.n, n_cols or self.n)
        ).tocsr()


def _compact_stack(mats, m_pad: int, batch_shape):
    """Row-compact a list of tall sparse matrices that are nonzero on few
    rows each: returns (Ell (batch..., r_pad, k), idx (batch..., r_pad)) so
    that ``full[idx] += ell.mv(x)`` reproduces ``sum(m @ x)``.  Padded rows
    carry no stored entries (mv gives exact 0) and scatter to row 0."""
    rowsets = [np.unique(m.tocoo().row) for m in mats]
    r_max = max((rs.size for rs in rowsets), default=1)
    r_pad = int(round_up(max(r_max, 1), 8))
    comp, idxs = [], []
    for m, rs in zip(mats, rowsets):
        mc = m.tocsr()[rs] if rs.size else sp.csr_matrix((0, m.shape[1]))
        comp.append(mc)
        idx = np.zeros(r_pad, dtype=np.int32)
        idx[: rs.size] = rs
        idxs.append(idx)
    ell = device_sparse(comp, r_pad, m_pad, batch_shape=batch_shape)
    idx_arr = jnp.asarray(
        np.stack(idxs).reshape(tuple(batch_shape) + (r_pad,))
    )
    return ell, idx_arr


def _dd_hierarchy(
    G: sp.csr_matrix,
    systems: Sequence[ConstrainedSystem],
    dole: Sequence[int],
    n_macro_total: int = 0,
) -> MgHierarchy | None:
    """DOUBLE_M / DOUBLE_M_1 (MCONTACT.h:1538-1670, 2303-2341): a multigrid
    hierarchy for the global coarse operator built from block-diagonal
    per-subdomain prolongations (each body's own realProl below its coarse
    level ``dole``), with an identity block appended for the macroscopic
    interface unknowns of variant A.  Returns None when any body has no
    levels below its coarse level (dole==0: nothing to coarsen with)."""
    depth = min(int(d) for d in dole)
    if depth == 0:
        return None
    prols = []
    for k in range(depth):
        blocks = [systems[v].real_prol[dole[v] - depth + k]
                  for v in range(len(systems))]
        if n_macro_total:
            blocks.append(sp.identity(n_macro_total, format="csr"))
        prols.append(sp.block_diag(blocks, format="csr"))
    mats = [G]
    for P in reversed(prols):
        mats.append((P.T @ mats[-1] @ P).tocsr())
    mats.reverse()
    return build_hierarchy([mats], [prols], assume_sym=False)


def _coarse_solver_parts(
    G: sp.csr_matrix,
    systems: Sequence[ConstrainedSystem],
    dole: Sequence[int],
    coarse_solver: str,
    n_macro_total: int = 0,
):
    """(inv, mat, mg) for a CoarseCorrection: dense inverse below DIRE_MAXI,
    DOUBLE_M(_1) MG hierarchy at/above it (reference dispatch,
    MCONTACT.h:1857-1866 / 1229-1238)."""
    Nc = G.shape[0]
    # masked (grid-mode) body hierarchies leave Dirichlet dofs in every
    # level with zero prolongation rows, so their coarse rows/cols are
    # exactly zero here — decouple them with a unit diagonal (their rhs is
    # always zero, the correction stays zero there)
    dz = G.diagonal()
    if (dz == 0.0).any():
        G = (G + sp.diags(np.where(dz == 0.0, 1.0, 0.0))).tocsr()
    use_ddmg = coarse_solver == "ddmg" or (
        coarse_solver == "auto" and Nc >= DENSE_COARSE_MAXI
    )
    if use_ddmg:
        mg = _dd_hierarchy(G, systems, dole, n_macro_total)
        if mg is not None:
            one = np.zeros((1, 1))
            return jnp.asarray(one), jnp.asarray(one), mg
        # dole==0 everywhere: no hierarchy below the coarse level exists;
        # fall through to the dense path (only reachable when forced).
    # pad the coarse space to the 128-lane tile multiple used by every
    # device operator (sparse/bell.py); padded rows/cols are identity
    Nc_pad = round_up(Nc, 128)
    dense = np.eye(Nc_pad)
    dense[:Nc, :Nc] = G.toarray()
    # LU, not Cholesky: the reference factorizes with LDLT (MCONTACT.h:1858),
    # and with non-matching coarse interpolations across a curved interface
    # the coupled operator can be (slightly) indefinite.
    lu = scipy.linalg.lu_factor(dense)
    G_inv = scipy.linalg.lu_solve(lu, np.eye(Nc_pad))
    return jnp.asarray(G_inv), jnp.asarray(dense), None


def _coarse_restriction(sysm: ConstrainedSystem, dole: int) -> sp.csr_matrix:
    """F_v: level-dole reduced space -> finest reduced space."""
    L = sysm.n_levels - 1
    F = sp.identity(sysm.cons_stif[L].shape[0], format="csr")
    for l in range(L - 1, dole - 1, -1):
        F = (F @ sysm.real_prol[l]).tocsr()
    return F


def glob_coup_1(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    dole: Sequence[int],
):
    """globCoup_1 assembly (MCONTACT.h:1674-1856): the interface-eliminated
    global coarse operator.  Returns (G_sp, F, base, XF) — shared by the
    coarse correction and the APPS eigen-analysis (MCONTACT.h:2350-2365 runs
    Spectra on this same matrix)."""
    B = len(systems)
    F = [_coarse_restriction(s, dole[v]) for v, s in enumerate(systems)]
    nc = [F[v].shape[1] for v in range(B)]
    base = np.concatenate([[0], np.cumsum(nc)])
    Nc = int(base[-1])
    XF = [(systems[v].expand @ F[v]).tocsr() for v in range(B)]  # (3N x nc)
    Gacc = _SparseAccum(Nc)
    for v in range(B):
        Gacc.add(base[v], base[v], F[v].T @ systems[v].cons_stif[-1] @ F[v])
    for r in regions:
        for s in (0, 1):
            b_self = r.region.bodies[s]
            b_mate = r.region.bodies[1 - s]
            U_self = XF[b_self]
            U_mate = XF[b_mate]
            S = r.sides[s].self_mass_rot
            C = r.sides[s].cross_mass
            Gacc.add(base[b_self], base[b_self], -0.5 * (U_self.T @ S @ U_self))
            Gacc.add(base[b_self], base[b_mate], -0.5 * (U_self.T @ C @ U_mate))
    return Gacc.tocsr(), F, base, XF


def glob_forc_1(systems, regions, F, base, XF) -> np.ndarray:
    """globForc_1 (MCONTACT.h:2057-2122): coarse restriction of the body
    loads plus the initial-gap penalty forces."""
    Nc = int(base[-1])
    forc0 = np.zeros(Nc)
    for v in range(len(systems)):
        forc0[base[v] : base[v + 1]] = F[v].T @ systems[v].cons_forc
    for r in regions:
        ip = r.region.ip
        w = ip.weight
        nrm = ip.basis[:, 0, :]
        for s in (0, 1):
            b_self = r.region.bodies[s]
            sgn = 0.5 if s == 0 else -0.5
            # full-space gap force: sgn * w * rho_n * N^T n^T g  (normal only)
            gf = np.zeros(3 * (systems[b_self].expand.shape[0] // 3))
            contrib = (
                sgn
                * r.region.pena_n
                * (w * ip.gap)[:, None, None]
                * ip.shape[s][:, :, None]
                * nrm[:, None, :]
            )
            dofs = 3 * ip.nodes[s][:, :, None] + np.arange(3)
            np.add.at(gf, dofs.ravel(), contrib.ravel())
            forc0[base[b_self] : base[b_self + 1]] += XF[b_self].T @ gf
    return forc0


def build_coarse_correction(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    dole: Sequence[int],
    n_pad: int,
    group_region_idx: Sequence[Sequence[int]],
    m_pads: Sequence[int],
    coarse_solver: str = "auto",
    compose_n_dole_pad: int | None = None,
) -> CoarseCorrection:
    """``compose_n_dole_pad``: when set (the structured/uniform-dole path),
    the F^T A block of globTran_D_1 and the accuProl are NOT materialized —
    the loop computes them through the hierarchy's A_top/Pt/P operators
    (ComposedTranD / ComposedAccu); the value is the padded per-body row
    count of hierarchy level dole."""
    B = len(systems)
    compose = compose_n_dole_pad is not None
    if compose:
        assert len(set(dole)) == 1, "composed path requires uniform dole"
    G_sp, F, base, XF = glob_coup_1(systems, regions, dole)
    nc = [F[v].shape[1] for v in range(B)]
    Nc = int(base[-1])
    inv, mat, mg = _coarse_solver_parts(G_sp, systems, dole, coarse_solver)

    # ---- globTran_D_1 (MCONTACT.h:1868-2055), acting on stacked reduced u
    rows_td = []
    for v in range(B):
        blocks = [sp.csr_matrix((nc[v], n_pad)) for _ in range(B)]
        if not compose:
            # part a: block row v: F^T A_L, cols in body v's slot
            part_a = (F[v].T @ systems[v].cons_stif[-1]).tocsr()
            part_a.resize((nc[v], n_pad))
            blocks[v] = part_a
        rows_td.append(blocks)
    for r in regions:
        for s in (0, 1):
            b_self = r.region.bodies[s]
            b_mate = r.region.bodies[1 - s]
            S = r.sides[s].self_mass_rot
            C = r.sides[s].cross_mass
            X_self, X_mate = systems[b_self].expand, systems[b_mate].expand
            add_self = (-0.5 * (F[b_self].T @ (X_self.T @ S @ X_self))).tocsr()
            add_self.resize((nc[b_self], n_pad))
            rows_td[b_self][b_self] = (rows_td[b_self][b_self] + add_self).tocsr()
            add_mate = (-0.5 * (F[b_mate].T @ (X_mate.T @ C.T @ X_self))).tocsr()
            add_mate.resize((nc[b_mate], n_pad))
            rows_td[b_mate][b_self] = (rows_td[b_mate][b_self] + add_mate).tocsr()
    tranD = sp.vstack(
        [sp.hstack(rows_td[v], format="csr") for v in range(B)], format="csr"
    )

    # ---- globForc_1 (MCONTACT.h:2057-2122)
    forc0 = glob_forc_1(systems, regions, F, base, XF)

    # ---- globTran_1 (MCONTACT.h:2124-2299), per region group stacked
    # (row-compacted: each (region, side) only touches its two body blocks)
    tranL_groups, tranL_idx_groups = [], []
    for g_i, idx in enumerate(group_region_idx):
        mats = []
        for ri in idx:
            r = regions[ri]
            for s in (0, 1):
                b_self = r.region.bodies[s]
                b_mate = r.region.bodies[1 - s]
                mdof = r.sides[s].inte_mass.shape[0]
                T_self = (-0.5 * (XF[b_self].T @ r.sides[s].syst_tran)).tocoo()
                T_mate = (0.5 * (XF[b_mate].T @ r.sides[s].cross_tran)).tocoo()
                rows = np.concatenate(
                    [T_self.row + base[b_self], T_mate.row + base[b_mate]]
                )
                cols = np.concatenate([T_self.col, T_mate.col])
                vals = np.concatenate([T_self.data, T_mate.data])
                mats.append(
                    sp.coo_matrix((vals, (rows, cols)), shape=(Nc, mdof)).tocsr()
                )
        R = len(idx)
        ell, ridx = _compact_stack(mats, m_pads[g_i], (R, 2))
        tranL_groups.append(ell)
        tranL_idx_groups.append(ridx)

    Nc_pad = round_up(Nc, 128)
    if compose:
        ndp = int(compose_n_dole_pad)
        idx = np.zeros(Nc_pad, np.int32)
        mask = np.zeros(Nc_pad, np.float64)
        for v in range(B):
            idx[base[v]: base[v + 1]] = v * ndp + np.arange(nc[v])
            mask[base[v]: base[v + 1]] = 1.0
        tranD_op = ComposedTranD(
            device_sparse([(-tranD).tocsr()], Nc_pad, B * n_pad),
            jnp.asarray(idx), jnp.asarray(mask), int(dole[0]),
        )
        accu_op = ComposedAccu(
            jnp.asarray(idx), jnp.asarray(mask), int(dole[0]), ndp, B
        )
    else:
        tranD_op = device_sparse(
            [(-tranD).tocsr()], Nc_pad, B * n_pad  # sign baked in
        )
        # ---- accuProl: stacked du = accu @ sol
        accu_blocks = []
        for v in range(B):
            Fv = F[v].tocsr().copy()
            Fv.resize((n_pad, nc[v]))
            accu_blocks.append(Fv)
        accu = sp.block_diag(accu_blocks, format="csr")  # (B*n_pad, Nc)
        accu_op = device_sparse([accu], B * n_pad, Nc_pad)

    return CoarseCorrection(
        inv=inv,
        mat=mat,
        forc0=jnp.asarray(np.pad(forc0, (0, Nc_pad - Nc))),
        tranD=tranD_op,
        accu=accu_op,
        tranL=tuple(tranL_groups),
        tranL_idx=tuple(tranL_idx_groups),
        tranZ=None,
        tranZ_idx=None,
        mg=mg,
    )


def glob_coup_a(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    meshes: Sequence,
    dole: Sequence[int],
):
    """The variant-A coarse operator globCoup (MCONTACT.h:900-1066) and its
    bases — shared by :func:`build_coarse_correction_a` and the APPS_MPL
    eigen-analysis (MCONTACT.h:2405-2474).  Returns
    (G, F, base, fico, macro_base, XF, n_macro)."""
    B = len(systems)
    F = [_coarse_restriction(s, dole[v]) for v, s in enumerate(systems)]
    nc = [F[v].shape[1] for v in range(B)]
    base = np.concatenate([[0], np.cumsum(nc)])
    Nb = int(base[-1])
    XF = [(systems[v].expand @ F[v]).tocsr() for v in range(B)]

    # ficoCotr per region (side 0): interface trace of coarse scalar basis,
    # zero columns dropped
    fico = []
    n_macro = []
    for r in regions:
        b0 = r.region.bodies[0]
        mesh = meshes[b0]
        L = mesh.max_level
        c = dole[b0]
        # un-permute rows: original node -> position ordering
        S = sp.csr_matrix(
            (np.ones(mesh.n_nodes), (np.arange(mesh.n_nodes), mesh.node_pos)),
            shape=(mesh.n_nodes, mesh.n_nodes),
        )
        for l in range(L, c - 1, -1):
            S = (S @ mesh.scal_prol[l]).tocsr()
        rows = r.sides[0].cont_nodes
        trace = S[rows]                                   # (m, n_c_scal)
        keep = np.unique(trace.nonzero()[1])
        trace = trace[:, keep].tocsr()
        if r.region.mode == "scalar":
            fico.append(trace)
            n_macro.append(trace.shape[1])
        else:
            fico.append(sp.kron(trace, sp.identity(3), format="csr"))
            n_macro.append(3 * trace.shape[1])
    macro_base = Nb + np.concatenate([[0], np.cumsum(n_macro)])
    Nc = int(macro_base[-1])

    Gacc = _SparseAccum(Nc)
    for v in range(B):
        Gacc.add(base[v], base[v], F[v].T @ systems[v].cons_stif[-1] @ F[v])
    for ri, r in enumerate(regions):
        mb0 = macro_base[ri]
        for tv in (0, 1):
            bb = r.region.bodies[tv]
            # dispUnba = systTran_pena-like coupling against side-0 shapes,
            # built directly from ip data for exactness:
            du = _disp_unba(r, tv, meshes)
            du_red = (XF[bb].T @ du @ fico[ri]).tocsr()
            Gacc.add(base[bb], mb0, -du_red)
            Gacc.add(mb0, base[bb], -du_red.T)
            ub = _unba_matr(r)
            Gacc.add(mb0, mb0, fico[ri].T @ ub @ fico[ri])
    return Gacc.tocsr(), F, base, fico, macro_base, XF, n_macro


def build_coarse_correction_a(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    meshes: Sequence,
    dole: Sequence[int],
    n_pad: int,
    group_region_idx: Sequence[Sequence[int]],
    m_pads: Sequence[int],
    coarse_solver: str = "auto",
) -> CoarseCorrection:
    """MULTISCALE variant A — the LATIN-style macroscopic correction
    (MCONTACT.h:898-1536): the coarse space is [all bodies' level-dole DOFs;
    one macroscopic unknown block per region], where the macroscopic basis is
    the *non-mortar-side* interface trace of the coarse scalar shape
    functions (ficoCotr, MCONTACT.h:900-965)."""
    G_sp, F, base, fico, macro_base, XF, n_macro = glob_coup_a(
        systems, regions, meshes, dole
    )
    B = len(systems)
    nc = [F[v].shape[1] for v in range(B)]
    Nb = int(base[-1])
    Nc = int(macro_base[-1])
    inv, mat, mg = _coarse_solver_parts(
        G_sp, systems, dole, coarse_solver, n_macro_total=Nc - Nb
    )

    # ---- globTran (lam), globTran_pena (z), globTran_D (u)
    # (row-compacted: each (region, side) only touches its macro block)
    tranL_groups, tranZ_groups = [], []
    tranL_idx_groups, tranZ_idx_groups = [], []

    def _macro_rows(ri, m):
        m = m.tocoo()
        return sp.coo_matrix(
            (m.data, (m.row + macro_base[ri], m.col)), shape=(Nc, m.shape[1])
        ).tocsr()

    for g_i, idx in enumerate(group_region_idx):
        matsL, matsZ = [], []
        for ri in idx:
            r = regions[ri]
            for tv in (0, 1):
                tl, tz = _glob_tran(r, tv)
                matsL.append(_macro_rows(ri, fico[ri].T @ tl))
                matsZ.append(_macro_rows(ri, -(fico[ri].T @ tz)))  # minus z
        R = len(idx)
        ellL, idxL = _compact_stack(matsL, m_pads[g_i], (R, 2))
        ellZ, idxZ = _compact_stack(matsZ, m_pads[g_i], (R, 2))
        tranL_groups.append(ellL)
        tranL_idx_groups.append(idxL)
        tranZ_groups.append(ellZ)
        tranZ_idx_groups.append(idxZ)

    # tranD: + globTran_D u  (macro rows only), pre-composed with X per body
    td_acc = _SparseAccum(Nc)
    for ri, r in enumerate(regions):
        mb0 = macro_base[ri]
        for tv in (0, 1):
            bb = r.region.bodies[tv]
            td = _glob_tran_d(r, tv, meshes)             # (macro x 3N_full)
            td_red = (fico[ri].T @ td @ systems[bb].expand).tocsr()
            td_red.resize((n_macro[ri], n_pad))
            td_acc.add(mb0, bb * n_pad, td_red)
    tranD = td_acc.tocsr(n_cols=B * n_pad)

    accu_blocks = []
    for v in range(B):
        Fv = F[v].tocsr().copy()
        Fv.resize((n_pad, nc[v]))
        accu_blocks.append(Fv)
    accu = sp.hstack(
        [sp.block_diag(accu_blocks, format="csr"),
         sp.csr_matrix((B * n_pad, Nc - Nb))],
        format="csr",
    )

    Nc_pad = round_up(Nc, 128)
    return CoarseCorrection(
        inv=inv,
        mat=mat,
        forc0=jnp.zeros(Nc_pad),
        tranD=device_sparse([tranD], Nc_pad, B * n_pad),
        accu=device_sparse([accu], B * n_pad, Nc_pad),
        tranL=tuple(tranL_groups),
        tranL_idx=tuple(tranL_idx_groups),
        tranZ=tuple(tranZ_groups),
        tranZ_idx=tuple(tranZ_idx_groups),
        mg=mg,
    )


def _rota_body(r: RegionOps, tv: int, NN: int) -> sp.csr_matrix:
    """Block-diagonal nodal rotation of body tv (identity when unrotated)."""
    from .operators import _rotation_blockdiag

    return _rotation_blockdiag(NN // 3, r.node_rota[tv])


def _ip_cores(r: RegionOps):
    ip = r.region.ip
    w = ip.weight
    scalar = r.region.mode == "scalar"
    if scalar:
        P = None
    else:
        P = np.diag([r.region.pena_n, r.region.pena_f, r.region.pena_f])
    return ip, w, scalar, P


def _disp_unba(r: RegionOps, tv: int, meshes) -> sp.csr_matrix:
    """dispUnba (MCONTACT.h:1011-1063 / 1101-1176): body-tv full DOFs x
    side-0 interface DOFs, penalty-weighted, rotations on the body side
    (reference: tempRota.transpose() * matr_0, MCONTACT.h:1033-1035 — the
    body rows must be in the nodal LOCAL frame to compose with expand,
    whose output is local at rotated nodes; missing this diverged the DEHW
    hub under coarse correction A)."""
    ip, w, scalar, P = _ip_cores(r)
    n = ip.n
    nodes = ip.nodes[tv]
    shape = ip.shape[tv]
    shape0 = ip.shape[0]
    uniq0, inv0 = np.unique(ip.nodes[0].reshape(-1), return_inverse=True)
    cidx0 = inv0.reshape(-1, 4)
    NN = 3 * meshes[r.region.bodies[tv]].n_nodes
    if scalar:
        nrm = ip.basis[:, 0, :]
        blk = (
            (w * r.region.pena_n)[:, None, None, None]
            * shape[:, :, None, None]
            * nrm[:, None, :, None]
            * shape0[:, None, None, :]
        )                                               # (n,4,3,4)
        rows = np.broadcast_to(
            3 * nodes[:, :, None, None] + np.arange(3)[None, None, :, None],
            blk.shape,
        ).ravel()
        cols = np.broadcast_to(cidx0[:, None, None, :], blk.shape).ravel()
        M = sp.coo_matrix(
            (blk.ravel(), (rows, cols)), shape=(NN, uniq0.size)
        ).tocsr()
        return (_rota_body(r, tv, NN).T @ M).tocsr()
    T = ip.basis
    TtPT = np.einsum("nfi,fg,ngj->nij", T, P, T)
    blk = (
        w[:, None, None, None, None]
        * shape[:, :, None, None, None]
        * shape0[:, None, None, :, None]
        * TtPT[:, None, :, None, :]
    )                                                   # (n,4,3,4,3)
    rows = np.broadcast_to(
        3 * nodes[:, :, None, None, None]
        + np.arange(3)[None, None, :, None, None],
        blk.shape,
    ).ravel()
    cols = np.broadcast_to(
        3 * cidx0[:, None, None, :, None] + np.arange(3)[None, None, None, None, :],
        blk.shape,
    ).ravel()
    M = sp.coo_matrix(
        (blk.ravel(), (rows, cols)), shape=(NN, 3 * uniq0.size)
    ).tocsr()
    return (_rota_body(r, tv, NN).T @ M).tocsr()


def _unba_matr(r: RegionOps) -> sp.csr_matrix:
    """unbaMatr: penalty Gram on the side-0 interface (MCONTACT.h:1049-1066)."""
    ip, w, scalar, P = _ip_cores(r)
    shape0 = ip.shape[0]
    uniq0, inv0 = np.unique(ip.nodes[0].reshape(-1), return_inverse=True)
    cidx0 = inv0.reshape(-1, 4)
    if scalar:
        blk = (w * r.region.pena_n)[:, None, None] * shape0[:, :, None] * shape0[:, None, :]
        rows = np.broadcast_to(cidx0[:, :, None], blk.shape).ravel()
        cols = np.broadcast_to(cidx0[:, None, :], blk.shape).ravel()
        return sp.coo_matrix(
            (blk.ravel(), (rows, cols)), shape=(uniq0.size, uniq0.size)
        ).tocsr()
    T = ip.basis
    TtPT = np.einsum("nfi,fg,ngj->nij", T, P, T)
    blk = (
        w[:, None, None, None, None]
        * shape0[:, :, None, None, None]
        * shape0[:, None, None, :, None]
        * TtPT[:, None, :, None, :]
    )
    rows = np.broadcast_to(
        3 * cidx0[:, :, None, None, None] + np.arange(3)[None, None, :, None, None],
        blk.shape,
    ).ravel()
    cols = np.broadcast_to(
        3 * cidx0[:, None, None, :, None] + np.arange(3)[None, None, None, None, :],
        blk.shape,
    ).ravel()
    return sp.coo_matrix(
        (blk.ravel(), (rows, cols)), shape=(3 * uniq0.size, 3 * uniq0.size)
    ).tocsr()


def _glob_tran(r: RegionOps, tv: int) -> tuple[sp.csr_matrix, sp.csr_matrix]:
    """(globTran, globTran_pena) cores: side-0 interface rows x side-tv
    interface cols (MCONTACT.h:1249-1396)."""
    ip, w, scalar, P = _ip_cores(r)
    shape0 = ip.shape[0]
    shape = ip.shape[tv]
    uniq0, inv0 = np.unique(ip.nodes[0].reshape(-1), return_inverse=True)
    cidx0 = inv0.reshape(-1, 4)
    uniqT, invT = np.unique(ip.nodes[tv].reshape(-1), return_inverse=True)
    cidxT = invT.reshape(-1, 4)
    if scalar:
        blk = w[:, None, None] * shape0[:, :, None] * shape[:, None, :]
        rows = np.broadcast_to(cidx0[:, :, None], blk.shape).ravel()
        cols = np.broadcast_to(cidxT[:, None, :], blk.shape).ravel()
        M = sp.coo_matrix(
            (blk.ravel(), (rows, cols)), shape=(uniq0.size, uniqT.size)
        ).tocsr()
        return M, (r.region.pena_n * M).tocsr()
    T = ip.basis
    TtT = np.einsum("nfi,nfj->nij", T, T)
    TtPT = np.einsum("nfi,fg,ngj->nij", T, P, T)

    def build(core):
        blk = (
            w[:, None, None, None, None]
            * shape0[:, :, None, None, None]
            * shape[:, None, None, :, None]
            * core[:, None, :, None, :]
        )
        rows = np.broadcast_to(
            3 * cidx0[:, :, None, None, None]
            + np.arange(3)[None, None, :, None, None],
            blk.shape,
        ).ravel()
        cols = np.broadcast_to(
            3 * cidxT[:, None, None, :, None]
            + np.arange(3)[None, None, None, None, :],
            blk.shape,
        ).ravel()
        return sp.coo_matrix(
            (blk.ravel(), (rows, cols)),
            shape=(3 * uniq0.size, 3 * uniqT.size),
        ).tocsr()

    return build(TtT), build(TtPT)


def _glob_tran_d(r: RegionOps, tv: int, meshes) -> sp.csr_matrix:
    """globTran_D core: side-0 interface rows x body-tv full DOFs
    (MCONTACT.h:1400-1532); rotation applied on the body side."""
    return _disp_unba(r, tv, meshes).T.tocsr()
