"""Constraint application and multigrid hierarchy finalization.

Host-side (scipy) re-design of MULTIGRID::CONSTRAINT (MULTIGRID.h:1102-1255):

  1. congruence with per-node rotation matrices (cylindrical frames),
  2. level-reordering permutation of DOFs,
  3. 3-DOF prolongations from the scalar ones (with rotation compensation),
  4. Galerkin coarsening of the stiffness down the hierarchy,
  5. Dirichlet elimination by row/col selection -> consStif per level,
     reduced RHS, and realProl[l] = C_{l+1} P_l C_l^T.

The output also precomputes the two operators the jitted ADMM loop needs per
body (replacing OUTP_SUB1 / ADDITIONAL_FORCE, MULTIGRID.h:1257-1281):
  expand:  u_reduced -> full nodal displacement   u_full = X u + d0
  restrict (=X^T): full nodal force -> reduced rhs contribution
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..mesh.hexmesh import HexMesh


def _rotation_blockdiag(n_nodes: int, node_rota: dict[int, np.ndarray]) -> sp.csr_matrix:
    if not node_rota:
        return sp.identity(3 * n_nodes, format="csr")
    rows, cols, vals = [], [], []
    ids = set(node_rota.keys())
    plain = np.array([i for i in range(n_nodes) if i not in ids], dtype=np.int64)
    for i in plain:
        for k in range(3):
            rows.append(3 * i + k)
            cols.append(3 * i + k)
            vals.append(1.0)
    for i, R in node_rota.items():
        for j in range(3):
            for k in range(3):
                rows.append(3 * i + j)
                cols.append(3 * i + k)
                vals.append(float(R[j, k]))
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(3 * n_nodes, 3 * n_nodes)
    )


def _expand_scalar_to_3dof(
    P: sp.csr_matrix,
    mesh: HexMesh,
    node_rota: dict[int, np.ndarray],
) -> sp.csr_matrix:
    """prolOper[l] from scalProl[l] (MULTIGRID.h:1142-1181): identity block
    expanded to 3 DOF; averaging rows become 3x3 blocks with rotation
    compensation when exactly one endpoint of the pair has a nodal frame."""
    n_cols = P.shape[1]
    if not node_rota:
        return sp.kron(P, sp.identity(3), format="csr")
    rota_pos = {int(mesh.node_pos[n]) for n in node_rota}
    coo = P.tocoo()
    # entries whose 3x3 block stays v*I go through the fast kron path
    plain = np.array(
        [
            (int(r) == int(c) and r < n_cols)
            or (int(r) not in rota_pos and int(c) not in rota_pos)
            or (int(r) in rota_pos and int(c) in rota_pos)
            for r, c in zip(coo.row, coo.col)
        ],
        dtype=bool,
    )
    base = sp.coo_matrix(
        (coo.data[plain], (coo.row[plain], coo.col[plain])), shape=P.shape
    )
    out = sp.kron(base, sp.identity(3), format="csr")
    rows, cols, vals = [], [], []
    eye = np.eye(3)
    for r, c, v in zip(coo.row[~plain], coo.col[~plain], coo.data[~plain]):
        off_node = int(mesh.pos_node[r])
        fam_node = int(mesh.pos_node[c])
        R_off = node_rota.get(off_node)
        R_fam = node_rota.get(fam_node)
        blk = v * eye
        coup_case = fam_node == mesh.coup_reps and off_node in mesh.coup_nodes
        if not coup_case:
            # exactly one endpoint rotated here (both/neither use the kron path)
            if R_off is not None:
                blk = blk @ R_off.T
            if R_fam is not None:
                blk = blk @ R_fam
        for j in range(3):
            for k in range(3):
                if blk[j, k] != 0.0:
                    rows.append(3 * r + j)
                    cols.append(3 * c + k)
                    vals.append(blk[j, k])
    corr = sp.csr_matrix(
        (vals, (rows, cols)), shape=(3 * P.shape[0], 3 * P.shape[1])
    )
    return (out + corr).tocsr()


@dataclass
class GridInfo:
    """Structured-grid metadata for the DIA fast path (one body).

    Present when every multigrid level's nodes form a full Cartesian grid
    (uniform/anisotropic global refinement, no AMR) and the reduced spaces
    are kept at FULL grid size with Dirichlet dofs *masked* (decoupled unit
    diagonal) instead of eliminated — elimination compacts indices and
    destroys the constant col-row stencil offsets that make DIA possible.
    """

    shapes: list[tuple[int, int, int]]    # per level (nz, ny, nx) node grid
    strides: list[tuple[int, int, int]]   # level l -> l+1 per-axis stride
    zmaps: list[np.ndarray]               # per level l: coarse grid-flat node
    #                                       -> fine grid-flat node index


@dataclass
class ConstrainedSystem:
    """Per-body constrained multigrid hierarchy (reference MGPIS data)."""

    cons_stif: list[sp.csr_matrix]       # per level, Dirichlet-eliminated
    real_prol: list[sp.csr_matrix]       # level l -> l+1 in reduced spaces
    cons_forc: np.ndarray                # reduced RHS at finest level
    expand: sp.csr_matrix                # reduced -> full 3N displacement
    expand_const: np.ndarray             # Dirichlet contribution to full disp
    grid: GridInfo | None = None         # structured-grid DIA metadata
    n_levels: int = 0

    def __post_init__(self) -> None:
        self.n_levels = len(self.cons_stif)

    @property
    def n_dof(self) -> int:
        return self.cons_stif[-1].shape[0]

    def full_displacement(self, u_reduced: np.ndarray) -> np.ndarray:
        """OUTP_SUB1 (MULTIGRID.h:1263-1281)."""
        return self.expand @ u_reduced + self.expand_const

    def additional_force(self, f_full: np.ndarray) -> np.ndarray:
        """ADDITIONAL_FORCE (MULTIGRID.h:1257-1261)."""
        return self.expand.T @ f_full


def _detect_grids(mesh: HexMesh, cum, L: int):
    """Per-level full-Cartesian-grid detection.  Returns (axes, flat) per
    level — axes = (ux, uy, uz) sorted unique coords, flat = grid-flat index
    of each level-order node position — or None if any level is not a full
    grid (AMR, curved meshes...)."""
    out = []
    for l in range(L + 1):
        n_l = int(cum[l + 1])
        nodes = mesh.pos_node[:n_l]
        c = np.round(mesh.coords[nodes], 12)
        ux, uy, uz = (np.unique(c[:, k]) for k in range(3))
        if ux.size * uy.size * uz.size != n_l:
            return None
        ix = np.searchsorted(ux, c[:, 0])
        iy = np.searchsorted(uy, c[:, 1])
        iz = np.searchsorted(uz, c[:, 2])
        flat = (iz * uy.size + iy) * ux.size + ix
        if np.unique(flat).size != n_l:
            return None
        out.append(((ux, uy, uz), flat))
    # nesting: each level's axis coords must be a strided subset of the next
    for l in range(L):
        for k in range(3):
            a_c, a_f = out[l][0][k], out[l + 1][0][k]
            p = np.searchsorted(a_f, a_c)
            if p[-1] >= a_f.size or not np.array_equal(a_f[p], a_c):
                return None
            s = 1 if a_c.size == 1 else int(p[1] - p[0])
            if s not in (1, 2) or not np.array_equal(
                p, np.arange(a_c.size) * s
            ):
                return None
    return out


def _grid_perm(flat: np.ndarray) -> sp.csr_matrix:
    """DOF permutation: x_grid = G @ x_level  (3 dof per node, comp minor)."""
    n = flat.size
    rows = (3 * flat[:, None] + np.arange(3)).ravel()
    cols = np.arange(3 * n)
    return sp.csr_matrix(
        (np.ones(3 * n), (rows, cols)), shape=(3 * n, 3 * n)
    )


def constrain(
    mesh: HexMesh,
    stif_full: sp.csr_matrix,
    cons_dofv: dict[int, float],
    exte_forc: dict[int, float],
    node_rota: dict[int, np.ndarray] | None = None,
    geom_mult: bool = True,
    ordering: str = "auto",
) -> ConstrainedSystem:
    """The CONSTRAINT pipeline.  ``stif_full`` is the assembled stiffness over
    all nodes (hanging included), in original node numbering."""
    node_rota = node_rota or {}
    L = mesh.max_level
    n_nodes = mesh.n_nodes

    A = stif_full
    if node_rota:
        R = _rotation_blockdiag(n_nodes, node_rota)
        A = (R.T @ A @ R).tocsr()

    # level-reorder permutation: full DOF i=3*node+k -> 3*pos[node]+k
    perm = (3 * mesh.node_pos[:, None] + np.arange(3)).ravel()  # old dof->new dof
    Pmat = sp.csr_matrix(
        (np.ones(3 * n_nodes), (np.arange(3 * n_nodes), perm)),
        shape=(3 * n_nodes, 3 * n_nodes),
    )  # maps new-ordered vectors to old ordering: x_old = Pmat @ x_new
    A = (Pmat.T @ A @ Pmat).tocsr()

    # 3-DOF prolongations + Galerkin coarsening
    levels = range(L + 1) if geom_mult else [L]
    prol = {l: _expand_scalar_to_3dof(mesh.scal_prol[l], mesh, node_rota) for l in levels}
    orig = {L + 1: A}
    for l in sorted(levels, reverse=True):
        orig[l] = (prol[l].T @ orig[l + 1] @ prol[l]).tocsr()

    # constraint flags in reordered positions
    cum = np.cumsum([0] + [nodes.size for nodes in mesh.level_nodes])
    n_solve = 3 * int(cum[L + 1])       # DOFs at finest solve level (no hanging)
    cons_flag = np.ones(3 * n_nodes, dtype=bool)
    disp_full = np.zeros(3 * n_nodes)
    for dof, val in cons_dofv.items():
        node, comp = dof // 3, dof % 3
        cons_flag[3 * mesh.node_pos[node] + comp] = False
        disp_full[3 * mesh.node_pos[node] + comp] = val

    # external force to reduced space
    f_full = np.zeros(3 * n_nodes)
    for dof, val in exte_forc.items():
        f_full[dof] += val
    f_lvl = prol[L].T @ (Pmat.T @ f_full)

    # ---- structured-grid fast path (GridInfo docstring): keep full grid
    # spaces, MASK Dirichlet dofs (decoupled diagonal) instead of
    # eliminating, and order nodes coordinate-lexicographically so every
    # level matrix is a pure stencil (DIA on device, sparse/dia.py)
    grids = None
    if (
        ordering in ("auto", "grid")
        and geom_mult
        and not node_rota
        and getattr(mesh, "coup_reps", -1) == -1
    ):
        grids = _detect_grids(mesh, cum, L)
    if grids is not None:
        n_solve = 3 * int(cum[L + 1])
        fixed = np.nonzero(~cons_flag[:n_solve])[0]
        lift = np.zeros(n_solve)
        lift[fixed] = disp_full[fixed]

        Gs, Zs, cons_stif = [], [], []
        for l in levels:
            nl = orig[l].shape[0]
            flags = cons_flag[:nl]
            G = _grid_perm(grids[l][1])
            Z = sp.diags(flags.astype(float))
            d = orig[l].diagonal()
            mask_diag = sp.diags(
                np.where(flags, 0.0, np.where(d > 0, d, 1.0))
            )
            Am = (Z @ orig[l] @ Z + mask_diag).tocsr()
            cons_stif.append((G @ Am @ G.T).tocsr())
            Gs.append(G)
            Zs.append(Z)
        real_prol = [
            (Gs[l + 1] @ (Zs[l + 1] @ prol[l] @ Zs[l]) @ Gs[l].T).tocsr()
            for l in range(L)
        ]
        cons_forc = Gs[L] @ (
            cons_flag[:n_solve] * (f_lvl - orig[L] @ lift)
        )
        expand = (Pmat @ prol[L] @ Zs[L] @ Gs[L].T).tocsr()
        expand_const = Pmat @ (prol[L] @ lift)

        shapes, strides, zmaps = [], [], []
        for l in range(L + 1):
            ux, uy, uz = grids[l][0]
            shapes.append((uz.size, uy.size, ux.size))
        for l in range(L):
            (uxc, uyc, uzc), _ = grids[l]
            (uxf, uyf, uzf), _ = grids[l + 1]
            sx = 1 if uxc.size == 1 else int(
                np.searchsorted(uxf, uxc)[1]
            )
            sy = 1 if uyc.size == 1 else int(np.searchsorted(uyf, uyc)[1])
            sz = 1 if uzc.size == 1 else int(np.searchsorted(uzf, uzc)[1])
            strides.append((sz, sy, sx))
            # coarse grid-flat -> fine grid-flat node map
            pz = np.searchsorted(uzf, uzc)
            py = np.searchsorted(uyf, uyc)
            px = np.searchsorted(uxf, uxc)
            ZZ, YY, XX = np.meshgrid(pz, py, px, indexing="ij")
            zmaps.append(
                ((ZZ * uyf.size + YY) * uxf.size + XX).ravel()
            )
        return ConstrainedSystem(
            cons_stif=cons_stif,
            real_prol=real_prol,
            cons_forc=cons_forc,
            expand=expand,
            expand_const=expand_const,
            grid=GridInfo(shapes=shapes, strides=strides, zmaps=zmaps),
        )

    cons_stif: list[sp.csr_matrix] = []
    selectors: dict[int, sp.csr_matrix] = {}
    for l in levels:
        nl = orig[l].shape[0]
        keep = np.nonzero(cons_flag[:nl])[0]
        C = sp.csr_matrix(
            (np.ones(keep.size), (np.arange(keep.size), keep)), shape=(keep.size, nl)
        )
        selectors[l] = C
        cons_stif.append((C @ orig[l] @ C.T).tocsr())

    # reduced RHS with Dirichlet lift at the finest level
    C_L = selectors[L]
    fixed = np.nonzero(~cons_flag[:n_solve])[0]
    lift = np.zeros(n_solve)
    lift[fixed] = disp_full[fixed]
    cons_forc = C_L @ f_lvl - C_L @ (orig[L] @ lift)

    real_prol = []
    if geom_mult:
        for l in range(L):
            real_prol.append(
                (selectors[l + 1] @ prol[l] @ selectors[l].T).tocsr()
            )

    # expansion operator: reduced -> full original-order displacement
    # u_full = Pmat @ prol[L] @ (C_L^T u + lift); rotation NOT re-applied here
    # (matches OUTP_SUB1; OUTP_SUB2 applies nodeRota on output only).
    expand = (Pmat @ prol[L] @ C_L.T).tocsr()
    expand_const = Pmat @ (prol[L] @ lift)

    # RCM bandwidth reordering of every reduced space: clusters each row's
    # couplings into few 128-column blocks, which sets the storage/time of
    # the block-ELL SpMV (sparse/bell.py; mean column-blocks per 8-row block
    # drops ~3x vs insertion order) and the gather locality of ELL.  Pure permutation —
    # all downstream operators compose with ``expand`` so stay consistent.
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    Q = []
    for l, A_l in enumerate(cons_stif):
        p = reverse_cuthill_mckee(A_l, symmetric_mode=True)
        nl = A_l.shape[0]
        Q.append(
            sp.csr_matrix(
                (np.ones(nl), (np.arange(nl), p)), shape=(nl, nl)
            )
        )  # x_new = Q x_old
        cons_stif[l] = (Q[l] @ A_l @ Q[l].T).tocsr()
    for l in range(len(real_prol)):
        real_prol[l] = (Q[l + 1] @ real_prol[l] @ Q[l].T).tocsr()
    cons_forc = Q[-1] @ cons_forc
    expand = (expand @ Q[-1].T).tocsr()

    sysm = ConstrainedSystem(
        cons_stif=[cons_stif[i] for i in range(len(cons_stif))],
        real_prol=real_prol,
        cons_forc=cons_forc,
        expand=expand,
        expand_const=expand_const,
    )
    return sysm
