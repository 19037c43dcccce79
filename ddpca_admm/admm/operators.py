"""ADMM interface-operator assembly (MCONTACT::ESTABLISH re-design).

Builds, per contact/interface region and side, the sparse operators of
MCONTACT.h:181-896 — penalty mass ``systMass`` (added to the body stiffness),
body-interface coupling ``systTran``(+pena), interface Gram matrices
``inteMass``(+pere/pena), integral-point interpolation ``inpoLagr`` /
``inpoDisp`` / ``inteInpo``, penalties ``pemaInpo`` and gaps ``inpoNgap``.

Two DOF modes, exactly as the reference dispatches on the friction
coefficient (MCONTACT.h:15-17):
  * ``scalar``  (fricCoef == 0, frictionless contact): 1 DOF per interface
    node, operators contracted with the master normal;
  * ``vector``  (fricCoef != 0: perfect interface < 0, Coulomb > 0): 3 DOF
    per interface node in the (n, t1, t2) frame.

Design choice: every operator that the hot loop applies against body
displacements is pre-composed with the body's reduced-space expansion
``X`` (and its constant Dirichlet part), so the jitted ADMM loop never
touches full 3N-DOF vectors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..contact.search import IntegralPoints
from ..fem.constraints import _rotation_blockdiag


@dataclass
class Region:
    """One contact/interface region (a searCont slot + its wiring)."""

    ip: IntegralPoints
    bodies: tuple[int, int]          # (master body, slave body)
    fric: float                      # <0 perfect, 0 frictionless, >0 Coulomb
    pena_n: float
    pena_f: float

    @property
    def mode(self) -> str:
        return "scalar" if self.fric == 0.0 else "vector"


@dataclass
class RegionSideOps:
    """Host (scipy) operators for one (region, side)."""

    cont_nodes: np.ndarray           # (m,) body node ids in interface order
    syst_mass: sp.csr_matrix         # (3N, 3N) penalty stiffness
    syst_tran: sp.csr_matrix         # (3N, mdof)
    syst_tran_pena: sp.csr_matrix    # (3N, mdof)
    inte_mass: sp.csr_matrix         # (mdof, mdof)
    inte_mass_pena: sp.csr_matrix
    inpo_lagr: sp.csr_matrix         # (idof, mdof)
    inpo_disp: sp.csr_matrix         # (idof, 3N)
    inte_inpo: sp.csr_matrix         # (mdof, idof)
    # cross-body couplings for the coarse-space corrections (MULTISCALE_1,
    # MCONTACT.h:1765-1804, 2155-2244); rotations applied on both sides
    cross_mass: sp.csr_matrix        # (3N_self, 3N_mate): w N^T T'PT N_mate
    cross_tran: sp.csr_matrix        # (3N_mate, mdof_self): w N_m^T T'(T N_c)
    self_mass_rot: sp.csr_matrix     # (3N, 3N): rot^T systMass-core rot


@dataclass
class RegionOps:
    region: Region
    sides: tuple[RegionSideOps, RegionSideOps]
    pema: np.ndarray                 # (idof,) penalty diagonal
    ngap: np.ndarray                 # (idof,) initial gaps (normal slot)
    # per-side body nodal rotation dicts (needed by the coarse corrections,
    # whose dispUnba/globTran_D rotate the body rows like systTran does)
    node_rota: tuple = ({}, {})


def _interface_numbering(ip: IntegralPoints, side: int) -> tuple[np.ndarray, np.ndarray]:
    """First-appearance numbering of interface nodes (nodeCont,
    MCONTACT.h:189-212).  Returns (unique node ids (m,), per-ip-node
    interface indices (n,4))."""
    flat = ip.nodes[side].reshape(-1)
    uniq, idx = np.unique(flat, return_inverse=True)
    return uniq, idx.reshape(-1, 4)


def _rotation_gather(node_rota: dict[int, np.ndarray], nodes: np.ndarray) -> np.ndarray:
    """(n,4,3,3) rotation matrices for the given (n,4) node array."""
    out = np.broadcast_to(np.eye(3), nodes.shape + (3, 3)).copy()
    if node_rota:
        for (i, j), nid in np.ndenumerate(nodes):
            R = node_rota.get(int(nid))
            if R is not None:
                out[i, j] = R
    return out


def build_region_ops(
    reg: Region,
    n_nodes: tuple[int, int],
    node_rota: tuple[dict[int, np.ndarray], dict[int, np.ndarray]] = ({}, {}),
) -> RegionOps:
    """Assemble all side operators for one region.

    ``n_nodes``: node counts of (master body, slave body);
    ``node_rota``: per-side nodal rotation dicts (cylindrical frames).
    """
    ip = reg.ip
    n = ip.n
    scalar = reg.mode == "scalar"
    w = ip.weight                                     # (n,)
    nrm = ip.basis[:, 0, :]                           # (n,3)
    T = ip.basis                                      # (n,3,3) rows n,t1,t2
    P3 = np.diag([reg.pena_n, reg.pena_f, reg.pena_f])

    sides = []
    for tv in range(2):
        uniq, cidx = _interface_numbering(ip, tv)
        m = uniq.size
        shape = ip.shape[tv]                          # (n,4)
        nodes = ip.nodes[tv]                          # (n,4)
        rot = _rotation_gather(node_rota[tv], nodes)  # (n,4,3,3)
        NN = 3 * n_nodes[tv]

        if scalar:
            mdof, idof = m, n
            # nN (1x12): per ip, per node a, 3 comps: shape_a * n_k
            nN = shape[:, :, None] * nrm[:, None, :]              # (n,4,3)
            nN_rot = np.einsum("nak,nakj->naj", nN, rot)          # rot^T applied
            # systMass: w * rho_n * (nN)^T (nN) -- no rotation in reference
            blk = w[:, None, None, None, None] * reg.pena_n * np.einsum(
                "nak,nbl->nakbl", nN, nN
            )
            rows = (3 * nodes[:, :, None, None, None] + np.arange(3)[None, None, :, None, None])
            cols = (3 * nodes[:, None, None, :, None] + np.arange(3)[None, None, None, None, :])
            rows = np.broadcast_to(rows, blk.shape).ravel()
            cols = np.broadcast_to(cols, blk.shape).ravel()
            syst_mass = sp.coo_matrix((blk.ravel(), (rows, cols)), shape=(NN, NN)).tocsr()
            # systTran: w * rot^T nN^T M_e  (3N x m)
            st = w[:, None, None, None] * np.einsum(
                "naj,nb->najb", nN_rot, shape
            )                                                     # (n,4,3,4)
            rows = np.broadcast_to(
                (3 * nodes[:, :, None, None] + np.arange(3)[None, None, :, None]),
                st.shape,
            ).ravel()
            cols = np.broadcast_to(cidx[:, None, None, :], st.shape).ravel()
            syst_tran = sp.coo_matrix((st.ravel(), (rows, cols)), shape=(NN, m)).tocsr()
            syst_tran_pena = (reg.pena_n * syst_tran).tocsr()
            # inteMass: w M^T M (m x m)
            im = w[:, None, None] * shape[:, :, None] * shape[:, None, :]
            rows = np.broadcast_to(cidx[:, :, None], im.shape).ravel()
            cols = np.broadcast_to(cidx[:, None, :], im.shape).ravel()
            inte_mass = sp.coo_matrix((im.ravel(), (rows, cols)), shape=(m, m)).tocsr()
            inte_mass_pena = (reg.pena_n * inte_mass).tocsr()
            # inpoLagr: (n x m) rows of shape functions
            rows = np.broadcast_to(np.arange(n)[:, None], shape.shape).ravel()
            inpo_lagr = sp.coo_matrix(
                (shape.ravel(), (rows, cidx.ravel())), shape=(n, m)
            ).tocsr()
            # inpoDisp: (n x 3N): row = n . N . rot
            nd = np.einsum("nak,nakj->naj", nN, rot)              # (n,4,3)
            rows = np.broadcast_to(np.arange(n)[:, None, None], nd.shape).ravel()
            cols = (3 * nodes[:, :, None] + np.arange(3)[None, None, :]).ravel()
            inpo_disp = sp.coo_matrix((nd.ravel(), (rows, cols)), shape=(n, NN)).tocsr()
            # inteInpo: (m x n) = sign * w M^T
            sgn = -1.0 if tv == 0 else 1.0
            ii = sgn * w[:, None] * shape
            rows = cidx.ravel()
            cols = np.broadcast_to(np.arange(n)[:, None], shape.shape).ravel()
            inte_inpo = sp.coo_matrix((ii.ravel(), (rows, cols)), shape=(m, n)).tocsr()
        else:
            mdof, idof = 3 * m, 3 * n
            # TN: (n, 3 frame-comps, 4 nodes, 3 disp-comps)
            TN = shape[:, None, :, None] * T[:, :, None, :]
            TN_rot = np.einsum("nfak,nakj->nfaj", TN, rot)
            TtPT = np.einsum("nfi,fg,ngj->nij", T, P3, T)          # (n,3,3)
            TtT = np.einsum("nfi,nfj->nij", T, T)
            TtPinvT = np.einsum(
                "nfi,fg,ngj->nij", T, np.linalg.inv(P3), T
            )

            def _blk12(core):  # core (n,3,3) -> (n,4,3,4,3) N^T core N
                return (
                    w[:, None, None, None, None]
                    * shape[:, :, None, None, None]
                    * shape[:, None, None, :, None]
                    * core[:, None, :, None, :]
                )

            # systMass: rows/cols in body dofs, no rotation (MCONTACT.h:282-319)
            blk = _blk12(TtPT)
            rows = np.broadcast_to(
                3 * nodes[:, :, None, None, None] + np.arange(3)[None, None, :, None, None],
                blk.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * nodes[:, None, None, :, None] + np.arange(3)[None, None, None, None, :],
                blk.shape,
            ).ravel()
            syst_mass = sp.coo_matrix((blk.ravel(), (rows, cols)), shape=(NN, NN)).tocsr()

            # systTran(=w rot^T N^T T^T T N_c) and _pena (with P)
            def _tran(core):
                t = (
                    w[:, None, None, None, None]
                    * shape[:, :, None, None, None]
                    * shape[:, None, None, :, None]
                    * core[:, None, :, None, :]
                )                                                  # (n,4,3,4,3)
                # rows to the body node's LOCAL frame: f_loc = R^T f_glob
                # (reference: tempRota.transpose() * matr, MCONTACT.h:392-394;
                # contracting rot's FIRST matrix index = R^T — contracting the
                # second is R, which silently diverged the DEHW hub whose
                # rotated nodes sit on DD interfaces)
                t = np.einsum("najbl,najk->nakbl", t, rot)
                rows = np.broadcast_to(
                    3 * nodes[:, :, None, None, None]
                    + np.arange(3)[None, None, :, None, None],
                    t.shape,
                ).ravel()
                cols = np.broadcast_to(
                    3 * cidx[:, None, None, :, None]
                    + np.arange(3)[None, None, None, None, :],
                    t.shape,
                ).ravel()
                return sp.coo_matrix(
                    (t.ravel(), (rows, cols)), shape=(NN, mdof)
                ).tocsr()

            syst_tran = _tran(TtT)
            syst_tran_pena = _tran(TtPT)

            def _gram(core):
                g = _blk12(core)
                rows = np.broadcast_to(
                    3 * cidx[:, :, None, None, None]
                    + np.arange(3)[None, None, :, None, None],
                    g.shape,
                ).ravel()
                cols = np.broadcast_to(
                    3 * cidx[:, None, None, :, None]
                    + np.arange(3)[None, None, None, None, :],
                    g.shape,
                ).ravel()
                return sp.coo_matrix(
                    (g.ravel(), (rows, cols)), shape=(mdof, mdof)
                ).tocsr()

            inte_mass = _gram(TtT)
            inte_mass_pena = _gram(TtPT)

            # inpoLagr: (3n x 3m): rows T N at ip
            il = shape[:, None, :, None] * T[:, :, None, :]        # (n,f,a,k)
            # value at frame-comp f from interface dof (node a, comp k)
            rows = np.broadcast_to(
                3 * np.arange(n)[:, None, None, None] + np.arange(3)[None, :, None, None],
                il.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * cidx[:, None, :, None] + np.arange(3)[None, None, None, :],
                il.shape,
            ).ravel()
            inpo_lagr = sp.coo_matrix(
                (il.ravel(), (rows, cols)), shape=(idof, mdof)
            ).tocsr()

            # inpoDisp: (3n x 3N): T N rot
            idm = TN_rot                                           # (n,f,a,j)
            rows = np.broadcast_to(
                3 * np.arange(n)[:, None, None, None] + np.arange(3)[None, :, None, None],
                idm.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * nodes[:, None, :, None] + np.arange(3)[None, None, None, :],
                idm.shape,
            ).ravel()
            inpo_disp = sp.coo_matrix(
                (idm.ravel(), (rows, cols)), shape=(idof, NN)
            ).tocsr()

            # inteInpo: (3m x 3n) = sign w N^T T^T
            sgn = -1.0 if tv == 0 else 1.0
            ii = sgn * w[:, None, None, None] * shape[:, None, :, None] * T[:, :, None, :]
            rows = np.broadcast_to(
                3 * cidx[:, None, :, None] + np.arange(3)[None, None, None, :],
                ii.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * np.arange(n)[:, None, None, None] + np.arange(3)[None, :, None, None],
                ii.shape,
            ).ravel()
            inte_inpo = sp.coo_matrix(
                (ii.ravel(), (rows, cols)), shape=(mdof, idof)
            ).tocsr()

        # ---- cross-body couplings (unrotated; rotation applied below)
        NN_m = 3 * n_nodes[1 - tv]
        nodes_m = ip.nodes[1 - tv]
        shape_m = ip.shape[1 - tv]
        if scalar:
            # cross mass: w rho_n (N^T n^T)(n N_m)
            nN_m = shape_m[:, :, None] * nrm[:, None, :]          # (n,4,3)
            cm = w[:, None, None, None, None] * reg.pena_n * np.einsum(
                "nak,nbl->nakbl", nN, nN_m
            )
            rows = np.broadcast_to(
                3 * nodes[:, :, None, None, None]
                + np.arange(3)[None, None, :, None, None],
                cm.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * nodes_m[:, None, None, :, None]
                + np.arange(3)[None, None, None, None, :],
                cm.shape,
            ).ravel()
            cross_mass = sp.coo_matrix(
                (cm.ravel(), (rows, cols)), shape=(NN, NN_m)
            ).tocsr()
            # cross tran: w N_m^T n^T M_e  (3N_mate x m_self)
            nN_m2 = shape_m[:, :, None] * nrm[:, None, :]
            ct = w[:, None, None, None] * np.einsum(
                "naj,nb->najb", nN_m2, shape
            )
            rows = np.broadcast_to(
                3 * nodes_m[:, :, None, None] + np.arange(3)[None, None, :, None],
                ct.shape,
            ).ravel()
            cols = np.broadcast_to(cidx[:, None, None, :], ct.shape).ravel()
            cross_tran = sp.coo_matrix(
                (ct.ravel(), (rows, cols)), shape=(NN_m, m)
            ).tocsr()
        else:
            cm = (
                w[:, None, None, None, None]
                * shape[:, :, None, None, None]
                * shape_m[:, None, None, :, None]
                * TtPT[:, None, :, None, :]
            )
            rows = np.broadcast_to(
                3 * nodes[:, :, None, None, None]
                + np.arange(3)[None, None, :, None, None],
                cm.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * nodes_m[:, None, None, :, None]
                + np.arange(3)[None, None, None, None, :],
                cm.shape,
            ).ravel()
            cross_mass = sp.coo_matrix(
                (cm.ravel(), (rows, cols)), shape=(NN, NN_m)
            ).tocsr()
            ct = (
                w[:, None, None, None, None]
                * shape_m[:, :, None, None, None]
                * shape[:, None, None, :, None]
                * TtT[:, None, :, None, :]
            )
            rows = np.broadcast_to(
                3 * nodes_m[:, :, None, None, None]
                + np.arange(3)[None, None, :, None, None],
                ct.shape,
            ).ravel()
            cols = np.broadcast_to(
                3 * cidx[:, None, None, :, None]
                + np.arange(3)[None, None, None, None, :],
                ct.shape,
            ).ravel()
            cross_tran = sp.coo_matrix(
                (ct.ravel(), (rows, cols)), shape=(NN_m, mdof)
            ).tocsr()
        R_self = _rotation_blockdiag(n_nodes[tv], node_rota[tv])
        R_mate = _rotation_blockdiag(n_nodes[1 - tv], node_rota[1 - tv])
        self_mass_rot = (R_self.T @ syst_mass @ R_self).tocsr()
        cross_mass = (R_self.T @ cross_mass @ R_mate).tocsr()
        cross_tran = (R_mate.T @ cross_tran).tocsr()

        sides.append(
            RegionSideOps(
                cont_nodes=uniq,
                syst_mass=syst_mass,
                syst_tran=syst_tran,
                syst_tran_pena=syst_tran_pena,
                inte_mass=inte_mass,
                inte_mass_pena=inte_mass_pena,
                inpo_lagr=inpo_lagr,
                inpo_disp=inpo_disp,
                inte_inpo=inte_inpo,
                cross_mass=cross_mass,
                cross_tran=cross_tran,
                self_mass_rot=self_mass_rot,
            )
        )

    if scalar:
        pema = np.full(n, reg.pena_n)
        ngap = ip.gap.copy()
    else:
        pema = np.tile([reg.pena_n, reg.pena_f, reg.pena_f], n)
        ngap = np.zeros(3 * n)
        ngap[0::3] = ip.gap
    return RegionOps(region=reg, sides=(sides[0], sides[1]), pema=pema,
                     ngap=ngap, node_rota=node_rota)
