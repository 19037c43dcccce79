"""Result-file writers, matching the reference's output contract.

The reference writes per-body/per-region text files consumed by
Postprocess.m (SURVEY.md section 5): resuNode_/resuElem_ (mesh),
resuDisp_ (displacements), resuStre_ (recovered stresses + von Mises),
resuCont_ (contact pressure / friction state at integral points),
resuInpo_ (integral points), resuMoni.txt (convergence monitors).
Formats follow MULTIGRID.h:680-708,1288-1307,1411-1431 and
MCONTACT.h:97-123: whitespace-separated scientific notation columns.
"""

from __future__ import annotations

import os

import numpy as np

from ..fem.elasticity import (
    elastic_matrix,
    element_stress_projection,
    von_mises,
)
from ..mesh.hexmesh import HexMesh


def _fmt(path: str, arr: np.ndarray, int_cols: bool = False) -> None:
    arr = np.atleast_2d(arr)
    with open(path, "w") as f:
        for row in arr:
            if int_cols:
                f.write("".join(f"{int(v):>10d}" for v in row) + "\n")
            else:
                f.write("".join(f"{v:>30.20e}" for v in row) + "\n")


def write_mesh(outdir: str, mesh: HexMesh, ident) -> None:
    """OUTPUT_ELEMENT (MULTIGRID.h:680-708)."""
    os.makedirs(outdir, exist_ok=True)
    _fmt(os.path.join(outdir, f"resuNode_{ident}.txt"), mesh.coords)
    leaves = mesh.leaf_elems()
    _fmt(
        os.path.join(outdir, f"resuElem_{ident}.txt"),
        mesh.elem_corn[leaves],
        int_cols=True,
    )


def write_displacement(
    outdir: str, full_disp: np.ndarray, ident, node_rota=None
) -> None:
    """OUTP_SUB2 (MULTIGRID.h:1288-1307): rotate back nodal frames."""
    os.makedirs(outdir, exist_ok=True)
    d = full_disp.reshape(-1, 3).copy()
    if node_rota:
        for i, R in node_rota.items():
            d[i] = R @ d[i]
    _fmt(os.path.join(outdir, f"resuDisp_{ident}.txt"), d)


def stress_recovery(
    mesh: HexMesh, full_disp: np.ndarray, e_mod: float, nu: float,
    node_rota=None,
) -> np.ndarray:
    """STRESS_RECOVERY (MULTIGRID.h:1316-1433): per-element L2 projection of
    Gauss stresses to nodes, averaged over elements; hanging nodes also
    receive averages from their parent entities.  Returns (N,7) with von
    Mises in the last column."""
    disp = full_disp.copy()
    if node_rota:
        d = disp.reshape(-1, 3)
        for i, R in node_rota.items():
            d[i] = R @ d[i]
        disp = d.reshape(-1)
    D = elastic_matrix(e_mod, nu)
    leaves = mesh.leaf_elems()
    corn = mesh.elem_corn[leaves]                    # (E,8)
    dofs = (3 * corn[:, :, None] + np.arange(3)).reshape(-1, 24)
    nodal = element_stress_projection(
        mesh.coords[corn], disp[dofs], D
    )                                                # (E,8,6)

    acc = np.zeros((mesh.n_nodes, 6))
    cnt = np.zeros(mesh.n_nodes)
    np.add.at(acc, corn.ravel(), nodal.reshape(-1, 6))
    np.add.at(cnt, corn.ravel(), 1.0)
    # hanging-node / parent-entity averaging (MULTIGRID.h:1379-1408)
    if mesh.cono_fino:
        from ..utils.quadrature import HEX_EDGES, HEX_FACES

        for e_i, e in enumerate(leaves):
            cn = mesh.elem_corn[e]
            # corners that are parents of hanging nodes contribute directly
            for a in range(8):
                fc = mesh.fino_cono.get(int(cn[a]))
                if fc is not None:
                    for p in fc:
                        acc[p] += nodal[e_i, a]
                        cnt[p] += 1.0
            for table in (HEX_EDGES, HEX_FACES):
                for row in table:
                    key = tuple(int(v) for v in np.sort(cn[row]))
                    h = mesh.cono_fino.get(key)
                    if h is not None:
                        avg = nodal[e_i, row].mean(axis=0)
                        acc[h] += avg
                        cnt[h] += 1.0
    cnt = np.where(cnt == 0, 1.0, cnt)
    stre = acc / cnt[:, None]
    return np.concatenate([stre, von_mises(stre)[:, None]], axis=1)


def write_stress(outdir: str, stre7: np.ndarray, ident) -> None:
    os.makedirs(outdir, exist_ok=True)
    _fmt(os.path.join(outdir, f"resuStre_{ident}.txt"), stre7)


def write_contact(outdir: str, gamma: np.ndarray, basis: np.ndarray,
                  scalar: bool, ident) -> None:
    """OUTPUT_PRTR (MCONTACT.h:97-123): contact pressure (+ tangential
    traction vector and friction state in vector mode)."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"resuCont_{ident}.txt")
    if scalar:
        _fmt(path, gamma[:, None])
    else:
        g = gamma.reshape(-1, 3)
        tang = g[:, 1:2] * basis[:, 1, :] + g[:, 2:3] * basis[:, 2, :]
        _fmt(path, np.concatenate([g[:, 0:1], tang], axis=1))


def write_integral_points(outdir: str, ip, ident) -> None:
    """OUTPUT_INPO (CSEARCH.h:819-837)."""
    os.makedirs(outdir, exist_ok=True)
    arr = np.concatenate(
        [ip.points[0], ip.points[1], ip.gap[:, None]], axis=1
    )
    _fmt(os.path.join(outdir, f"resuInpo_{ident}.txt"), arr)


def write_moni(outdir: str, history: np.ndarray) -> None:
    """resuMoni.txt (MCONTACT.h:2502,2742,2835): per-iteration convergence
    monitors — column 0 is the ADMM iteration, then one monitor column per
    body (du) followed by one per region side (dz) in the loop's order.

    Deliberate deviation from the reference: each column is the
    scale-invariant *ratio* ||d.||^2 / ||.||^2, not the raw squared norm the
    reference records (MCONTACT.h:2738-2742).  Raw squared norms underflow
    f32 (1e-12-scale increments square to ~1e-24), so the solve loop
    monitors the ratio against the criterion 1e-12 directly; convergence
    semantics are identical (the reference compares vals <= 1e-12 * allow,
    i.e. the same ratio test, MCONTACT.h:2760)."""
    os.makedirs(outdir, exist_ok=True)
    history = np.atleast_2d(np.asarray(history))
    rows = np.column_stack([np.arange(len(history), dtype=float), history])
    _fmt(os.path.join(outdir, "resuMoni.txt"), rows)


def write_aula(outdir: str, z: np.ndarray, lam: np.ndarray, scalar: bool,
               ident: int, side: int) -> None:
    """OUTPUT_AULA (MCONTACT.h:125-155): per interface node, the ADMM
    auxiliary z components then the multiplier lambda components (1 each in
    scalar mode, 3 each in vector mode)."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"resuAula_{ident}_{side}.txt")
    if scalar:
        arr = np.stack([z, lam], axis=1)
    else:
        arr = np.concatenate([z.reshape(-1, 3), lam.reshape(-1, 3)], axis=1)
    _fmt(path, arr)


def write_segments(outdir: str, ip, ident: int) -> None:
    """OUTPUT_COSE (CSEARCH.h:178-203): the 4 node ids of every master /
    slave face participating in the region, in SEARCH order — taken from the
    accepted candidate-pair records (``ip.seg_nodes``), so faces whose
    integration points were later filtered still appear, exactly like the
    reference's per-pair output; falls back to the surviving integral-point
    quadruples (first-seen order) for legacy IntegralPoints."""
    os.makedirs(outdir, exist_ok=True)
    for side in (0, 1):
        nodes = np.asarray(
            ip.nodes[side]
            if getattr(ip, "seg_nodes", None) is None
            else ip.seg_nodes[side]
        )
        if nodes.size:
            _, first = np.unique(nodes, axis=0, return_index=True)
            faces = nodes[np.sort(first)]
        else:
            faces = nodes.reshape(0, 4)
        with open(
            os.path.join(outdir, f"resuSegm_{ident}_{side}.txt"), "w"
        ) as f:
            for row in faces:
                f.write("".join(f"{int(v):10d}" for v in row) + "\n")


def write_lagrange(outdir: str, lagr: np.ndarray, status: np.ndarray,
                   node_ids: np.ndarray, fric: float, ident: int) -> None:
    """resuLagr_<ts>.txt (MCONTACT.h:3613-3636): per non-mortar node — node
    id, active state (0/1/2), normal multiplier, tangential multipliers
    (sliding nodes report mu*lambda_n, 0 like the reference)."""
    os.makedirs(outdir, exist_ok=True)
    lagr = lagr.reshape(-1, 3)
    with open(os.path.join(outdir, f"resuLagr_{ident}.txt"), "w") as f:
        for k, nid in enumerate(node_ids):
            st = int(status[k])
            ln = lagr[k, 0]
            if st != 1:
                t1, t2 = lagr[k, 1], lagr[k, 2]
            else:
                t1, t2 = fric * ln, 0.0
            f.write(
                f"{int(nid):10d}{st:10d}"
                + "".join(f"{v:30.20e}" for v in (ln, t1, t2))
                + "\n"
            )
