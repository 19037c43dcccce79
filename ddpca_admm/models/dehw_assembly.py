"""Full DEHW assembly: the flagship 34-worm + 18-wheel-domain worm drive.

Re-design of the reference's DEHW problem construction (examples/DEHW.h):

  * WORM_MESH (DEHW.h:404-758): per circumferential domain, four structured
    blocks per axial section (hub / front transition / thread tooth / back
    transition) lofted along the thread, refined globInho times axially
    (pattern 6) then globHomo times fully (pattern 0) with bisection nodes
    snapped onto the four exact worm surfaces and cylindrically averaged
    elsewhere (COOR_AVER, DEHW.h:62-88).
  * WHEE_MESH_DD (DEHW.h:760-1122): per tooth x half, hub / root-transition /
    half-tooth blocks built in the unfolded-cone plane per face-width section
    (WHEE_UNCONE/WHEE_CONE), toroidally averaged refinement (COOR_AVER_1,
    DEHW.h:90-138).
  * Domain-interface bookkeeping: wodeAucu / whdeAucu / whdeAucu_midd
    auxiliary surfaces grown during refinement (UPDA_*, DEHW.h:1435-1503).
  * CONT_INTE_DD (DEHW.h:1505-2029): shrinking-criterion adaptive refinement
    of the 4 tooth-pair x 3 worm-domain contact zones, hub torque loading
    through cylindrical nodal frames (SUBR_COLO_*, DEHW.h:140-402), then
    mortar search over contact regions + all perfect domain interfaces.
  * No-DD variant (1 worm + 1 wheel domain, CONT_INTE_NODD,
    DEHW.h:2031-2175) for the monolithic cross-checks.

All geometry comes from models/dehw_surf.py (the enveloping-theory surface
engine, validated against the reference's own grid dumps).  Everything here
is host-side NumPy setup; the solve path is the shared jitted ADMM stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..contact.adaptive import adaptive_refine
from ..contact.search import surface_faces
from ..mesh.curveds import CurvedSurface, SparseSurface
from ..mesh.hexmesh import HexMesh
from ..utils.quadrature import QUAD_QUAD, surface_jacobian
from ..utils.timing import phase
from .dehw_surf import (
    PI,
    DehwGrid,
    DehwParams,
    DehwSurfaces,
    build_surfaces,
    whee_cone,
    whee_uncone,
)
from .simple import Body, char_length, make_region

HUB_TOL = 1.0e-10  # hub-radius identification tolerance (DEHW.h:99,161)


# ---------------------------------------------------------------------------
# placements & curvilinear averaging
# ---------------------------------------------------------------------------


def _rotz(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def worm_placement(p: DehwParams, cent_erro: float, anal_angl) -> tuple[np.ndarray, np.ndarray]:
    """Worm local frame (axis z) -> assembly frame (axis y through
    x = -(a_h2+centErro)), DEHW.h:407-417."""
    R = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]) @ _rotz(
        anal_angl[0]
    )
    t = np.array([-(p.a_h2 + cent_erro), 0.0, 0.0])
    return R, t


def coor_aver_worm(coords: np.ndarray) -> np.ndarray:
    """COOR_AVER (DEHW.h:62-88), batched: cylindrical average about the local
    worm axis z, with the reference's two-sided angle unwrap."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    r = np.hypot(x, y)
    ang = np.arctan2(y, x)
    n0 = (ang > PI / 2.0).sum(axis=-1)
    n1 = (ang < -PI / 2.0).sum(axis=-1)
    wrap = (n0 > 0) & (n1 > 0)
    ang_sum = ang.sum(axis=-1) + np.where(wrap, n1 * 2.0 * PI, 0.0)
    m = coords.shape[-2]
    a_mean = ang_sum / m
    r_mean = r.mean(axis=-1)
    return np.stack(
        [r_mean * np.cos(a_mean), r_mean * np.sin(a_mean), z.mean(axis=-1)],
        axis=-1,
    )


def make_coor_aver_whee(p: DehwParams, cent_erro: float):
    """COOR_AVER_1 (DEHW.h:90-138), batched: toroidal average about the ring
    radius a_h2+centErro (wheel local frame, axis z); plain cylindrical
    average when all corners sit on the wheel inner hub."""
    a = p.a_h2 + cent_erro
    hub_r = p.inne_radi[1]

    def fn(coords: np.ndarray) -> np.ndarray:
        x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
        r = np.hypot(x, y)
        ang = np.arctan2(y, x)
        n0 = (ang > PI / 2.0).sum(axis=-1)
        n1 = (ang < -PI / 2.0).sum(axis=-1)
        wrap = (n0 > 0) & (n1 > 0)
        m = coords.shape[-2]
        a_mean = (ang.sum(axis=-1) + np.where(wrap, n1 * 2.0 * PI, 0.0)) / m
        hub = (np.abs(r - hub_r) <= HUB_TOL).all(axis=-1)
        trad = a - r
        toru_r = np.hypot(trad, z).mean(axis=-1)
        toru_a = np.arctan2(z, trad).mean(axis=-1)
        r_fin = np.where(hub, r.mean(axis=-1), a - toru_r * np.cos(toru_a))
        z_fin = np.where(hub, z.mean(axis=-1), toru_r * np.sin(toru_a))
        return np.stack(
            [r_fin * np.cos(a_mean), r_fin * np.sin(a_mean), z_fin], axis=-1
        )

    return fn


# ---------------------------------------------------------------------------
# structured block helpers
# ---------------------------------------------------------------------------


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(1-t) a + t b with t broadcast on trailing axes."""
    return a * (1.0 - t) + b * t


def _block_elements(mesh: HexMesh, ids: np.ndarray) -> None:
    """Hexes from a (S, R, C) node-id grid with the reference corner order
    (DEHW.h:641-663): 0-3 in the (row, col) section plane, 4-7 at the next
    section (zeta = section axis -> pattern 6 splits along the thread)."""
    S, R, C = ids.shape
    s, r, c = np.meshgrid(
        np.arange(S - 1), np.arange(R - 1), np.arange(C - 1), indexing="ij"
    )
    s, r, c = s.ravel(), r.ravel(), c.ravel()
    corn = np.stack(
        [
            ids[s, r, c], ids[s, r + 1, c], ids[s, r + 1, c + 1], ids[s, r, c + 1],
            ids[s + 1, r, c], ids[s + 1, r + 1, c],
            ids[s + 1, r + 1, c + 1], ids[s + 1, r, c + 1],
        ],
        axis=-1,
    )
    mesh.add_elements(corn, level=0)


def _refine_with_surfaces(
    mesh: HexMesh,
    surfs: list[CurvedSurface],
    rounds_inho: int,
    rounds_homo: int,
    mid_fn,
    aux: list[SparseSurface] = (),
) -> None:
    """The WORM_MESH/WHEE_MESH_DD global-refinement loop (DEHW.h:664-749):
    globInho rounds of thread-axis bisection (pattern 6) then globHomo full
    rounds (pattern 0); bisection nodes snap to the exact surfaces, others
    use the cylindrical/toroidal average; auxiliary interface surfaces absorb
    their new nodes (UPDA_*)."""
    for tr in range(rounds_inho + rounds_homo):
        leaves = mesh.leaf_elems()
        mesh.elem_patt[leaves] = 6 if tr < rounds_inho else 0
        plan: dict = {}
        for s in surfs:
            s.plan_surf(mesh, leaves, plan)
        mesh.refine(set(int(x) for x in leaves), plan_surf=plan, mid_fn=mid_fn)
        for a in aux:
            a.update_from_refine(mesh, mesh.last_new_nodes)


# ---------------------------------------------------------------------------
# WORM_MESH (DEHW.h:404-758)
# ---------------------------------------------------------------------------


def build_worm_domains(
    surfs: DehwSurfaces,
    cent_erro: float = 0.0,
    anal_angl=(0.0, 0.0),
    dode: bool = True,
):
    """All worm domain meshes + interface bookkeeping, placed in the assembly
    frame.  Returns (meshes, wode_aucu [per domain: (front, back)
    SparseSurface], wode_auan [cut-plane azimuths, local frame])."""
    p, g = surfs.p, surfs.g
    wn0, wn1, wn2, wn3, wn4 = g.worm_numb
    n_end, n_doma = surfs.worm_ends, surfs.worm_domains
    fi, fj = g.fact_i, g.fact_j
    fr = 1 << (g.glob_inho + g.glob_homo)     # root-grid section factor
    fc = 1 << g.glob_homo                     # root-grid profile factor
    wf0, wf1 = fc, fr                         # wodeAucu index factors (DEHW.h:422-423)

    wsurf = [
        CurvedSurface(surfs.worm_tosu), CurvedSurface(surfs.worm_toba),
        CurvedSurface(surfs.worm_rtsu), CurvedSurface(surfs.worm_rtba),
    ]
    R_pl, t_pl = worm_placement(p, cent_erro, anal_angl)

    meshes: list[HexMesh] = []
    aucu: list[tuple[SparseSurface, SparseSurface]] = []
    auan = np.zeros(max(n_doma - 1, 0))
    n_dom_built = n_doma if dode else 1

    for tw in range(n_dom_built):
        if not dode:
            numb_star = 0
            numb_tw = wn4 * (n_doma - 2) + n_end * 2
        elif tw == 0:
            numb_star, numb_tw = 0, n_end
        elif tw == n_doma - 1:
            numb_star, numb_tw = n_end + (tw - 1) * wn4, n_end
        else:
            numb_star, numb_tw = n_end + (tw - 1) * wn4, wn4
        if dode and tw >= 1:
            # cut-plane azimuth between domains tw-1 and tw (DEHW.h:454-462)
            a = float(surfs.xi11[numb_star * fi])
            while a > PI:
                a -= 2.0 * PI
            auan[tw - 1] = a

        secs = numb_star + np.arange(numb_tw + 1)
        S = secs.size
        profF = surfs.worm_tosu[secs * fi][:, ::fj]      # (S, wn3+1, 3)
        profB = surfs.worm_toba[secs * fi][:, ::fj]
        root1 = surfs.worm_rtsu[secs * fr][:, ::fc]      # (S, wn0/2+1, 3)
        root2 = surfs.worm_rtba[secs * fr][:, ::fc]

        # blocCoor corners (DEHW.h:506-523): hub/transition radii per section
        pr1 = np.hypot(root1[:, 0, 0], root1[:, 0, 1])
        pr2 = np.hypot(root2[:, 0, 0], root2[:, 0, 1])
        tr1 = pr1 - PI / 4.0 * p.m_t
        tr2 = pr2 - PI / 4.0 * p.m_t

        def _scaled(base, radi, prof):
            out = base.copy()
            out[:, :2] *= (radi / prof)[:, None]
            return out

        c0 = _scaled(root1[:, 0], np.full(S, p.inne_radi[0]), pr1)  # hub front
        c1 = _scaled(root2[:, 0], np.full(S, p.inne_radi[0]), pr2)  # hub back
        c2 = _scaled(root2[:, 0], tr2, pr2)                          # tran back
        c3 = _scaled(root1[:, 0], tr1, pr1)                          # tran front
        mid23 = 0.5 * (c3 + c2)
        tipm = 0.5 * (profF[:, wn3] + profB[:, wn3])

        tk0 = (np.arange(wn0 + 1) / wn0)[None, None, :, None]
        tj0 = (np.arange(wn1 + 1) / wn1)[None, :, None, None]
        b0 = _lerp(
            _lerp(c0[:, None, None], c1[:, None, None], tk0),
            _lerp(c3[:, None, None], c2[:, None, None], tk0),
            tj0,
        )                                                   # (S, wn1+1, wn0+1, 3)

        h = wn0 // 2
        tkh = (np.arange(h + 1) / h)[None, None, :, None]
        tj1 = (np.arange(wn2 + 1) / wn2)[None, :, None, None]
        down1 = _lerp(c3[:, None, None], mid23[:, None, None], tkh)
        b1 = _lerp(down1, root1[:, None, :, :], tj1)        # (S, wn2+1, h+1, 3)

        # thread block (DEHW.h:579-613): front half flank->midline, back half
        tjl = (np.arange(wn3 + 1) / wn3)[None, :, None]
        midl = _lerp(mid23[:, None], tipm[:, None], tjl)    # (S, wn3+1, 3)
        tk2 = (np.arange(wn2 + 1) / wn2)[None, None, :, None]
        b2f = _lerp(profF[:, :, None], midl[:, :, None], tk2)
        b2b = _lerp(midl[:, :, None], profB[:, :, None], tk2)
        b2 = np.concatenate([b2f, b2b[:, :, 1:]], axis=2)   # (S, wn3+1, 2*wn2+1, 3)

        down3 = _lerp(mid23[:, None, None], c2[:, None, None], tkh)
        b3 = _lerp(down3, root2[:, None, ::-1, :], tj1)

        mesh = HexMesh()
        blocks = [b0, b1, b2, b3]
        ids = []
        for blk in blocks:
            Sb, Rb, Cb, _ = blk.shape
            ids.append(mesh.add_nodes(blk.reshape(-1, 3)).reshape(Sb, Rb, Cb))
        front = SparseSurface()
        back = SparseSurface()
        if dode:
            # wodeAucu: front = hub col 0 + transition-front col 0; back =
            # hub col wn0 + transition-back col h (DEHW.h:542-547,571-576,632-637)
            front.insert_grid(0, wf0, 0, wf1, b0[:, :, 0].transpose(1, 0, 2))
            front.insert_grid(wn1 * wf0, wf0, 0, wf1, b1[:, :, 0].transpose(1, 0, 2))
            back.insert_grid(0, wf0, 0, wf1, b0[:, :, wn0].transpose(1, 0, 2))
            back.insert_grid(wn1 * wf0, wf0, 0, wf1, b3[:, :, h].transpose(1, 0, 2))
        for nid in ids:
            _block_elements(mesh, nid)
        _refine_with_surfaces(
            mesh, wsurf, g.glob_inho, g.glob_homo, coor_aver_worm,
            aux=[front, back] if dode else [],
        )
        mesh.rigid_transform(R_pl, t_pl)
        front.rigid_transform(R_pl, t_pl)
        back.rigid_transform(R_pl, t_pl)
        meshes.append(mesh)
        aucu.append((front, back))
    return meshes, aucu, auan


# ---------------------------------------------------------------------------
# WHEE_MESH_DD / WHEE_MESH_NODD (DEHW.h:760-1433)
# ---------------------------------------------------------------------------


def _whee_section_profiles(surfs: DehwSurfaces, secs: np.ndarray):
    """Per-section wheel profiles in 3D and the unfolded-cone plane
    (DEHW.h:812-884)."""
    p, g = surfs.p, surfs.g
    wn0 = g.whee_numb[0]
    fi, fj = g.fact_i, g.fact_j
    fr = 1 << (g.glob_inho + g.glob_homo)
    fc = 1 << g.glob_homo

    a3 = surfs.alph3[secs * fi]                             # (S,)
    profF = surfs.whee_tosu[secs * fi][:, ::fj]             # (S, wn3+1, 3)
    profB = surfs.whee_toba[secs * fi][:, ::fj]
    pF2 = whee_uncone(p, profF, a3[:, None])
    pB2 = whee_uncone(p, profB, a3[:, None])
    root0 = whee_uncone(p, surfs.whee_rtsu[secs * fr][:, ::fc], a3[:, None])
    root1 = whee_uncone(p, surfs.whee_rtba[secs * fr][:, ::fc], a3[:, None])

    r1f = p.a_h2 / np.cos(a3) - (p.a_h2 - p.d_f[1] / 2.0)
    tran_radi = r1f - PI / 4.0 * p.m_t
    ang0 = np.arctan2(root0[:, 0, 1], root0[:, 0, 0])
    ang1 = np.arctan2(root1[:, 0, 1], root1[:, 0, 0])
    tt = np.arange(wn0 + 1) / wn0
    angs = ang0[:, None] + (ang1 - ang0)[:, None] * tt[None, :]
    tran0 = tran_radi[:, None, None] * np.stack(
        [np.cos(angs), np.sin(angs)], axis=-1
    )                                                       # (S, wn0+1, 2)
    tran1 = whee_cone(p, tran0, a3[:, None])                # (S, wn0+1, 3)
    r2 = np.hypot(tran1[..., 0], tran1[..., 1])
    inne = tran1.copy()
    inne[..., :2] *= (p.inne_radi[1] / r2)[..., None]
    return a3, profF, profB, pF2, pB2, root0, root1, tran0, tran1, inne


def build_whee_domains(
    surfs: DehwSurfaces,
    anal_angl=(0.0, 0.0),
    cent_erro: float = 0.0,
    dode: bool = True,
    cross_corner: bool = False,
):
    """Wheel domain meshes (teeth x halves when ``dode``; one mesh of all
    teeth otherwise) + the two DD auxiliary surfaces, placed in the assembly
    frame (wheel axis z; whole wheel rotated by analAngl[1] - 2*pitch,
    DEHW.h:763-769)."""
    p, g = surfs.p, surfs.g
    wn0, wn1, wn2, wn3, wn4 = g.whee_numb
    teeth = g.whee_teeth
    fr = 1 << (g.glob_inho + g.glob_homo)
    fc = 1 << g.glob_homo
    wf0, wf1 = fc, fr
    h = wn0 // 2

    secs = np.arange(wn4 + 1)
    (a3, profF, profB, pF2, pB2, root0, root1, tran0, tran1, inne) = (
        _whee_section_profiles(surfs, secs)
    )
    S = secs.size
    # block2 midline in the cone plane (DEHW.h:922-933)
    tipm = 0.5 * (pF2[:, wn3] + pB2[:, wn3])
    lin0 = tran0[:, h]
    tjl = (np.arange(wn3 + 1) / wn3)[None, :, None]
    line = _lerp(lin0[:, None], tipm[:, None], tjl)         # (S, wn3+1, 2)

    wsurf = [
        CurvedSurface(surfs.whee_tosu), CurvedSurface(surfs.whee_toba),
        CurvedSurface(surfs.whee_rtsu), CurvedSurface(surfs.whee_rtba),
    ]
    aver = make_coor_aver_whee(p, cent_erro)
    whee_rota = _rotz(anal_angl[1] - 2.0 * PI / p.z[1] * 2.0)
    zero = np.zeros(3)

    def _blocks(leri: int):
        tj0 = (np.arange(wn1 + 1) / wn1)[None, :, None, None]
        tk_sl = slice(leri * h, leri * h + h + 1)
        b0 = _lerp(inne[:, None, tk_sl], tran1[:, None, tk_sl], tj0)
        tj1 = (np.arange(wn2 + 1) / wn2)[None, :, None, None]
        tk2 = (np.arange(wn2 + 1) / wn2)[None, None, :, None]
        if leri == 0:
            b1_2d = _lerp(tran0[:, None, : h + 1], root0[:, None, :], tj1)
            b2_2d = _lerp(pF2[:, :, None], line[:, :, None], tk2)
            b3_2d = None
        else:
            b1_2d = None
            b2_2d = _lerp(line[:, :, None], pB2[:, :, None], tk2)
            b3_2d = _lerp(
                tran0[:, None, h:], root1[:, None, ::-1, :], tj1
            )
        out = [b0]
        for two_d in (b1_2d, b2_2d, b3_2d):
            if two_d is None:
                out.append(None)
            else:
                out.append(whee_cone(p, two_d, a3[:, None, None]))
        return out  # [b0 3d, b1 3d|None, b2 3d, b3 3d|None]

    blocks_by_leri = [_blocks(0), _blocks(1)]

    meshes: list[HexMesh] = []
    whde = SparseSurface()
    whde_midd = SparseSurface()
    n_teeth_built = teeth if dode else 1

    if dode and cross_corner:
        # ---- DEHW_1 cross-corner decomposition (examples/DEHW_1.h:762-812):
        # each tooth splits into face-width SECTION groups with FULL-width
        # blocks (blocPoin[1..3] span the whole tooth), so the DD cut planes
        # are constant-section surfaces that cross the contact zone corners.
        h4 = wn4 // 2   # numbFace = gridNumb[1][4] / gridNumb[1][6]
        tj0f = (np.arange(wn1 + 1) / wn1)[None, :, None, None]
        b0f = _lerp(inne[:, None, :], tran1[:, None, :], tj0f)
        tj1f = (np.arange(wn2 + 1) / wn2)[None, :, None, None]
        tk2f = (np.arange(wn2 + 1) / wn2)[None, None, :, None]
        b1f = whee_cone(
            p, _lerp(tran0[:, None, : h + 1], root0[:, None, :], tj1f),
            a3[:, None, None],
        )
        b2a = whee_cone(
            p, _lerp(pF2[:, :, None], line[:, :, None], tk2f),
            a3[:, None, None],
        )
        b2b = whee_cone(
            p, _lerp(line[:, :, None], pB2[:, :, None], tk2f),
            a3[:, None, None],
        )
        b3f = whee_cone(
            p, _lerp(tran0[:, None, h:], root1[:, None, ::-1, :], tj1f),
            a3[:, None, None],
        )
        blocks_full = [b0f, b1f, b2a, b2b, b3f]
        # within-tooth face-mid cut: every block's section-h4 grid, chained
        # at disjoint row offsets (constant-section surface; both in-plane
        # directions refine by wf0)
        r0 = 0
        for blk in blocks_full:
            g2 = blk[h4]                                   # (Rb, Cb, 3)
            whde_midd.insert_grid(r0, wf0, 0, wf0, g2)
            r0 += (g2.shape[0] + 2) * wf0
        # tooth-boundary surface: hub + right-root blocks at the full-width
        # edge (DEHW whde pattern, full sections)
        whde.insert_grid(0, wf0, 0, wf1, b0f[:, :, -1].transpose(1, 0, 2))
        whde.insert_grid(
            wn1 * wf0, wf0, 0, wf1, b3f[:, :, -1].transpose(1, 0, 2)
        )
        for toot in range(teeth):
            R_t = _rotz(2.0 * PI / p.z[1] * toot)
            for fg in range(2):
                sl = slice(fg * h4, fg * h4 + h4 + 1)
                mesh = HexMesh()
                for blk in blocks_full:
                    part = blk[sl]
                    Sb, Rb, Cb, _ = part.shape
                    nid = mesh.add_nodes(part.reshape(-1, 3)).reshape(
                        Sb, Rb, Cb
                    )
                    _block_elements(mesh, nid)
                # both cut surfaces absorb refined nodes from BOTH face
                # groups of tooth 0 (each cut borders both meshes)
                aux = [whde_midd, whde] if toot == 0 else []
                _refine_with_surfaces(
                    mesh, wsurf, g.glob_inho, g.glob_homo, aver, aux=aux
                )
                mesh.rigid_transform(R_t, zero)
                mesh.rigid_transform(whee_rota, zero)
                if toot == 0 and fg == 1:
                    for a in aux:
                        a.rigid_transform(R_t, zero)
                        a.rigid_transform(whee_rota, zero)
                meshes.append(mesh)
        return meshes, whde, whde_midd

    if dode:
        for toot in range(teeth):
            for leri in range(2):
                mesh = HexMesh()
                for blk in blocks_by_leri[leri]:
                    if blk is None:
                        continue
                    Sb, Rb, Cb, _ = blk.shape
                    nid = mesh.add_nodes(blk.reshape(-1, 3)).reshape(Sb, Rb, Cb)
                    _block_elements(mesh, nid)
                aux = []
                if toot == 0 and leri == 1:
                    b0, _, _, b3 = blocks_by_leri[1]
                    whde.insert_grid(0, wf0, 0, wf1, b0[:, :, h].transpose(1, 0, 2))
                    whde.insert_grid(
                        wn1 * wf0, wf0, 0, wf1, b3[:, :, h].transpose(1, 0, 2)
                    )
                    aux = [whde]
                if toot == 0 and leri == 0:
                    b0, _, b2, _ = blocks_by_leri[0]
                    whde_midd.insert_grid(
                        0, wf0, 0, wf1, b0[:, :, h].transpose(1, 0, 2)
                    )
                    whde_midd.insert_grid(
                        wn1 * wf0, wf0, 0, wf1, b2[:, :, wn2].transpose(1, 0, 2)
                    )
                    aux = [whde_midd]
                _refine_with_surfaces(
                    mesh, wsurf, g.glob_inho, g.glob_homo, aver, aux=aux
                )
                R_t = _rotz(2.0 * PI / p.z[1] * toot)
                mesh.rigid_transform(R_t, zero)
                mesh.rigid_transform(whee_rota, zero)
                for a in aux:
                    a.rigid_transform(R_t, zero)
                    a.rigid_transform(whee_rota, zero)
                meshes.append(mesh)
    else:
        # WHEE_MESH_NODD (DEHW.h:1124-1433): all teeth into one mesh; the
        # full-width blocks of both halves, rotated per tooth before insert
        mesh = HexMesh()
        for toot in range(teeth):
            R_t = _rotz(2.0 * PI / p.z[1] * toot)
            for leri in range(2):
                for blk in blocks_by_leri[leri]:
                    if blk is None:
                        continue
                    Sb, Rb, Cb, _ = blk.shape
                    nid = mesh.add_nodes(
                        (blk.reshape(-1, 3) @ R_t.T).reshape(-1, 3)
                    ).reshape(Sb, Rb, Cb)
                    _block_elements(mesh, nid)
        # refinement snaps to all teeth's surfaces (DEHW.h:1342-1367)
        all_surf = []
        for toot in range(teeth):
            R_t = _rotz(2.0 * PI / p.z[1] * toot)
            for s in wsurf:
                c = s.copy()
                c.rigid_transform(R_t, zero)
                all_surf.append(c)
        _refine_with_surfaces(
            mesh, all_surf, g.glob_inho, g.glob_homo, aver
        )
        mesh.rigid_transform(whee_rota, zero)
        meshes.append(mesh)
    return meshes, whde, whde_midd


# ---------------------------------------------------------------------------
# SUBR_COLO_* (DEHW.h:140-402): hub frames, constraints, torque loads
# ---------------------------------------------------------------------------


def _face_area(mesh: HexMesh, faces: np.ndarray) -> float:
    corners = mesh.coords[faces]
    area = 0.0
    for gq in range(QUAD_QUAD.n_gp):
        nat = QUAD_QUAD.points[gq]
        jac = surface_jacobian(
            np.broadcast_to(nat, (corners.shape[0], 2)), corners
        )
        area += QUAD_QUAD.weights[gq] * jac.sum()
    return float(area)


def _hub_pred_worm(p: DehwParams, cent_erro: float):
    a = p.a_h2 + cent_erro

    def pred(c):
        r = np.hypot(c[..., 0] + a, -c[..., 2])
        return np.abs(r - p.inne_radi[0]) <= HUB_TOL

    return pred


def _hub_pred_whee(p: DehwParams):
    def pred(c):
        return np.abs(np.hypot(c[..., 0], c[..., 1]) - p.inne_radi[1]) <= HUB_TOL

    return pred


def _hub_tangential_load(body: Body, faces: np.ndarray, load_incr: float) -> None:
    """Integrate the uniform tangential (local hoop) traction over hub faces
    into the local-frame DOF 3i+1 (DEHW.h:240-253)."""
    corners = body.mesh.coords[faces]
    for gq in range(QUAD_QUAD.n_gp):
        nat = QUAD_QUAD.points[gq]
        N = QUAD_QUAD.shape[gq]
        jac = surface_jacobian(
            np.broadcast_to(nat, (corners.shape[0], 2)), corners
        )
        contrib = QUAD_QUAD.weights[gq] * jac[:, None] * N[None, :] * load_incr
        for f in range(faces.shape[0]):
            for k in range(4):
                d = 3 * int(faces[f, k]) + 1
                body.exte_forc[d] = body.exte_forc.get(d, 0.0) + float(
                    contrib[f, k]
                )


def subr_colo_worm(body: Body, p: DehwParams, cent_erro: float,
                   load_incr: float, driving: bool) -> None:
    """Worm hub: cylindrical nodal frames about the worm axis, radial+axial
    constraints, tangential torque traction (driving) or a free-rotation
    regularizer (self-locking), DEHW.h:183-278."""
    a = p.a_h2 + cent_erro
    c = body.mesh.coords
    xl = c[:, 0] + a
    yl = -c[:, 2]
    r = np.hypot(xl, yl)
    hub = np.nonzero(np.abs(r - p.inne_radi[0]) <= HUB_TOL)[0]
    for i in hub:
        th = np.arctan2(yl[i], xl[i])
        ct, st = np.cos(th), np.sin(th)
        # columns = (radial, hoop, axial) in global coords (DEHW.h:193-196)
        body.node_rota[int(i)] = np.array(
            [[ct, -st, 0.0], [0.0, 0.0, 1.0], [-st, -ct, 0.0]]
        )
        body.cons_dofv[3 * int(i) + 0] = 0.0
        body.cons_dofv[3 * int(i) + 2] = 0.0
    faces = surface_faces(body.mesh, _hub_pred_worm(p, cent_erro))
    if driving:
        _hub_tangential_load(body, faces, load_incr)
    else:
        for i in hub:
            d = 3 * int(i) + 1
            body.exte_forc[d] = body.exte_forc.get(d, 0.0) + 1.0e-10


def subr_colo_whee(body: Body, p: DehwParams, load_incr: float,
                   driving_worm: bool) -> None:
    """Wheel hub: fully fixed when the worm drives; cylindrical frames +
    torque traction when the wheel drives (self-locking), DEHW.h:325-400."""
    c = body.mesh.coords
    r = np.hypot(c[:, 0], c[:, 1])
    hub = np.nonzero(np.abs(r - p.inne_radi[1]) <= HUB_TOL)[0]
    if driving_worm:
        for i in hub:
            for k in range(3):
                body.cons_dofv[3 * int(i) + k] = 0.0
        return
    for i in hub:
        th = np.arctan2(c[i, 1], c[i, 0])
        ct, st = np.cos(th), np.sin(th)
        body.node_rota[int(i)] = np.array(
            [[ct, -st, 0.0], [st, ct, 0.0], [0.0, 0.0, 1.0]]
        )
        body.cons_dofv[3 * int(i) + 0] = 0.0
        body.cons_dofv[3 * int(i) + 2] = 0.0
    faces = surface_faces(body.mesh, _hub_pred_whee(p))
    _hub_tangential_load(body, faces, load_incr)


# ---------------------------------------------------------------------------
# full problem construction (DEHW::SOLVE + CONT_INTE_DD)
# ---------------------------------------------------------------------------


@dataclass
class DehwDDConfig:
    """DEHW assembly configuration (DEHW.cpp menus + DEHW.h:2217-2260)."""

    params: DehwParams = None
    grid: DehwGrid = None
    drive: str = "worm"          # "worm" (coloSett=1) | "wheel" (self-locking)
    dode: bool = True            # domain decomposition (menu 0 vs 1)
    tape_coef: float = 25.0      # tangential penalty coefficient (DEHW.h:6)
    char_fact: float = 25.0
    cent_erro: float = 0.0
    e_worm: float = 210.0e9
    e_whee: float = 110.0e9      # DEHW.h:2248
    musc_sett: int = 1           # whadCosp default = bit0 (DEHW.h:8)
    cross_corner: bool = False   # DEHW_1 wheel decomposition (DEHW_1.h)
    dole: int = 1                # doleMcsc (DEHW.h:2239)
    dist_crit: tuple | None = None
    anal_angl: tuple = (0.0, 0.0)
    stru_scal: float = 1.0
    max_search_dist: float | None = None
    # perfect domain interfaces coincide by construction; pairs whose minimum
    # gap exceeds this are bend-adjacency ghosts of the mortar projection
    # (the reference keeps everything, maxiDist=1e12, and relies on its finer
    # bucket grids to never pair them -- filtering is strictly safer)
    iface_max_dist: float = 1.0e-7

    def __post_init__(self):
        if self.params is None:
            self.params = DehwParams()
        if self.grid is None:
            self.grid = DehwGrid()
        if self.dist_crit is None:
            # DEHW.h:2229-2234
            self.dist_crit = (
                (55.0e-6, 35.0e-6, 15.0e-6)
                if self.drive == "worm"
                else (65.0e-6, 45.0e-6, 25.0e-6)
            )


def build_dehw_assembly(cfg: DehwDDConfig | None = None, surfs=None):
    """Full DEHW problem: meshes, AMR, hub loading, contact + interface
    regions.  Returns (bodies, regions, info); feed to
    :func:`finalize_dehw_problem` for the device problem."""
    cfg = cfg or DehwDDConfig()
    p, g = cfg.params, cfg.grid
    if surfs is None:
        surfs = build_surfaces(p, g)

    with phase("DEHW::WORM_MESH"):
        worm_meshes, wode_aucu, wode_auan = build_worm_domains(
            surfs, cfg.cent_erro, cfg.anal_angl, dode=cfg.dode
        )
    with phase("DEHW::WHEE_MESH"):
        whee_meshes, whde, whde_midd = build_whee_domains(
            surfs, cfg.anal_angl, cfg.cent_erro, dode=cfg.dode,
            cross_corner=cfg.cross_corner,
        )
    n_worm = len(worm_meshes)
    bodies = [Body(mesh=m, e_mod=cfg.e_worm) for m in worm_meshes] + [
        Body(mesh=m, e_mod=cfg.e_whee) for m in whee_meshes
    ]
    char_leng = char_length(bodies)   # before AMR (DEHW.h:1507)

    # ---- contact surfaces per tooth pair (DEHW.h:1526-1549)
    R_pl, t_pl = worm_placement(p, cfg.cent_erro, cfg.anal_angl)
    mast_surf = CurvedSurface(surfs.worm_tosu)
    mast_surf.rigid_transform(R_pl, t_pl)
    slav_surfs = []
    for tt in range(4):
        s = CurvedSurface(surfs.whee_tosu)
        s.rigid_transform(
            _rotz(cfg.anal_angl[1] + 2.0 * PI / p.z[1] * (1.0 + tt)),
            np.zeros(3),
        )
        slav_surfs.append(s)

    a_ce = p.a_h2 + cfg.cent_erro

    def cart_curv(c):
        c = np.asarray(c)
        return np.stack(
            [c[..., 1], np.hypot(c[..., 0] + a_ce, c[..., 2])], axis=-1
        )

    # contact pairs (DEHW.h:1521-1524); no-DD: 4x the single pair (0,1)
    if cfg.dode:
        if cfg.cross_corner:
            # DEHW_1: the contact zone spans BOTH face-group domains of the
            # tooth (the DD corner crosses it) -> 6 pairs per tooth pair
            pairs = [
                [
                    (2 + 8 * tt + tc, n_worm + 6 + 2 * tt + fg)
                    for tc in range(3)
                    for fg in range(2)
                ]
                for tt in range(4)
            ]
        else:
            pairs = [
                [(2 + 8 * tt + tc, n_worm + 6 + 2 * tt) for tc in range(3)]
                for tt in range(4)
            ]
    else:
        pairs = [[(0, 1)] for _ in range(4)]

    # ---- shrinking-criterion AMR (DEHW.h:1551-1571)
    gigh = g.glob_inho + g.glob_homo
    isno_refi: list[list[bool]] = []
    _amr = phase("DEHW::CONT_INTE_DD local mesh refinement"); _amr.__enter__()
    for tt in range(4):
        flags = [False] * len(pairs[tt])
        for tr in range(g.loca_leve):
            buck_fact = 1 << max(gigh + tr - 1, 0)
            buck = (
                max(1, g.worm_numb[4] * (1 if cfg.dode else surfs.worm_domains))
                * buck_fact,
                max(1, g.worm_numb[3]) * buck_fact,
            )
            for tc, (mb, sb) in enumerate(pairs[tt]):
                flags[tc] = adaptive_refine(
                    bodies[mb].mesh, bodies[sb].mesh,
                    mast_surf, slav_surfs[tt],
                    level=gigh + tr, dist_crit=cfg.dist_crit[tr],
                    buck_divisions=buck, cart_curv=cart_curv,
                )
        isno_refi.append(flags)
    _amr.__exit__(None, None, None)
    if g.loca_leve == 0:
        # reduced configs without AMR keep every candidate pair
        isno_refi = [[True] * len(pairs[tt]) for tt in range(4)]

    # ---- hub loading (DEHW.h:1572-1583)
    driving = cfg.drive == "worm"
    worm_hub_area = sum(
        _face_area(b.mesh, surface_faces(b.mesh, _hub_pred_worm(p, cfg.cent_erro)))
        for b in bodies[:n_worm]
    )
    whee_hub_area = sum(
        _face_area(b.mesh, surface_faces(b.mesh, _hub_pred_whee(p)))
        for b in bodies[n_worm:]
    )
    load_incr = (
        p.inpu_torq / p.inne_radi[0] / worm_hub_area,
        -p.inpu_torq * p.i_h2 / p.inne_radi[1] / whee_hub_area,
    )
    for b in bodies[:n_worm]:
        subr_colo_worm(b, p, cfg.cent_erro, load_incr[0], driving)
    for b in bodies[n_worm:]:
        subr_colo_whee(b, p, load_incr[1], driving)

    # ---- regions: mu = 0.08 driving worm, 0.2 self-locking.  The driver's
    # ISNO_SELO menu returns 1-caid (DEHW.cpp:169-180), so menu 0 "driving
    # worm" is coloSett==1: worm hub loaded, wheel hub fixed (DEHW.h:183-258,
    # 325-338) and fricCoef = 0.08 (DEHW.h:1619); the self-locking analysis
    # (wheel driven) uses 0.2.
    fric = 0.08 if driving else 0.2
    mu_e = 0.5 * (cfg.e_worm + cfg.e_whee)
    pena_iw = cfg.e_worm * cfg.char_fact / char_leng
    pena_ih = cfg.e_whee * cfg.char_fact / char_leng
    pena_c = mu_e * cfg.char_fact / char_leng
    pena_cf = mu_e / char_leng * cfg.tape_coef
    tota_leve = gigh + g.loca_leve
    regions = []
    region_kinds = []
    max_dist = (
        cfg.max_search_dist
        if cfg.max_search_dist is not None
        else cfg.dist_crit[max(g.loca_leve - 1, 0)]
    )

    # contact regions (DEHW.h:1684-1729)
    buck_c = (
        max(1, g.worm_numb[4] * (1 if cfg.dode else surfs.worm_domains))
        * (1 << max(tota_leve - 1, 0)),
        max(1, g.worm_numb[3]) * (1 << max(tota_leve - 1, 0)),
    )
    for tt in range(4):
        for tc, (mb, sb) in enumerate(pairs[tt]):
            if not isno_refi[tt][tc]:
                continue
            regions.append(
                make_region(
                    bodies, mb, sb,
                    mast_surf.contains, slav_surfs[tt].contains,
                    cart_curv, buck_c,
                    fric=fric, pena_n=pena_c, pena_f=pena_cf,
                    max_dist=max_dist,
                )
            )
            region_kinds.append(("contact", tt, mb, sb))

    if cfg.dode:
        R_inv, t_inv = R_pl.T, -R_pl.T @ t_pl

        # worm adjacent-domain cut planes (DEHW.h:1731-1833)
        def plane_pred(auan):
            def pred(c):
                # local worm coords: R_pl^T (x - t_pl) (DEHW.h:1743-1755)
                loc = np.asarray(c) @ R_inv.T + t_inv
                ang = np.arctan2(loc[..., 1], loc[..., 0])
                return np.abs(ang + auan) < 1.0e-10

            return pred

        buck_wa = (
            max(1, g.worm_numb[0]) * (1 << max(g.glob_homo - 1, 0)),
            max(1, g.worm_numb[1]) * (1 << g.glob_homo),
        )
        for tv in range(n_worm - 1):
            pred = plane_pred(wode_auan[tv])
            regions.append(
                make_region(
                    bodies, tv, tv + 1, pred, pred, cart_curv, buck_wa,
                    fric=-1.0, pena_n=pena_iw,
                    max_abs_dist=cfg.iface_max_dist,
                )
            )
            region_kinds.append(("worm_adj", tv, tv, tv + 1))

        # worm turn-to-turn helical surfaces (DEHW.h:1835-1895)
        def cart_wt(c):
            c = np.asarray(c)
            return np.stack(
                [np.hypot(c[..., 0] + a_ce, -c[..., 2]), c[..., 1]], axis=-1
            )

        for tv in range(n_worm - g.circ_numb):
            n_sec = surfs.worm_ends if tv == 0 else g.worm_numb[4]
            buck_wt = (
                max(1, g.worm_numb[1]) * (1 << g.glob_homo),
                max(1, n_sec) * (1 << max(g.glob_inho + g.glob_homo - 1, 0)),
            )
            regions.append(
                make_region(
                    bodies, tv, tv + g.circ_numb,
                    wode_aucu[tv][0].contains,
                    wode_aucu[tv + g.circ_numb][1].contains,
                    cart_wt, buck_wt, fric=-1.0, pena_n=pena_iw,
                    max_abs_dist=cfg.iface_max_dist,
                )
            )
            region_kinds.append(("worm_turn", tv, tv, tv + g.circ_numb))

        # wheel within-tooth + tooth-to-tooth (DEHW.h:1897-2027)
        def cart_wh(c):
            c = np.asarray(c)
            return np.stack(
                [np.hypot(c[..., 0], c[..., 1]), c[..., 2]], axis=-1
            )

        buck_wm = (
            max(1, (g.whee_numb[1] + g.whee_numb[3]))
            * (1 << max(g.glob_homo - 1, 0)),
            max(1, g.whee_numb[4]) * (1 << max(g.glob_inho + g.glob_homo - 1, 0)),
        )
        def cart_wh_sect(c):
            # constant-section cut surfaces: (radius, azimuth) chart — the
            # (r, z) chart degenerates there (profile is a curve in (r, z))
            c = np.asarray(c)
            return np.stack(
                [np.hypot(c[..., 0], c[..., 1]),
                 np.arctan2(c[..., 1], c[..., 0])], axis=-1
            )

        for ti in range(g.whee_teeth):
            s = whde_midd.copy()
            s.rigid_transform(_rotz(2.0 * PI / p.z[1] * ti), np.zeros(3))
            tv0 = n_worm + 2 * ti
            regions.append(
                make_region(
                    bodies, tv0, tv0 + 1, s.contains, s.contains,
                    cart_wh_sect if cfg.cross_corner else cart_wh,
                    buck_wm, fric=-1.0, pena_n=pena_ih,
                    max_abs_dist=cfg.iface_max_dist,
                )
            )
            region_kinds.append(("whee_midd", ti, tv0, tv0 + 1))
        buck_wh = (
            max(1, g.whee_numb[1]) * (1 << g.glob_homo),
            max(1, g.whee_numb[4]) * (1 << max(g.glob_inho + g.glob_homo - 1, 0)),
        )
        for ti in range(g.whee_teeth - 1):
            s = whde.copy()
            s.rigid_transform(_rotz(2.0 * PI / p.z[1] * ti), np.zeros(3))
            if cfg.cross_corner:
                # tooth boundary joins the SAME face group of adjacent teeth
                for fg in range(2):
                    tv0 = n_worm + 2 * ti + fg
                    tv1 = n_worm + 2 * (ti + 1) + fg
                    regions.append(
                        make_region(
                            bodies, tv0, tv1, s.contains, s.contains,
                            cart_wh, buck_wh, fric=-1.0, pena_n=pena_ih,
                            max_abs_dist=cfg.iface_max_dist,
                        )
                    )
                    region_kinds.append(("whee_teeth", ti, tv0, tv1))
            else:
                tv0 = n_worm + 2 * ti + 1
                regions.append(
                    make_region(
                        bodies, tv0, tv0 + 1, s.contains, s.contains,
                        cart_wh, buck_wh, fric=-1.0, pena_n=pena_ih,
                        max_abs_dist=cfg.iface_max_dist,
                    )
                )
                region_kinds.append(("whee_teeth", ti, tv0, tv0 + 1))

    info = dict(
        n_worm=n_worm, n_whee=len(whee_meshes), char_leng=char_leng,
        load_incr=load_incr, worm_hub_area=worm_hub_area,
        whee_hub_area=whee_hub_area, isno_refi=isno_refi,
        region_kinds=region_kinds, fric=fric,
        pena=dict(contact_n=pena_c, contact_f=pena_cf, worm=pena_iw,
                  whee=pena_ih),
        n_elems=[int(b.mesh.leaf_mask().sum()) for b in bodies],
        n_nodes=[b.mesh.n_nodes for b in bodies],
    )
    return bodies, regions, info


def finalize_dehw_problem(bodies, regions, cfg: DehwDDConfig):
    """assemble + build the device problem (DEHW.h:2266-2276)."""


    from ..admm.problem import build_problem
    from .simple import assemble_bodies

    systems = assemble_bodies(bodies, regions)
    # V-cycle preconditioner in the standard f32 policy (utils/precision.py):
    # an f64 hierarchy doubles the hierarchy's device memory for no
    # accuracy gain — it only preconditions.
    prob, meta = build_problem(
        systems, regions,
        dole=[cfg.dole] * len(bodies),
        musc_sett=cfg.musc_sett,
        meshes=[b.mesh for b in bodies],
    )
    return prob, meta
