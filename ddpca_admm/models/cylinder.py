"""CYLINDER example: Hertz line contact between elastic cylinders.

Re-design of examples/CYLINDER.{h,cpp}.  Each cylinder contributes two
mirror-image bodies ("left"/"right" halves); each half's cross-section is the
reference's 3-block transfinite mesh between the exact contact arc and
interior auxiliary polylines (CYLINDER.h:208-330), extruded axially.
Refinement: ``glob_inho`` in-plane rounds (pattern 1) + ``glob_homo`` full
rounds, then ``loca_leve`` rounds of *local* refinement of elements near the
predicted contact band (|x| <= band_widt, CYLINDER.h:364-429), with bisection
nodes snapped onto the exact circle by a CurvedSurface; the 2:1 rule grades
the transition.

Two builders: the default two-cylinder pair (fast Hertz validation), and
``build_cylinder_stack_model`` — the reference's full assembly of four
stacked quadrant sections x mirror halves x ``copy_numb`` axial copies
replicated by COPY+RIGI_ROTR (CYLINDER.h:440-551), with the CYLINDER_1
cross-corner variant (``cross_corner=True``).  Contact regions restrict
candidate faces to the band (CYLINDER.h:558-588), halves/copies are tied
(fric=-1), and the oracle is the analytic Hertz pressure profile
(CYLINDER.h:60-61):
  a = sqrt(4 F' R* / (pi E*)),  p_max = 2 F' / (pi a).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..admm.operators import RegionOps
from ..admm.problem import build_problem
from ..mesh.curveds import CurvedSurface
from ..mesh.hexmesh import HexMesh
from .simple import Body, assemble_bodies, char_length, make_region, penalty

TOL = 1.0e-10


@dataclass
class CylinderConfig:
    radi: tuple[float, float] = (0.02, 0.022)   # lower, upper cylinder radius
    leng: float = 0.02                           # axial length (per copy)
    divi: tuple[int, int, int, int] = (2, 2, 1, 2)  # side-arc, bottom-arc,
    # radial, axial base divisions (reference diviNumb row)
    glob_inho: int = 3
    glob_homo: int = 0
    loca_leve: int = 7
    band_widt: float = 100.0e-6
    load_inte: float = -50.0e3
    char_fact: float = 25.0
    e_mod: float = 210.0e9
    nu: float = 0.3
    # full-stack options (reference CYLINDER: 4 quadrant sections x 2 mirror
    # halves x copy_numb axial copies; CYLINDER_1: cross-corner variant with
    # 4 full-section bodies per copy and fixed penalty 210e9*1000)
    stack4: bool = False
    copy_numb: int = 1           # CYLINDER.h:41 copyNumb (reference: 16)
    cross_corner: bool = False   # CYLINDER_1.h variant

    @property
    def hertz(self) -> tuple[float, float]:
        """(half-width a, p_max) for the line contact."""
        r_eff = 1.0 / (1.0 / self.radi[0] + 1.0 / self.radi[1])
        e_eff = self.e_mod / (2.0 * (1.0 - self.nu**2))
        F = abs(self.load_inte)
        a = np.sqrt(4.0 * F * r_eff / (np.pi * e_eff))
        p_max = 2.0 * F / (np.pi * a)
        return a, p_max


# quadrant cross-section control points (CYLINDER.h:47-53): the meshed domain
# is bounded below by the arc (angles -pi..-3pi/8) and above by the polyline
# (-r/3,0) -> (-r/5,-r/2) -> (r/5,-r/2) and the diametral line y=0.
def _aux_points(r: float) -> list[np.ndarray]:
    return [
        np.array([-r / 3.0, 0.0]),
        np.array([-r / 5.0, -r / 2.0]),
        np.array([r / 5.0, -r / 2.0]),
    ]


_ANG = (-5.0 / 8.0 * np.pi, -3.0 / 8.0 * np.pi)


def _quadrant_blocks(cfg_r: float, div: tuple[int, int, int, int],
                     full: bool = False):
    """Cross-section node lattices of the transfinite blocks (local frame:
    cylinder center at origin, contact arc at the bottom).

    full=False: the half cross-section x<=0 (3 blocks, CYLINDER.h:208-330);
    full=True: the full cross-section (4 blocks: left side arc, full bottom
    arc, mirrored right side arc, interior — CYLINDER_1.h:196-325)."""
    d0, d1, d2, _ = div
    p0, p1, p2 = _aux_points(cfg_r)
    out = []
    # block 0: side arc (angles -pi.._ANG[0]) to line p0->p1
    ti = np.arange(d0 + 1) / d0
    up0 = (1 - ti)[:, None] * p0 + ti[:, None] * p1
    ang = -np.pi + (_ANG[0] + np.pi) * ti
    dn0 = cfg_r * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    tj = (np.arange(d2 + 1) / d2)[None, :, None]
    blk0 = (1 - tj) * dn0[:, None] + tj * up0[:, None]        # (d0+1,d2+1,2)
    out.append(blk0)
    if not full:
        # block 1: bottom arc half (angles _ANG[0]..mid) to p1->(mid of p1p2)
        th = np.arange(d1 // 2 + 1) / d1
        up1 = (1 - th)[:, None] * p1 + th[:, None] * p2
        ang = _ANG[0] + (_ANG[1] - _ANG[0]) * th
        dn1 = cfg_r * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        out.append((1 - tj) * dn1[:, None] + tj * up1[:, None])
        # block 2: line p1->mid(p1,p2) up to the diametral segment
        # (-r/3,0)->(0,0) (uppeLine_2 half, CYLINDER.h:228-231)
        up2 = np.stack(
            [(1 - th) * (-cfg_r / 3.0) + th * (cfg_r / 3.0),
             np.zeros_like(th)], axis=-1,
        )
        tk = (np.arange(d0 + 1) / d0)[None, :, None]
        out.append((1 - tk) * up1[:, None] + tk * up2[:, None])  # (d1/2+1,d0+1,2)
        return out
    # full cross-section (CYLINDER_1.h blocks 1-3)
    th = np.arange(d1 + 1) / d1
    up1 = (1 - th)[:, None] * p1 + th[:, None] * p2
    ang = _ANG[0] + (_ANG[1] - _ANG[0]) * th
    dn1 = cfg_r * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    out.append((1 - tj) * dn1[:, None] + tj * up1[:, None])   # (d1+1,d2+1,2)
    # block 2: mirrored side arc (x -> -x of block 0, reversed sweep)
    blk2 = blk0[::-1].copy()
    blk2[..., 0] = -blk2[..., 0]
    out.append(blk2)
    # block 3: full p1->p2 line up to the diametral line (-r/3..r/3)
    up2 = np.stack(
        [(1 - th) * (-cfg_r / 3.0) + th * (cfg_r / 3.0), np.zeros_like(th)],
        axis=-1,
    )
    tk = (np.arange(d0 + 1) / d0)[None, :, None]
    out.append((1 - tk) * up1[:, None] + tk * up2[:, None])   # (d1+1,d0+1,2)
    return out


def _contact_arc_surface(cfg: CylinderConfig, body_r: float, n_ang: int,
                         n_ax: int, place) -> CurvedSurface:
    """Exact bottom-arc cylinder surface grid (cyliSurf, CYLINDER.h:82-105)."""
    ang = _ANG[0] + (_ANG[1] - _ANG[0]) * np.arange(n_ang + 1) / n_ang
    z = cfg.leng * np.arange(n_ax + 1) / n_ax
    pts = np.zeros((n_ang + 1, n_ax + 1, 3))
    pts[..., 0] = body_r * np.cos(ang)[:, None]
    pts[..., 1] = body_r * np.sin(ang)[:, None]
    pts[..., 2] = z[None, :]
    return CurvedSurface(place(pts.reshape(-1, 3)).reshape(pts.shape))


def _section_mesh(cfg: CylinderConfig, r: float, place, full: bool,
                  y_contact: float) -> tuple[HexMesh, CurvedSurface]:
    """One quadrant cross-section extruded axially, refined globally
    (glob_inho pattern-1 + glob_homo pattern-0 rounds, CYLINDER.h:332-362)
    and locally around the contact band at |x| <= band_widt near the global
    contact plane y = y_contact (CYLINDER.h:364-429), with bisection nodes
    snapped onto the exact circle."""
    d0, d1, d2, d3 = cfg.divi
    m = HexMesh()
    from ..fem.elasticity import element_volumes

    for blk in _quadrant_blocks(r, cfg.divi, full=full):
        ni, nj, _ = blk.shape
        lat3 = np.zeros((ni, nj, d3 + 1, 3))
        lat3[..., 0] = blk[..., 0][:, :, None]
        lat3[..., 1] = blk[..., 1][:, :, None]
        lat3[..., 2] = cfg.leng * np.arange(d3 + 1) / d3
        coords = place(lat3.reshape(-1, 3))
        ids = m.add_nodes(coords).reshape(ni, nj, d3 + 1)
        ci, cj, ck = np.meshgrid(
            np.arange(ni - 1), np.arange(nj - 1), np.arange(d3), indexing="ij"
        )
        ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
        corn = np.stack(
            [
                ids[ci, cj, ck], ids[ci + 1, cj, ck],
                ids[ci + 1, cj + 1, ck], ids[ci, cj + 1, ck],
                ids[ci, cj, ck + 1], ids[ci + 1, cj, ck + 1],
                ids[ci + 1, cj + 1, ck + 1], ids[ci, cj + 1, ck + 1],
            ],
            axis=-1,
        )
        # placements with an odd number of reflections invert orientation
        if np.median(element_volumes(m.coords[corn])) < 0:
            corn = corn[:, [4, 5, 6, 7, 0, 1, 2, 3]]
        m.add_elements(corn, level=0)

    # the surface grid spans the FULL bottom arc with d1 base intervals
    # (CYLINDER.h:83: diviNumb[tg][1] * 2^(globInho+globHomo+locaLeve))
    n_ang = d1 * (1 << (cfg.glob_inho + cfg.glob_homo + cfg.loca_leve))
    n_ax = d3 * (1 << (cfg.glob_homo + cfg.loca_leve))
    arc = _contact_arc_surface(cfg, r, n_ang, n_ax, place)

    # global refinement with arc snapping
    for tr in range(cfg.glob_inho + cfg.glob_homo):
        patt = 1 if tr < cfg.glob_inho else 0
        leaves = m.leaf_elems()
        m.elem_patt[leaves] = patt
        plan = arc.plan_surf(m, leaves)
        m.refine(set(int(x) for x in leaves), plan_surf=plan)

    # local band refinement (CYLINDER.h:364-429)
    for tr in range(cfg.loca_leve):
        leaves = m.leaf_elems()
        corn = m.elem_corn[leaves]
        c = m.coords[corn]                       # (E,8,3)
        near_x = np.abs(c[..., 0]) <= cfg.band_widt
        near_y = np.abs(c[..., 1] - y_contact) <= 2.0 * cfg.band_widt
        mark = (near_x & near_y).any(axis=1)
        els = leaves[mark]
        if els.size == 0:
            break
        m.elem_patt[els] = 0
        plan = arc.plan_surf(m, els)
        spli = m.grle_check(set(int(x) for x in els))
        plan = arc.plan_surf(m, np.array(sorted(spli)), plan)
        m.refine(spli, plan_surf=plan)
    return m, arc


def _build_half(cfg: CylinderConfig, which: str, side: str) -> tuple[Body, CurvedSurface]:
    """One half-cylinder body.  which: 'lower'|'upper'; side: 'left'|'right'.

    Local frame: center origin, contact arc at bottom.  Placement:
      upper cylinder: y += r_up (arc touches y=0 from above);
      lower cylinder: rotate pi about z (arc to top), y -= r_lo.
    'right' mirrors x -> -x (reference bodies 4-7, CYLINDER.h:469-481).
    """
    r = cfg.radi[0] if which == "lower" else cfg.radi[1]

    leng = cfg.leng

    def place(c3):
        c3 = c3.copy()
        if side == "right":
            # proper rotation about y: x -> -x, z -> leng - z (det +1,
            # mirrors the half without inverting elements; CYLINDER.h:473-478)
            c3[:, 0] = -c3[:, 0]
            c3[:, 2] = leng - c3[:, 2]
        if which == "upper":
            c3[:, 1] += r
        else:
            # rotate pi about z: contact arc to the top, center below
            c3[:, 0] = -c3[:, 0]
            c3[:, 1] = -c3[:, 1] - r
        return c3

    m, arc = _section_mesh(cfg, r, place, full=False, y_contact=0.0)
    b = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
    # constraints (CYLINDER.h:432-449): lower diametral plane fixed; upper
    # diametral plane held in x,z (load applied there)
    if which == "lower":
        for i, co in enumerate(m.coords):
            if co[1] <= -cfg.radi[0] + TOL:
                for k in range(3):
                    b.cons_dofv[3 * i + k] = 0.0
    else:
        for i, co in enumerate(m.coords):
            if co[1] >= cfg.radi[1] - TOL:
                b.cons_dofv[3 * i + 0] = 0.0
                b.cons_dofv[3 * i + 2] = 0.0
    return b, arc


def build_cylinder_model(cfg: CylinderConfig = CylinderConfig()):
    if cfg.stack4 or cfg.cross_corner:
        return build_cylinder_stack_model(cfg)
    bodies = []
    arcs = []
    for which in ("lower", "upper"):
        for side in ("left", "right"):
            b, arc = _build_half(cfg, which, side)
            bodies.append(b)
            arcs.append(arc)
    # line load along the top center line (x=0, y=+r_up plane nodes),
    # trapezoid weights (CYLINDER.h:451-464); split across left/right halves
    d3 = cfg.divi[3]
    n_ax = d3 * (1 << cfg.glob_homo)
    incr = cfg.load_inte * cfg.leng / n_ax
    # trapezoid factors 0.5/0.25 are already per-half-body: summed over the
    # left+right bodies the total equals load_inte * leng (CYLINDER.h:451-464)
    for bi in (2, 3):
        b = bodies[bi]
        for i, co in enumerate(b.mesh.coords):
            if co[1] >= cfg.radi[1] - TOL and abs(co[0]) <= TOL:
                fact = 0.5
                if co[2] <= TOL or co[2] >= cfg.leng - TOL:
                    fact = 0.25
                dof = 3 * i + 1
                b.exte_forc[dof] = b.exte_forc.get(dof, 0.0) + fact * incr

    rho = penalty(cfg.char_fact, char_length(bodies), 210.0e9)
    regions: list[RegionOps] = []
    band = cfg.band_widt

    def band_pred(arc: CurvedSurface):
        def pred(c):
            return arc.contains(c) & (np.abs(c[..., 0]) <= band)

        return pred

    # contact pairs cross the mirror (reference contBody {0,5}/{4,1},
    # CYLINDER.h:513-518): the 'lower' placement flips x, so lower-left
    # covers x>=0 and pairs with upper-right (also x>=0), and vice versa
    n_bz = max(2, cfg.divi[3] * (1 << max(cfg.glob_homo + cfg.loca_leve - 1, 0)))
    for mast, slav in ((0, 3), (1, 2)):
        regions.append(
            make_region(
                bodies, mast, slav,
                band_pred(arcs[mast]), band_pred(arcs[slav]),
                lambda c: c[:, 0:3:2], (8, n_bz),
                fric=0.0, pena_n=rho,
            )
        )
    # left-right ties at x=0 (CYLINDER.h:540-551); fine buckets keep the
    # candidate pair count near-linear (matching meshes)
    n_by = max(8, 1 << (cfg.glob_inho + cfg.glob_homo + 2))
    for pair in ((0, 1), (2, 3)):
        regions.append(
            make_region(
                bodies, pair[0], pair[1],
                lambda c: np.abs(c[..., 0]) < TOL,
                lambda c: np.abs(c[..., 0]) < TOL,
                lambda c: c[:, 1:3], (n_by, max(4, n_bz // 2)),
                fric=-1.0, pena_n=rho,
            )
        )

    systems = assemble_bodies(bodies, regions)
    dole = [0] * len(systems)
    # reference CYLINDER uses muscSett=(1<<0): the LATIN macroscopic
    # correction (CYLINDER.h:42)
    prob, meta = build_problem(
        systems, regions, dole=dole, musc_sett=1,
        meshes=[b.mesh for b in bodies],
    )
    return prob, meta, bodies, cfg


def build_cylinder_stack_model(cfg: CylinderConfig):
    """Full reference CYLINDER assembly (CYLINDER.h:440-551): four stacked
    quadrant sections (radii r0/r1/r1/r0; sections 1 and 2 share the middle
    circle) x two mirror halves x copy_numb axial copies, built once per
    section and replicated by COPY + RIGI_ROTR (CYLINDER.h:469-497).

    cross_corner=True gives the CYLINDER_1 variant: full cross-sections (no
    mirror split, 4 bodies per copy), fixed penalty 210e9*1000
    (CYLINDER_1.h:517), and tie interfaces meeting contact zones at corners.

    Region wiring per copy ta (CYLINDER.h:512-549 / CYLINDER_1.h:510-545):
      mirror:       contacts (0,5),(4,1),(2,7),(6,3) + mid-circle (5,2),(1,6)
                    [fric=0]; ties (tb,tb+4) at x=0 and cross-copy (8ta+tb,
                    8(ta+1)+tb) [fric=-1]
      cross-corner: contacts (0,1),(2,3),(1,2) [fric=0]; cross-copy ties
                    (4ta+tb, 4(ta+1)+tb) [fric=-1]
    """
    import copy as _copy

    radi4 = (cfg.radi[0], cfg.radi[1], cfg.radi[1], cfg.radi[0])
    S = sum(radi4)
    r23 = radi4[2] + radi4[3]
    y_bot = radi4[0] - S          # contact plane sections 0-1
    y_top = -radi4[3]             # contact plane sections 2-3
    y_mid = -r23                  # shared circle diametral plane

    def place_tg(tg):
        def place(c3):
            c3 = np.asarray(c3, dtype=np.float64).copy()
            if tg == 0:
                c3[:, 0] = -c3[:, 0]
                c3[:, 1] = -c3[:, 1] - S
            elif tg == 1:
                c3[:, 1] -= r23
            elif tg == 2:
                c3[:, 0] = -c3[:, 0]
                c3[:, 1] = -c3[:, 1] - r23
            return c3

        return place

    full = cfg.cross_corner
    per_copy = 4 if full else 8
    n_ax = cfg.divi[3] * (1 << cfg.glob_homo)
    base: list[Body] = []
    base_arcs: list[CurvedSurface] = []
    for tg in range(4):
        y_c = y_bot if tg <= 1 else y_top
        m, arc = _section_mesh(cfg, radi4[tg], place_tg(tg), full=full,
                               y_contact=y_c)
        b = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
        # constraints (CYLINDER.h:432-449): section 0 fixed at its lowest
        # diametral plane; sections 1-3 held in x,z at theirs
        for i, co in enumerate(m.coords):
            if tg == 0 and co[1] <= -S + TOL:
                for k in range(3):
                    b.cons_dofv[3 * i + k] = 0.0
            elif tg in (1, 2) and abs(co[1] + r23) <= TOL:
                b.cons_dofv[3 * i + 0] = 0.0
                b.cons_dofv[3 * i + 2] = 0.0
            elif tg == 3 and co[1] >= -TOL:
                b.cons_dofv[3 * i + 0] = 0.0
                b.cons_dofv[3 * i + 2] = 0.0
        # line load on section 3 (CYLINDER.h:451-464 / CYLINDER_1.h:465-477)
        if tg == 3:
            incr = cfg.load_inte * cfg.leng / n_ax
            inner, ends = (1.0, 0.5) if full else (0.5, 0.25)
            for i, co in enumerate(m.coords):
                if co[1] >= -TOL and abs(co[0]) <= TOL:
                    fact = inner
                    if co[2] <= TOL or co[2] >= cfg.leng - TOL:
                        fact = ends
                    dof = 3 * i + 1
                    b.exte_forc[dof] = b.exte_forc.get(dof, 0.0) + fact * incr
        base.append(b)
        base_arcs.append(arc)

    def replicate(b: Body, arc: CurvedSurface, rot, trans):
        nb = Body(mesh=_copy.deepcopy(b.mesh), e_mod=b.e_mod, nu=b.nu,
                  cons_dofv=dict(b.cons_dofv), exte_forc=dict(b.exte_forc))
        nb.mesh.rigid_transform(rot, trans)
        na = arc.copy()
        na.rigid_transform(rot, trans)
        return nb, na

    eye = np.eye(3)
    mirr = np.diag([-1.0, 1.0, -1.0])
    bodies: list[Body] = []
    arcs: list[CurvedSurface] = []
    for tb in range(cfg.copy_numb):
        dz = np.array([0.0, 0.0, tb * cfg.leng])
        for b, a in zip(base, base_arcs):
            nb, na = replicate(b, a, eye, dz)
            bodies.append(nb)
            arcs.append(na)
        if not full:
            for b, a in zip(base, base_arcs):
                nb, na = replicate(b, a, mirr, dz + [0.0, 0.0, cfg.leng])
                bodies.append(nb)
                arcs.append(na)

    if cfg.cross_corner:
        rho = 210.0e9 * 1000.0                       # CYLINDER_1.h:517
    else:
        rho = penalty(cfg.char_fact, char_length(bodies), 210.0e9)

    def band_pred(arc: CurvedSurface):
        def pred(c):
            return arc.contains(c) & (np.abs(c[..., 0]) <= cfg.band_widt)

        return pred

    def plane_pred(axis: int, value: float):
        def pred(c):
            return np.abs(c[..., axis] - value) <= TOL

        return pred

    n_bz = max(2, cfg.divi[3] * (1 << max(cfg.glob_homo + cfg.loca_leve - 1, 0)))
    n_sec = max(8, 1 << (cfg.glob_inho + cfg.glob_homo + 1))
    regions: list[RegionOps] = []
    for ta in range(cfg.copy_numb):
        o = ta * per_copy
        pairs = (
            [(0, 1), (2, 3), (1, 2)] if full
            else [(0, 5), (4, 1), (2, 7), (6, 3), (5, 2), (1, 6)]
        )
        for k, (pm, ps) in enumerate(pairs):
            mid = (k == 2) if full else (k >= 4)
            if mid:
                pm_pred = plane_pred(1, y_mid)
                ps_pred = plane_pred(1, y_mid)
            else:
                pm_pred = band_pred(arcs[o + pm])
                ps_pred = band_pred(arcs[o + ps])
            regions.append(
                make_region(
                    bodies, o + pm, o + ps, pm_pred, ps_pred,
                    lambda c: c[:, 0:3:2],
                    (n_sec, n_bz) if mid else (8, n_bz),
                    fric=0.0, pena_n=rho,
                )
            )
        if not full:
            for tb in range(4):
                regions.append(
                    make_region(
                        bodies, o + tb, o + tb + 4,
                        plane_pred(0, 0.0), plane_pred(0, 0.0),
                        lambda c: c[:, 1:3], (n_sec, max(4, n_bz // 2)),
                        fric=-1.0, pena_n=rho,
                    )
                )
    for ta in range(cfg.copy_numb - 1):
        z_cut = (ta + 1) * cfg.leng
        for tb in range(per_copy):
            regions.append(
                make_region(
                    bodies, ta * per_copy + tb, (ta + 1) * per_copy + tb,
                    plane_pred(2, z_cut), plane_pred(2, z_cut),
                    lambda c: c[:, 0:2], (n_sec, n_sec),
                    fric=-1.0, pena_n=rho,
                )
            )

    systems = assemble_bodies(bodies, regions)
    dole_lv = min(2, cfg.glob_inho + cfg.glob_homo)  # doleMcsc (CYLINDER.h:172)
    prob, meta = build_problem(
        systems, regions, dole=[dole_lv] * len(systems), musc_sett=1,
        meshes=[b.mesh for b in bodies],
    )
    return prob, meta, bodies, cfg


def region_pressures(meta, state) -> dict[int, tuple[float, float]]:
    """(peak pressure, integrated normal force) of every frictionless
    region, keyed by global region index."""
    import numpy as np

    out = {}
    for g_i, mode in enumerate(meta.group_modes):
        gs = state.groups[g_i]
        for slot, ri in enumerate(meta.group_region_idx[g_i]):
            reg = meta.regions[ri].region
            if reg.fric < 0.0:
                continue
            ip = reg.ip
            gamma = np.asarray(gs.gamma[slot])
            gn = gamma[: ip.n] if mode == "scalar" else gamma[: 3 * ip.n : 3]
            out[ri] = (float(gn.max(initial=0.0)), float(gn @ ip.weight))
    return out
