"""BLOCK example: three stacked elastic blocks — the contact patch test.

Re-design of examples/BLOCK.{h,cpp}: blocks of edge length 0.03/0.025/0.02 m
stacked in z, pressure -1e7 Pa on top, frictionless contact between blocks,
domain decomposition of each block into domaNumb^3 core subdomains plus one
full-area thin "guard slab" at the bottom and top of each block (avoiding the
cross-corner problem, BLOCK.h:11-13).  Core subdomains refine with pattern 0,
slabs anisotropically with pattern 1 (xi,eta only, BLOCK.h:355) so every body
has the same multigrid depth.

Interfaces: perfect (fric=-1) between core subdomains and core<->slab;
frictionless contact (fric=0) between the facing slabs of adjacent blocks
(BLOCK.h:574-585).  Penalty rho = E*charFact/charLeng, charFact=25
(BLOCK.h:30,577).

Oracle: uniform stress sigma_zz = -1e7 through all non-matching interfaces,
displacement linear in z (the patch test, examples/BLOCK.cpp:43-49).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..admm.operators import RegionOps

from ..contact.search import mortar_integrate, surface_faces
from ..mesh.hexmesh import HexMesh
from ..utils.quadrature import quad4_shape
from .simple import (
    Body,
    apply_pressure,
    assemble_bodies,
    char_length,
    make_region,
    penalty,
    plane_predicate,
)

TOL = 1.0e-9


@dataclass
class BlockConfig:
    leng: tuple[float, float, float] = (0.03, 0.025, 0.02)
    divi: tuple[int, int, int] = (6, 6, 6)
    glob_leve: int = 4
    doma_numb: tuple[int, int, int] = (3, 3, 3)
    pressure: float = -1.0e7
    char_fact: float = 25.0
    e_mod: float = 210.0e9
    nu: float = 0.3
    # False = BLOCK_1 cross-corner variant (examples/BLOCK_1.h): no guard
    # slabs, subdomain corners meet on the contact interfaces, contact
    # regions pair top-layer cores of each block with the overlapping
    # bottom-layer cores of the next.
    guard_slabs: bool = True


@dataclass
class BlockModel:
    cfg: BlockConfig
    bodies: list[Body]
    regions: list[RegionOps]
    systems: list        # per-body ConstrainedSystem (host)
    n_core: int          # core subdomains per block
    slab_base: int       # index of first slab body
    # NOTE: the device problem is NOT built here — every caller passes its
    # own dole/musc_sett to build_problem; building one eagerly would double
    # the device-memory footprint (two full operator sets on the device).


def _z_offset(cfg: BlockConfig, tb: int) -> float:
    return float(sum(cfg.leng[:tb]))


def _slab_thickness(cfg: BlockConfig, tb: int) -> float:
    return cfg.leng[tb] / (cfg.divi[tb] * (1 << cfg.glob_leve))


def build_block_model(cfg: BlockConfig = BlockConfig()) -> BlockModel:
    d0, d1, d2 = cfg.doma_numb
    n_core = d0 * d1 * d2
    bodies: list[Body] = []

    # ---- core subdomains (BLOCK.h:195-294; BLOCK_1.h: slabs absorbed)
    for tb in range(3):
        L = cfg.leng[tb]
        dz = _slab_thickness(cfg, tb) if cfg.guard_slabs else 0.0
        z_lo = _z_offset(cfg, tb) + dz
        z_hi = _z_offset(cfg, tb) + L - dz
        div = cfg.divi[tb]
        assert div % d0 == 0 and div % d1 == 0 and div % d2 == 0
        nd = (div // d0, div // d1, div // d2)
        spac = np.array(
            [L / div, L / div, (z_hi - z_lo) / div]
        )
        for g0 in range(d0):
            for g1 in range(d1):
                for g2 in range(d2):
                    m = HexMesh()
                    origin = np.array(
                        [
                            -L / 2 + g0 * nd[0] * spac[0],
                            -L / 2 + g1 * nd[1] * spac[1],
                            z_lo + g2 * nd[2] * spac[2],
                        ]
                    )
                    m.add_box_grid(origin, spac, nd)
                    m.refine_uniform(cfg.glob_leve, pattern=0)
                    b = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
                    # rollers on the block's -x/-y planes; with guard slabs
                    # the z-extreme (slab-interface) node layers are skipped
                    # (BLOCK.h:280-291), without them they are kept
                    for i, c in enumerate(m.coords):
                        if cfg.guard_slabs and (
                            c[2] <= z_lo + 1e-12 or c[2] >= z_hi - 1e-12
                        ):
                            continue
                        if c[0] <= -L / 2 + 1e-12:
                            b.cons_dofv[3 * i + 0] = 0.0
                        if c[1] <= -L / 2 + 1e-12:
                            b.cons_dofv[3 * i + 1] = 0.0
                    if not cfg.guard_slabs and tb == 0 and g2 == 0:
                        for i, c in enumerate(m.coords):
                            if c[2] <= 1e-10:
                                b.cons_dofv[3 * i + 2] = 0.0
                    bodies.append(b)

    # ---- guard slabs (BLOCK.h:295-387): 2 per block, pattern-1 refinement
    slab_base = len(bodies)
    for tb in range(3) if cfg.guard_slabs else ():
        L = cfg.leng[tb]
        dz = _slab_thickness(cfg, tb)
        div = cfg.divi[tb]
        for bu in range(2):
            z0 = _z_offset(cfg, tb) + (0.0 if bu == 0 else L - dz)
            m = HexMesh()
            m.add_box_grid(
                np.array([-L / 2, -L / 2, z0]),
                np.array([L / div, L / div, dz]),
                (div, div, 1),
            )
            m.refine_uniform(cfg.glob_leve, pattern=1)
            b = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
            for i, c in enumerate(m.coords):
                if c[2] <= 1e-10:           # global bottom only
                    b.cons_dofv[3 * i + 2] = 0.0
                if c[0] <= -L / 2 + 1e-12:
                    b.cons_dofv[3 * i + 0] = 0.0
                if c[1] <= -L / 2 + 1e-12:
                    b.cons_dofv[3 * i + 1] = 0.0
            bodies.append(b)

    # ---- loads (BLOCK.h:377-384): top slab of block 2 gets full pressure;
    # top slabs of blocks 0/1 get the uncovered ring.  Cross-corner variant
    # (BLOCK_1.h): the same loads land on the top-layer cores directly.
    pres = np.array([0.0, 0.0, cfg.pressure])

    def core_idx(tb, g0, g1, g2):
        return tb * n_core + g0 * d1 * d2 + g1 * d2 + g2

    def top_layer(tb):
        return [
            bodies[core_idx(tb, g0, g1, d2 - 1)]
            for g0 in range(d0) for g1 in range(d1)
        ]

    if cfg.guard_slabs:
        apply_pressure(
            bodies[slab_base + 5],
            plane_predicate(2, _z_offset(cfg, 2) + cfg.leng[2], TOL),
            pres,
        )
        for tb in (0, 1):
            z_top = _z_offset(cfg, tb) + cfg.leng[tb]
            _ring_load(cfg, bodies[slab_base + 2 * tb + 1], tb, z_top, pres)
    else:
        z2 = _z_offset(cfg, 2) + cfg.leng[2]
        for b in top_layer(2):
            apply_pressure(b, plane_predicate(2, z2, TOL), pres)
        for tb in (0, 1):
            z_top = _z_offset(cfg, tb) + cfg.leng[tb]
            for b in top_layer(tb):
                _ring_load(cfg, b, tb, z_top, pres)

    # ---- regions
    ch_len = char_length(bodies)
    rho = penalty(cfg.char_fact, ch_len, 210.0e9)
    regions: list[RegionOps] = []

    fine = [cfg.divi[tb] * (1 << cfg.glob_leve) for tb in range(3)]
    for tb in range(3):
        L = cfg.leng[tb]
        dz = _slab_thickness(cfg, tb) if cfg.guard_slabs else 0.0
        z_lo = _z_offset(cfg, tb) + dz
        z_hi = _z_offset(cfg, tb) + L - dz
        bdiv = (
            fine[tb] // d0,
            fine[tb] // d1,
            fine[tb] // d2,
        )
        for g0 in range(d0):
            for g1 in range(d1):
                for g2 in range(d2):
                    me = core_idx(tb, g0, g1, g2)
                    if g0 < d0 - 1:
                        x = -L / 2 + (g0 + 1) * L / d0
                        regions.append(
                            make_region(
                                bodies, me, core_idx(tb, g0 + 1, g1, g2),
                                plane_predicate(0, x, TOL),
                                plane_predicate(0, x, TOL),
                                lambda c: c[:, 1:3], (bdiv[1], bdiv[2]),
                                fric=-1.0, pena_n=rho,
                            )
                        )
                    if g1 < d1 - 1:
                        y = -L / 2 + (g1 + 1) * L / d1
                        regions.append(
                            make_region(
                                bodies, me, core_idx(tb, g0, g1 + 1, g2),
                                plane_predicate(1, y, TOL),
                                plane_predicate(1, y, TOL),
                                lambda c: c[:, 0:3:2], (bdiv[0], bdiv[2]),
                                fric=-1.0, pena_n=rho,
                            )
                        )
                    if g2 < d2 - 1:
                        z = z_lo + (g2 + 1) * (z_hi - z_lo) / d2
                        regions.append(
                            make_region(
                                bodies, me, core_idx(tb, g0, g1, g2 + 1),
                                plane_predicate(2, z, TOL),
                                plane_predicate(2, z, TOL),
                                lambda c: c[:, 0:2], (bdiv[0], bdiv[1]),
                                fric=-1.0, pena_n=rho,
                            )
                        )
        # core <-> slabs
        if cfg.guard_slabs:
            for bu in range(2):
                slab = slab_base + 2 * tb + bu
                z = z_lo if bu == 0 else z_hi
                for g0 in range(d0):
                    for g1 in range(d1):
                        g2 = 0 if bu == 0 else d2 - 1
                        regions.append(
                            make_region(
                                bodies, core_idx(tb, g0, g1, g2), slab,
                                plane_predicate(2, z, TOL),
                                plane_predicate(2, z, TOL),
                                lambda c: c[:, 0:2], (bdiv[0], bdiv[1]),
                                fric=-1.0, pena_n=rho,
                            )
                        )
    if cfg.guard_slabs:
        # contact between blocks: top slab of tb <-> bottom slab of tb+1
        for tb in range(2):
            z = _z_offset(cfg, tb) + cfg.leng[tb]
            regions.append(
                make_region(
                    bodies, slab_base + 2 * tb + 1, slab_base + 2 * (tb + 1),
                    plane_predicate(2, z, TOL), plane_predicate(2, z, TOL),
                    lambda c: c[:, 0:2], (fine[tb], fine[tb]),
                    fric=0.0, pena_n=rho,
                )
            )
    else:
        # BLOCK_1 cross-corner contact: every top-layer core of block tb
        # against every bottom-layer core of block tb+1 whose xy footprints
        # overlap (subdomain corners now sit ON the contact interface)
        def footprint(tb, g0, g1):
            L = cfg.leng[tb]
            return (
                -L / 2 + g0 * L / d0, -L / 2 + (g0 + 1) * L / d0,
                -L / 2 + g1 * L / d1, -L / 2 + (g1 + 1) * L / d1,
            )

        for tb in range(2):
            z = _z_offset(cfg, tb) + cfg.leng[tb]
            for g0 in range(d0):
                for g1 in range(d1):
                    fa = footprint(tb, g0, g1)
                    for h0 in range(d0):
                        for h1 in range(d1):
                            fb = footprint(tb + 1, h0, h1)
                            if (
                                min(fa[1], fb[1]) - max(fa[0], fb[0]) <= TOL
                                or min(fa[3], fb[3]) - max(fa[2], fb[2]) <= TOL
                            ):
                                continue
                            regions.append(
                                make_region(
                                    bodies,
                                    core_idx(tb, g0, g1, d2 - 1),
                                    core_idx(tb + 1, h0, h1, 0),
                                    plane_predicate(2, z, TOL),
                                    plane_predicate(2, z, TOL),
                                    lambda c: c[:, 0:2],
                                    (fine[tb] // d0, fine[tb] // d1),
                                    fric=0.0, pena_n=rho,
                                )
                            )

    systems = assemble_bodies(bodies, regions)
    return BlockModel(
        cfg=cfg, bodies=bodies, regions=regions, systems=systems,
        n_core=n_core, slab_base=slab_base,
    )


def _ring_load(cfg: BlockConfig, slab: Body, tb: int, z_top: float,
               pres: np.ndarray) -> None:
    """LOAD_SUB (BLOCK.h:392-481): pressure on the frame ring of the top
    surface not covered by the next block, integrated by mortar clipping."""
    Lb = cfg.leng[tb] / 2.0
    Ls = cfg.leng[tb + 1] / 2.0
    rings = np.array(
        [
            [[-Lb, -Lb], [-Lb, -Ls], [Lb, -Ls], [Lb, -Lb]],
            [[-Lb, -Ls], [-Lb, Ls], [-Ls, Ls], [-Ls, -Ls]],
            [[Ls, -Ls], [Ls, Ls], [Lb, Ls], [Lb, -Ls]],
            [[-Lb, Ls], [-Lb, Lb], [Lb, Lb], [Lb, Ls]],
        ]
    )  # (4,4,2)
    ring3 = np.concatenate(
        [rings, np.full(rings.shape[:-1] + (1,), z_top)], axis=-1
    )  # (4,4,3)
    faces = surface_faces(slab.mesh, plane_predicate(2, z_top, TOL))
    F = faces.shape[0]
    mast = np.repeat(slab.mesh.coords[faces], 4, axis=0)       # (F*4,4,3)
    slav = np.tile(ring3, (F, 1, 1))                           # (F*4,4,3)
    pair, mxi, sxi, w, basis, gap = mortar_integrate(mast, slav)
    if pair.size == 0:
        return
    face_of_pair = pair // 4
    N = quad4_shape(mxi)                                       # (I,4)
    contrib = w[:, None, None] * N[:, :, None] * pres[None, None, :]
    dofs = 3 * faces[face_of_pair][:, :, None] + np.arange(3)
    for d, v in zip(dofs.ravel(), contrib.ravel()):
        slab.exte_forc[int(d)] = slab.exte_forc.get(int(d), 0.0) + float(v)
