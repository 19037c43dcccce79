"""DEHW checks: enveloping-theory surface invariants + the full
34-worm/18-wheel assembly structure (meshes, interfaces, hub torque)."""

import numpy as np

from ddpca_admm.models.dehw_surf import (
    DehwParams,
    fsme,
    singular_c2h,
    whee_1h2r,
    wheel_flank_grid,
    wheel_local,
    worm_dc2r,
    worm_flank_grid,
)


def test_basic_parameters():
    p = DehwParams()
    # reference values implied by DEHWSURF.h:162-196 inputs
    assert np.isclose(p.m_t, 0.418 / 40.0)
    assert np.isclose(p.d[1], 0.418)
    assert np.isclose(p.alph, np.arcsin(2 * 0.079 / 0.418))
    assert p.worm_curv[0] < p.worm_curv[1] < p.worm_curv[2]


def test_worm_flank_invariants():
    p = DehwParams()
    grid = worm_flank_grid(p, 8, 4)
    assert np.isfinite(grid).all()
    # xi_12 invariant: distance from the gorge center circle equals the
    # prescribed profile coordinate (WORM_CURV_2_CART residual)
    v = np.linspace(p.R_a[0], p.R_f[0], 5)
    rad = np.hypot(grid[..., 0], grid[..., 1])
    xi12 = np.sqrt(grid[..., 2] ** 2 + (p.a_h2 - rad) ** 2)
    assert np.abs(xi12 - v[None, :]).max() < 1e-12
    # hourglass shape: radius from the worm axis grows away from the throat
    assert rad.min() > 0.9 * p.d_f[0] / 2
    assert rad.max() < 1.6 * p.d_a[0] / 2


def test_meshing_point_on_both_members():
    """A meshing-configuration point must lie on the worm surface (via the
    worm chain) and map into the wheel tooth band (via the wheel chain)."""
    p = DehwParams()
    th1 = p.worm_curv[1]
    tc = p.i_c1 * th1
    ths, thm = singular_c2h(p, tc)
    thh = 0.5 * (ths + thm)
    x_d, y_d = fsme(p, th1, thh)
    r1 = worm_dc2r(p, x_d, y_d, tc)
    r2 = whee_1h2r(p, x_d, y_d, th1, thh)
    # same physical point: both radii in the respective tooth bands
    assert 0.9 * p.d_f[0] / 2 < np.hypot(r1[0], r1[1]) < 1.8 * p.d_a[0] / 2
    assert 0.9 * p.d_f[1] / 2 < np.hypot(r2[0], r2[1]) < 1.2 * p.d_a[1] / 2


def test_wheel_flank_grid_in_tooth_band():
    p = DehwParams()
    pts, ok = wheel_flank_grid(p, 10, 6)
    assert ok.mean() > 0.5, "zone-1 inversion should cover most of the patch"
    rad = np.hypot(pts[ok][:, 0], pts[ok][:, 1])
    assert rad.min() >= p.d_f[1] / 2 - 1e-9
    assert rad.max() <= p.d_a[1] / 2 + 0.3 * p.m_t
    a, r = wheel_local(p, pts)
    assert np.abs(a[ok]).max() <= p.widt_angl


# ---------------------------------------------------------------------------
# Full assembly (models/dehw_assembly.py): structure, interfaces, loading
# ---------------------------------------------------------------------------

import pytest

from ddpca_admm.models.dehw_surf import DehwGrid, build_surfaces
from ddpca_admm.models.dehw_assembly import (
    DehwDDConfig,
    build_dehw_assembly,
)


@pytest.fixture(scope="module")
def small_assembly():
    g = DehwGrid(
        worm_numb=(2, 1, 1, 2, 2), whee_numb=(2, 2, 1, 2, 2),
        glob_inho=0, glob_homo=1, loca_leve=1,
    )
    cfg = DehwDDConfig(grid=g)
    bodies, regions, info = build_dehw_assembly(cfg)
    return cfg, bodies, regions, info


def test_assembly_domain_and_region_counts(small_assembly):
    """34 worm + 18 wheel domains (DEHW.cpp:48); interface counts follow
    DEHW.h:1598-1601: 33 worm-adjacent, 34-circNumb=26 worm turn-to-turn,
    9 within-tooth, 8 tooth-to-tooth."""
    cfg, bodies, regions, info = small_assembly
    assert info["n_worm"] == 34 and info["n_whee"] == 18
    from collections import Counter

    kinds = Counter(k[0] for k in info["region_kinds"])
    assert kinds["worm_adj"] == 33
    assert kinds["worm_turn"] == 26
    assert kinds["whee_midd"] == 9
    assert kinds["whee_teeth"] == 8
    assert kinds.get("contact", 0) >= 1, "at least one tooth pair in contact"
    assert len(regions) == sum(kinds.values())


def test_assembly_interfaces_coincide(small_assembly):
    """Every perfect interface must be geometrically exact (the DD cut goes
    through coincident node sets; mortar gaps are roundoff)."""
    cfg, bodies, regions, info = small_assembly
    for r, k in zip(regions, info["region_kinds"]):
        if k[0] == "contact":
            continue
        ip = r.region.ip
        assert ip.n > 0, f"empty interface {k}"
        assert np.abs(ip.gap).max() < 1.0e-12, k


def test_assembly_contact_gap_scale(small_assembly):
    """Contact regions pair the conjugate flanks: initial gaps must be at
    tooth-clearance scale, not geometry scale."""
    cfg, bodies, regions, info = small_assembly
    gaps = np.concatenate(
        [
            r.region.ip.gap
            for r, k in zip(regions, info["region_kinds"])
            if k[0] == "contact"
        ]
    )
    assert gaps.size > 0
    assert np.abs(gaps).max() < 1.0e-3  # < 1 mm on a 0.5 m assembly


def test_assembly_hub_torque_equilibrium(small_assembly):
    """SUBR_COLO_WORM integrates T/(r*A) tangential traction over the hub:
    total hoop force * hub radius must reproduce the input torque
    (DEHW.h:181,240-255)."""
    cfg, bodies, regions, info = small_assembly
    p = cfg.params
    tot = 0.0
    for b in bodies[: info["n_worm"]]:
        for dof, v in b.exte_forc.items():
            assert dof % 3 == 1  # only local hoop components loaded
            tot += v
    assert np.isclose(tot * p.inne_radi[0], p.inpu_torq, rtol=1e-9)
    # wheel hub fully fixed when the worm drives (DEHW.h:325-336)
    for b in bodies[info["n_worm"]:]:
        assert not b.node_rota
        assert len(b.cons_dofv) > 0


def test_assembly_hub_frames_orthonormal(small_assembly):
    cfg, bodies, regions, info = small_assembly
    b = bodies[0]
    assert b.node_rota, "worm hub nodes must carry cylindrical frames"
    for i, R in list(b.node_rota.items())[:32]:
        assert np.allclose(R.T @ R, np.eye(3), atol=1e-12)
        # constrained components: local radial (0) and axial (2)
        assert b.cons_dofv.get(3 * i + 0) == 0.0
        assert b.cons_dofv.get(3 * i + 2) == 0.0
        assert 3 * i + 1 not in b.cons_dofv


@pytest.fixture(scope="module")
def cross_assembly():
    g = DehwGrid(
        worm_numb=(2, 1, 1, 2, 2), whee_numb=(2, 2, 1, 2, 2),
        glob_inho=0, glob_homo=1, loca_leve=1,
    )
    cfg = DehwDDConfig(grid=g, cross_corner=True)
    bodies, regions, info = build_dehw_assembly(cfg)
    return cfg, bodies, regions, info


def test_cross_corner_assembly_structure(cross_assembly):
    """DEHW_1 (examples/DEHW_1.h:762-812): wheel teeth split by face-width
    section groups with full-width blocks.  Same 34+18 domain totals; tooth
    boundaries now join the SAME face group of adjacent teeth (8 teeth x 2
    groups = 16 regions), and every contact tooth pair couples the worm
    domains to BOTH face-group domains (DD corner crosses the zone)."""
    cfg, bodies, regions, info = cross_assembly
    assert info["n_worm"] == 34 and info["n_whee"] == 18
    from collections import Counter

    kinds = Counter(k[0] for k in info["region_kinds"])
    assert kinds["worm_adj"] == 33
    assert kinds["worm_turn"] == 26
    assert kinds["whee_midd"] == 9       # one face-mid cut per tooth
    assert kinds["whee_teeth"] == 16     # 8 boundaries x 2 face groups
    # cross-corner: some tooth pair couples both face groups of its tooth
    cont = [k for k in info["region_kinds"] if k[0] == "contact"]
    assert cont, "at least one tooth pair in contact"
    slaves = {k[3] for k in cont}
    assert any(s % 2 == 1 for s in slaves) or len(slaves) > len(
        {s // 2 for s in slaves}
    ), f"contact must reach both face groups: {sorted(slaves)}"
    # every perfect interface is geometrically exact
    for r, k in zip(regions, info["region_kinds"]):
        if k[0] == "contact":
            continue
        ip = r.region.ip
        assert ip.n > 0, f"empty interface {k}"
        assert np.abs(ip.gap).max() < 1.0e-12, k
