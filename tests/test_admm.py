"""End-to-end ADMM integration tests: the two-body contact patch test and the
perfect-interface consistency test (the reference's physics-based test
strategy, SURVEY.md section 4, on minimal geometry)."""

import numpy as np

from ddpca_admm.admm.loop import contact_analysis
from ddpca_admm.models.simple import (
    split_box_problem,
    stacked_boxes_problem,
)


def test_stacked_boxes_patch():
    """Frictionless contact patch test: uniform pressure must transmit
    through the non-matching interface; displacement linear in z."""
    prob, meta, bodies = stacked_boxes_problem(div_bot=3, div_top=2, levels=0)
    state = contact_analysis(prob, tuple(meta.group_modes), max_iter=800)
    assert bool(state.converged), f"no convergence in {int(state.it)} iters"

    E, nu, p = 210.0e9, 0.3, -1.0e7
    for b, (body, sysm) in enumerate(zip(bodies, meta.systems)):
        u = np.asarray(state.u[b])[: sysm.n_dof]
        full = sysm.full_displacement(u)
        uz = full[2::3]
        expect = p * body.mesh.coords[:, 2] / E
        scale = np.abs(expect).max()
        assert np.allclose(uz, expect, atol=2e-3 * scale), (
            f"body {b}: max err {np.abs(uz - expect).max() / scale}"
        )
        ux = full[0::3]
        expect_x = -nu * p * body.mesh.coords[:, 0] / E
        assert np.allclose(ux, expect_x, atol=2e-3 * scale)

    # contact pressure: gamma_n ~ -p at every integral point
    gs = state.groups[0]
    gamma = np.asarray(gs.gamma)[0]
    ip = meta.regions[0].region.ip
    assert np.allclose(gamma[: ip.n], -p, rtol=2e-3)


def test_split_box_matches_monolithic():
    """Perfect interface (vector mode): DD result == single-body result."""
    import scipy.sparse.linalg as spla

    from ddpca_admm.fem.assembly import assemble_stiffness
    from ddpca_admm.fem.constraints import constrain
    from ddpca_admm.mesh.hexmesh import HexMesh
    from ddpca_admm.models.simple import (
        Body,
        apply_pressure,
        fix_plane,
        plane_predicate,
    )

    prob, meta, bodies = split_box_problem(div=2, levels=0)
    state = contact_analysis(prob, tuple(meta.group_modes), max_iter=800)
    assert bool(state.converged), f"no convergence in {int(state.it)} iters"

    # monolithic oracle
    mono = HexMesh()
    mono.add_box_grid(np.zeros(3), np.array([0.25, 0.5, 0.5]), (4, 2, 2))
    mono.transfer()
    mb = Body(mesh=mono)
    fix_plane(mb, 2, 0.0, (0, 1, 2))
    apply_pressure(mb, plane_predicate(2, 1.0), np.array([0, 0, -1.0e7]))
    A = assemble_stiffness(mono, mb.e_mod, mb.nu)
    sysm = constrain(mono, A, mb.cons_dofv, mb.exte_forc)
    u_mono = sysm.full_displacement(
        spla.spsolve(sysm.cons_stif[-1].tocsc(), sysm.cons_forc)
    )

    scale = np.abs(u_mono).max()
    for b, bsys in enumerate(meta.systems):
        u = np.asarray(state.u[b])[: bsys.n_dof]
        full = bsys.full_displacement(u)
        for i, c in enumerate(bodies[b].mesh.coords):
            j = mono.add_nodes(c[None])[0]  # same coords exist in mono mesh
            assert j < u_mono.size / 3
            du = full[3 * i : 3 * i + 3] - u_mono[3 * j : 3 * j + 3]
            assert np.linalg.norm(du) < 5e-4 * scale, (
                f"body {b} node {i}: {du}"
            )


def test_double_m_coarse_mg_matches_direct():
    """DOUBLE_M_1 (DD-multigrid coarse solve, MCONTACT.h:2303-2341) must give
    the same converged solution and comparable iteration counts as the dense
    direct coarse solve, for both coarse-correction variants."""
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.simple import assemble_bodies

    _, _, bodies = stacked_boxes_problem(div_bot=3, div_top=2, levels=1)
    from ddpca_admm.models.simple import (
        char_length,
        make_region,
        penalty,
        plane_predicate,
    )

    rho = penalty(25.0, char_length(bodies))
    regions = [
        make_region(
            bodies, 0, 1,
            plane_predicate(2, 1.0), plane_predicate(2, 1.0),
            lambda x: x[:, :2], (6,) * 2, fric=0.0, pena_n=rho,
        )
    ]
    systems = assemble_bodies(bodies, regions)
    meshes = [b.mesh for b in bodies]
    results = {}
    for solver in ("direct", "ddmg"):
        for musc in (1, 2):
            prob, meta = build_problem(
                systems, regions, dole=[1, 1], musc_sett=musc,
                meshes=meshes, coarse_solver=solver,
            )
            if solver == "ddmg":
                assert all(co.mg is not None for co in prob.coarse), (
                    "ddmg hierarchy not built"
                )
            st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800)
            assert bool(st.converged), f"{solver}/musc{musc}: no convergence"
            results[(solver, musc)] = np.asarray(st.u)
    for musc in (1, 2):
        a, b = results[("direct", musc)], results[("ddmg", musc)]
        ref = np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-6 * ref, (
            f"musc{musc}: {np.abs(a - b).max() / ref}"
        )


def test_block1_cross_corner_patch():
    """BLOCK_1 (examples/BLOCK_1.h): no guard slabs — subdomain corners lie
    on the contact interfaces.  The patch test must still pass."""
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.block import BlockConfig, build_block_model

    cfg = BlockConfig(
        divi=(2, 2, 2), glob_leve=1, doma_numb=(2, 2, 2), guard_slabs=False
    )
    model = build_block_model(cfg)
    assert len(model.bodies) == 24  # 3 blocks x 2^3 cores, no slabs
    prob, meta = build_problem(
        model.systems, model.regions, dole=[0] * len(model.bodies)
    )
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=1500)
    assert bool(st.converged)
    E, p = 210.0e9, -1.0e7
    scale = abs(p) * 0.075 / E
    for b, (body, sysm) in enumerate(zip(model.bodies, meta.systems)):
        u = np.asarray(st.u[b])[: sysm.n_dof]
        full = sysm.full_displacement(u)
        expect = p * body.mesh.coords[:, 2] / E
        assert np.abs(full[2::3] - expect).max() <= 1e-4 * scale


def test_composed_coarse_correction_matches_materialized(monkeypatch):
    """ComposedTranD/ComposedAccu (the 8.8M-DOF memory path: F^T A and
    accuProl computed through the hierarchy) must converge to the same
    solution as the materialized operators."""
    from ddpca_admm.admm.multiscale import ComposedAccu, ComposedTranD
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.block import BlockConfig, build_block_model

    cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(cfg)
    args = (model.systems, model.regions)
    kw = dict(dole=[1] * len(model.systems), musc_sett=2)
    prob_mat, meta = build_problem(*args, **kw)
    assert not isinstance(prob_mat.coarse[0].tranD, ComposedTranD)
    st_mat = contact_analysis(prob_mat, tuple(meta.group_modes), max_iter=800)
    assert bool(st_mat.converged)

    monkeypatch.setenv("DDPCA_COMPOSE_TRAND_MIN_DOFS", "0")
    prob_cmp, meta2 = build_problem(*args, **kw)
    assert isinstance(prob_cmp.coarse[0].tranD, ComposedTranD)
    assert isinstance(prob_cmp.coarse[0].accu, ComposedAccu)
    st_cmp = contact_analysis(prob_cmp, tuple(meta2.group_modes), max_iter=800)
    assert bool(st_cmp.converged)
    um, uc = np.asarray(st_mat.u), np.asarray(st_cmp.u)
    assert np.abs(uc - um).max() <= 1e-6 * np.abs(um).max()
