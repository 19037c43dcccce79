"""Dual-mortar LAGRANGE solver vs the contact patch test and ADMM
(cross-solver oracle, examples/BLOCK.cpp:96-101 strategy)."""

import numpy as np

from ddpca_admm.admm.lagrange import solve_lagrange
from ddpca_admm.models.simple import stacked_boxes_problem


def test_lagrange_stacked_boxes_patch():
    from ddpca_admm.models.simple import assemble_bodies

    prob, meta, bodies = stacked_boxes_problem(div_bot=3, div_top=2, levels=0)
    # LAGRANGE uses the penalty-free stiffness (MCONTACT.h:2850-2860)
    systems = assemble_bodies(bodies, meta.regions, include_penalty=False)
    res = solve_lagrange(
        systems,
        meta.regions,
        [b.mesh for b in bodies],
        use_device=False,
    )
    meta.systems = systems
    E, nu, p = 210.0e9, 0.3, -1.0e7
    for b, (body, sysm) in enumerate(zip(bodies, meta.systems)):
        full = sysm.full_displacement(res.u[b])
        uz = full[2::3]
        expect = p * body.mesh.coords[:, 2] / E
        scale = np.abs(expect).max()
        assert np.allclose(uz, expect, atol=5e-4 * scale), (
            f"body {b}: {np.abs(uz - expect).max() / scale}"
        )
    # all nodes in contact for the patch test -> every status active
    assert all((s == 1).all() for s in res.status)
    # multiplier normal component ~ contact force (weighted): nonpositive
    # pressure transmits p over the interface; lambda_n = dual-weighted
    lam_n = res.lagr[0][0::3]
    assert (lam_n < 0).all() or (lam_n > 0).all(), "uniform-sign multipliers"


def test_lagrange_friction_slide_stick_transition():
    """Drive the semi-smooth Newton friction state machine through actual
    transitions (MCONTACT.h:3639-3689): a shear load tilts the contact
    pressure, so low-pressure nodes leave the stick state (initial status 2)
    and finish sliding (status 1) while high-pressure nodes keep sticking."""
    from ddpca_admm.models.simple import assemble_bodies

    p, mu, tau = -1.0e7, 0.15, 1.2e6
    prob, meta, bodies = stacked_boxes_problem(
        div_bot=3, div_top=2, levels=0, pressure=p, fric=mu, shear=tau
    )
    systems = assemble_bodies(bodies, meta.regions, include_penalty=False)
    res = solve_lagrange(
        systems, meta.regions, [b.mesh for b in bodies], use_device=False
    )
    st = res.status[0]
    # the state machine actually transitioned (all nodes start at 2)
    assert res.iters >= 1
    assert (st == 1).sum() >= 1, f"no sliding nodes: {st}"
    assert (st == 2).sum() >= 1, f"no sticking nodes: {st}"
    # sliding nodes carry no independent tangential multiplier — their
    # traction is mu*lam_n along the slip direction via the slip rows
    # (MCONTACT.h:3188-3239), so the stored tangential slots are zero;
    # sticking nodes must lie strictly inside the Coulomb cone
    lam = res.lagr[0].reshape(-1, 3)
    lam_n, lam_t = np.abs(lam[:, 0]), np.hypot(lam[:, 1], lam[:, 2])
    slide, stick = st == 1, st == 2
    assert np.allclose(lam_t[slide], 0.0, atol=1e-6 * lam_n.max())
    assert (lam_t[stick] <= mu * lam_n[stick] * (1 + 1e-8)).all()


def test_lagrange_restricted_gmg_preconditioner():
    """precType=1 (restricted-GMG BiCGSTAB, MCONTACT.h:3419-3562) must give
    the same patch-test solution as the Jacobi path on a refined mesh."""
    from ddpca_admm.models.simple import assemble_bodies

    prob, meta, bodies = stacked_boxes_problem(div_bot=3, div_top=2, levels=1)
    systems = assemble_bodies(bodies, meta.regions, include_penalty=False)
    res = solve_lagrange(
        systems,
        meta.regions,
        [b.mesh for b in bodies],
        use_device=True,
        prec_type=1,
    )
    E, p = 210.0e9, -1.0e7
    for b, (body, sysm) in enumerate(zip(bodies, systems)):
        full = sysm.full_displacement(res.u[b])
        uz = full[2::3]
        expect = p * body.mesh.coords[:, 2] / E
        scale = np.abs(expect).max()
        assert np.allclose(uz, expect, atol=5e-4 * scale), (
            f"body {b}: {np.abs(uz - expect).max() / scale}"
        )


def test_lagrange_vs_admm_on_block_example():
    """Cross-solver oracle at example scale (examples/BLOCK.cpp:96-101): the
    dual-mortar LAGRANGE solution must match the ADMM solution on the BLOCK
    geometry (3 stacked blocks + guard slabs, frictionless contact between
    blocks, perfect interfaces inside)."""
    from ddpca_admm.admm.loop import contact_analysis
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.block import BlockConfig, build_block_model
    from ddpca_admm.models.simple import assemble_bodies

    cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(cfg)

    prob, meta = build_problem(
        model.systems, model.regions, dole=[0] * len(model.systems)
    )
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=1500)
    assert bool(st.converged)

    systems_np = assemble_bodies(
        model.bodies, model.regions, include_penalty=False
    )
    res = solve_lagrange(
        systems_np, model.regions, [b.mesh for b in model.bodies],
        use_device=False,
    )
    scale = 1.0e7 * 0.075 / 210.0e9   # |p|*H/E displacement scale
    for b, sysm in enumerate(systems_np):
        ua = np.asarray(st.u[b])[: meta.systems[b].n_dof]
        ua_full = meta.systems[b].full_displacement(ua)
        ul_full = sysm.full_displacement(res.u[b])
        err = np.abs(ua_full - ul_full).max() / scale
        assert err < 1e-3, f"body {b}: ADMM vs LAGRANGE rel err {err:.2e}"
