"""Full CYLINDER stack assembly (CYLINDER.h:440-551) + CYLINDER_1
cross-corner variant, at reduced refinement."""

import pytest


@pytest.mark.parametrize("cross_corner", [False, True])
def test_cylinder_stack_hertz(cross_corner):
    import jax

    from ddpca_admm.admm.loop import contact_analysis
    from ddpca_admm.models.cylinder import (
        CylinderConfig,
        build_cylinder_model,
        region_pressures,
    )

    cfg = CylinderConfig(
        glob_inho=2, glob_homo=0, loca_leve=3, divi=(2, 2, 1, 2),
        band_widt=8e-4, stack4=not cross_corner, cross_corner=cross_corner,
        copy_numb=1,
    )
    prob, meta, bodies, cfg = build_cylinder_model(cfg)
    assert len(bodies) == (4 if cross_corner else 8)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800)
    jax.block_until_ready(st.u)
    assert bool(st.converged)
    a, p_max = cfg.hertz
    pres = region_pressures(meta, st)
    # regions 0..1 (cross-corner) / 0..3 (mirror halves) are the two
    # cylinder contacts; the remainder are the mid-circle interfaces
    n_cont = 2 if cross_corner else 4
    f_line = abs(cfg.load_inte) * cfg.leng
    # equilibrium: each contact transmits the full applied line load
    # (mirror halves carry half each); resolution-independent
    f_expect = f_line / (1 if cross_corner else 2)
    for ri in range(n_cont):
        assert pres[ri][1] == pytest.approx(f_expect, rel=0.05), (ri, pres)
    # bottom and top contacts see identical Hertz conditions
    assert pres[0][0] == pytest.approx(pres[n_cont - 1][0], rel=0.02)
    # peak pressure approaches Hertz p_max (coarse band: loose bound)
    for ri in range(n_cont):
        assert 0.6 * p_max < pres[ri][0] < 1.3 * p_max, (ri, pres)
    # the mid-circle interface spreads the load far below the Hertz peak
    for ri in list(pres)[n_cont:]:
        assert pres[ri][0] < 0.5 * p_max
