"""Coulomb friction in the ADMM loop (vector mode, cone projection,
MCONTACT.h:2648-2668): combined pressure + shear on a stacked-box joint.

Physics oracle: shear tau at the top face (arm h=1) tilts the upper box, so
the contact pressure varies linearly by +-6*tau around |p| while the total
normal force stays |p|*A and the tangential force transmits tau*A, all
within the friction cone (tau < mu*|p|)."""

import numpy as np

from ddpca_admm.admm.loop import contact_analysis
from ddpca_admm.models.simple import stacked_boxes_problem


def test_stick_with_tilting_pressure():
    p, mu, tau = -1.0e7, 0.4, 1.0e6
    prob, meta, bodies = stacked_boxes_problem(
        div_bot=3, div_top=2, levels=0, pressure=p, fric=mu, shear=tau
    )
    assert meta.group_modes == ["vector"]
    state = contact_analysis(prob, tuple(meta.group_modes), max_iter=3000)
    assert bool(state.converged), f"no convergence in {int(state.it)}"

    ip = meta.regions[0].region.ip
    gamma = np.asarray(state.groups[0].gamma[0])[: 3 * ip.n].reshape(-1, 3)
    w = ip.weight
    # total normal force = |p| * area (area = 1)
    assert np.isclose((w * gamma[:, 0]).sum(), -p, rtol=1e-6)
    # pressure tilts linearly: range approx |p| -+ 6 tau
    assert gamma[:, 0].min() < -p - 4.0 * tau
    assert gamma[:, 0].max() > -p + 4.0 * tau
    # transmitted tangential force magnitude = tau * area
    tx = (w * (gamma[:, 1] * ip.basis[:, 1, 0]
               + gamma[:, 2] * ip.basis[:, 2, 0])).sum()
    assert np.isclose(abs(tx), tau, rtol=1e-2)
    # Coulomb cone satisfied everywhere
    assert (np.hypot(gamma[:, 1], gamma[:, 2])
            <= mu * gamma[:, 0] * (1 + 1e-8) + 1.0).all()
