"""BEAM example: DD ADMM vs the unsplit single-body solve (the reference's
SOLVE_NODD oracle, examples/BEAM.h:55-57,403-416)."""

import numpy as np
import scipy.sparse.linalg as spla

from ddpca_admm.admm.loop import contact_analysis
from ddpca_admm.fem.assembly import assemble_stiffness
from ddpca_admm.fem.constraints import constrain
from ddpca_admm.mesh.hexmesh import HexMesh
from ddpca_admm.models.beam import (
    BeamConfig,
    _beam_load,
    build_beam_model,
    straight_grid,
    twist_map,
)
from ddpca_admm.models.simple import Body


def test_beam_dd_matches_nodd():
    cfg = BeamConfig(divi=(4, 2, 2), doma=(2, 1, 1), glob_leve=1)
    prob, meta, bodies, cfg = build_beam_model(cfg)
    state = contact_analysis(prob, tuple(meta.group_modes), max_iter=2000)
    assert bool(state.converged)

    # no-DD oracle: same mesh unsplit (MESH_NODD path)
    m = HexMesh()
    m.add_box_grid(
        np.zeros(3), np.ones(3), cfg.divi,
        coords_fn=straight_grid(cfg, np.zeros(3), cfg.divi, cfg.divi, (0, 0, 0)),
    )
    m.refine_uniform(cfg.glob_leve, pattern=0)
    m.transform(twist_map(cfg, 1))
    m.transfer()
    mb = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
    for i, c in enumerate(m.coords):
        if c[0] <= 1e-10:
            for k in range(3):
                mb.cons_dofv[3 * i + k] = 0.0
    _beam_load(cfg, mb, 0)
    A = assemble_stiffness(m, mb.e_mod, mb.nu)
    sysm = constrain(m, A, mb.cons_dofv, mb.exte_forc)
    u_mono = sysm.full_displacement(
        spla.spsolve(sysm.cons_stif[-1].tocsc(), sysm.cons_forc)
    )
    scale = np.abs(u_mono).max()
    assert scale > 0

    worst = 0.0
    for b, bsys in enumerate(meta.systems):
        full = bsys.full_displacement(np.asarray(state.u[b])[: bsys.n_dof])
        ids = m.add_nodes(bodies[b].mesh.coords)
        for i, j in enumerate(ids):
            du = np.linalg.norm(full[3 * i : 3 * i + 3] - u_mono[3 * j : 3 * j + 3])
            worst = max(worst, du)
    assert worst < 2e-3 * scale, f"DD vs no-DD mismatch {worst/scale}"
