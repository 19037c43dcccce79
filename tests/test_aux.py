"""Aux subsystems: GMRES, checkpoint/resume, monitor/IO writers."""

import numpy as np
import jax.numpy as jnp

from ddpca_admm.solvers.krylov import gmres, jacobi_preconditioner


def test_gmres_nonsymmetric():
    rng = np.random.default_rng(0)
    n = 40
    A = np.eye(n) * 4.0 + 0.5 * rng.standard_normal((n, n))
    x_true = rng.standard_normal((2, n))
    b = jnp.asarray(x_true @ A.T)
    Aj = jnp.asarray(A)
    res = gmres(
        lambda x: x @ Aj.T,
        jacobi_preconditioner(jnp.asarray(np.diag(A))),
        b,
    )
    assert np.allclose(np.asarray(res.x), x_true, atol=1e-8)


def test_checkpoint_roundtrip(tmp_path):
    from ddpca_admm.admm.loop import admm_step, init_state
    from ddpca_admm.models.simple import stacked_boxes_problem
    from ddpca_admm.utils.checkpoint import load_state, save_state

    prob, meta, _ = stacked_boxes_problem(div_bot=2, div_top=2, levels=0)
    modes = tuple(meta.group_modes)
    s = init_state(prob)
    for _ in range(3):
        s = admm_step(prob, s, modes)
    p = str(tmp_path / "state.pkl")
    save_state(p, s)
    s2 = load_state(p)
    assert int(s2.it) == int(s.it)
    # resume must continue identically
    a = admm_step(prob, s, modes)
    b = admm_step(prob, s2, modes)
    assert np.allclose(np.asarray(a.u), np.asarray(b.u))


def test_stress_recovery_uniform_field():
    from ddpca_admm.mesh.hexmesh import HexMesh
    from ddpca_admm.utils.io import stress_recovery

    m = HexMesh()
    m.add_box_grid(np.zeros(3), np.ones(3) / 2, (2, 2, 2))
    m.transfer()
    E, nu = 210.0e9, 0.3
    # uniaxial field u_z = e*z -> sigma_zz = E*e for nu-corrected lateral
    e = 1e-4
    disp = np.zeros(3 * m.n_nodes)
    disp[2::3] = e * m.coords[:, 2]
    disp[0::3] = -nu * e * m.coords[:, 0]
    disp[1::3] = -nu * e * m.coords[:, 1]
    stre = stress_recovery(m, disp, E, nu)
    assert np.allclose(stre[:, 2], E * e, rtol=1e-10)
    assert np.abs(stre[:, [0, 1, 3, 4, 5]]).max() < 1e-6 * E * e
    assert np.allclose(stre[:, 6], E * e, rtol=1e-9)  # von Mises


def test_postprocess_renders_pngs(tmp_path):
    """End-to-end Postprocess.m equivalent: run the boxes demo via the CLI
    writer path, then render all three figures."""
    import os

    from ddpca_admm.cli import main
    from ddpca_admm.utils.postprocess import postprocess

    out = str(tmp_path / "Boxes")
    main(["boxes", "--levels", "0", "--outdir", out, "--max-iter", "200",
          "--moni"])
    paths = postprocess(out)
    names = {os.path.basename(p) for p in paths}
    assert "displacement.png" in names
    assert "von_mises.png" in names
    assert "contact_pressure.png" in names
    for p in paths:
        assert os.path.getsize(p) > 5000
