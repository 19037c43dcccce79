import jax.numpy as jnp
import numpy as np
import scipy.sparse.linalg as spla

from ddpca_admm.fem.assembly import assemble_stiffness
from ddpca_admm.fem.constraints import constrain
from ddpca_admm.mesh.hexmesh import HexMesh
from ddpca_admm.solvers.krylov import jacobi_preconditioner, pcg
from ddpca_admm.solvers.mg import build_hierarchy, vcycle
from ddpca_admm.sparse.ell import ell_from_csr, to_device


def small_elasticity(div=2, levels=1, seed=0):
    m = HexMesh()
    m.add_box_grid(np.zeros(3), np.ones(3) / div, (div, div, div))
    m.refine_uniform(levels)
    m.transfer()
    A = assemble_stiffness(m, 210.0e9, 0.3)
    cons = {}
    for i, c in enumerate(m.coords):
        if c[2] < 1e-9:
            for k in range(3):
                cons[3 * i + k] = 0.0
    rng = np.random.default_rng(seed)
    forc = {int(d): float(v) for d, v in
            zip(rng.integers(0, 3 * m.n_nodes, 40), 1e6 * rng.standard_normal(40))}
    return m, constrain(m, A, cons, forc)


def test_ell_matvec_matches_scipy():
    rng = np.random.default_rng(1)
    A = np.where(rng.random((30, 30)) < 0.2, rng.standard_normal((30, 30)), 0.0)
    import scipy.sparse as sp

    As = sp.csr_matrix(A)
    e = to_device(ell_from_csr(As))
    x = rng.standard_normal(30)
    assert np.allclose(np.asarray(e.mv(jnp.asarray(x))), A @ x)


def test_pcg_jacobi_single():
    m, sysm = small_elasticity(div=2, levels=0)
    A = sysm.cons_stif[-1]
    e = to_device(ell_from_csr(A))
    b = jnp.asarray(sysm.cons_forc)
    res = pcg(e.mv, jacobi_preconditioner(jnp.asarray(A.diagonal())), b,
              maxiter=A.shape[0] * 4)
    x_ref = spla.spsolve(A.tocsc(), sysm.cons_forc)
    assert np.allclose(np.asarray(res.x), x_ref, rtol=1e-8)


def test_mg_pcg_batched_matches_direct():
    """Batched 2-subdomain MG-PCG vs scipy direct solves (MGPIS::CG_SOLV(1)
    semantics with the Chebyshev smoother)."""
    systems = [small_elasticity(2, 2, seed=s)[1] for s in (0, 1)]
    mg = build_hierarchy(
        [s.cons_stif for s in systems], [s.real_prol for s in systems]
    )
    n_pad = mg.levels[-1].A.n_rows
    b = np.zeros((2, n_pad))
    for i, s in enumerate(systems):
        b[i, : s.cons_forc.size] = s.cons_forc
    b = jnp.asarray(b)
    # matvec must use the f64 operator; the f32 hierarchy is only the
    # preconditioner
    res = pcg(mg.A_top.mv, lambda r: vcycle(mg, r), b, maxiter=400)
    for i, s in enumerate(systems):
        x_ref = spla.spsolve(s.cons_stif[-1].tocsc(), s.cons_forc)
        x = np.asarray(res.x)[i, : x_ref.size]
        assert np.allclose(x, x_ref, rtol=1e-7, atol=1e-20), f"subdomain {i}"
    # multigrid must beat plain-CG iteration counts by a wide margin
    assert int(res.iters) < 60, f"MG-PCG took {int(res.iters)} iterations"


def test_vcycle_contracts():
    m, sysm = small_elasticity(div=2, levels=2)
    mg = build_hierarchy([sysm.cons_stif], [sysm.real_prol])
    rng = np.random.default_rng(5)
    x_true = jnp.asarray(rng.standard_normal((1, mg.A_top.n_rows)))
    b = mg.A_top.mv(x_true)
    x = jnp.zeros_like(b)
    errs = []
    for _ in range(6):
        x = vcycle(mg, b, x)
        errs.append(float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true)))
    # average contraction factor well below 1
    rho = (errs[-1] / errs[0]) ** (1 / 5)
    assert rho < 0.5, f"V-cycle contraction too weak: {rho} ({errs})"
