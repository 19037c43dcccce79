import numpy as np

from ddpca_admm.fem.assembly import assemble_stiffness
from ddpca_admm.fem.constraints import constrain
from ddpca_admm.fem.elasticity import (
    elastic_matrix,
    element_stiffness,
    element_stiffness_jax,
    element_volumes,
)
from ddpca_admm.mesh.hexmesh import HexMesh


def unit_cube_coords():
    return np.array(
        [
            [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        ],
        dtype=np.float64,
    )


def test_element_stiffness_rigid_modes():
    D = elastic_matrix(1.0e9, 0.3)
    K = element_stiffness(unit_cube_coords()[None], D)[0]
    assert np.allclose(K, K.T, rtol=1e-12)
    # 6 rigid body modes in the nullspace
    x = unit_cube_coords()
    modes = []
    for t in np.eye(3):
        modes.append(np.tile(t, 8))
    for axis in range(3):
        W = np.zeros((3, 3))
        W[(axis + 1) % 3, (axis + 2) % 3] = 1.0
        W[(axis + 2) % 3, (axis + 1) % 3] = -1.0
        modes.append((x @ W.T).ravel())
    for m in modes:
        assert np.linalg.norm(K @ m) < 1e-3 * np.linalg.norm(K)
    w = np.linalg.eigvalsh(K)
    assert (w[6:] > 0).all()


def test_element_stiffness_jax_matches_numpy():
    D = elastic_matrix()
    rng = np.random.default_rng(3)
    exyz = unit_cube_coords()[None] + 0.05 * rng.standard_normal((4, 8, 3))
    Kn = element_stiffness(exyz, D)
    Kj = np.asarray(element_stiffness_jax(exyz, D))
    assert np.allclose(Kn, Kj, rtol=1e-9)


def test_element_volume():
    v = element_volumes(unit_cube_coords()[None])[0]
    assert np.isclose(v, 1.0)
    v2 = element_volumes(2.0 * unit_cube_coords()[None])[0]
    assert np.isclose(v2, 8.0)


def uniaxial_problem(div=2, levels=1):
    """Unit cube, compressed in z by pressure on top, rollers on sides."""
    m = HexMesh()
    m.add_box_grid(np.zeros(3), np.ones(3) / div, (div, div, div))
    m.refine_uniform(levels)
    m.transfer()
    E, nu, p = 210.0e9, 0.3, -1.0e7
    A = assemble_stiffness(m, E, nu)
    cons, forc = {}, {}
    tol = 1e-9
    for i, c in enumerate(m.coords):
        if c[2] < tol:
            cons[3 * i + 2] = 0.0
        if c[0] < tol:
            cons[3 * i + 0] = 0.0
        if c[1] < tol:
            cons[3 * i + 1] = 0.0
    # consistent nodal load on top face z=1: pressure p over area
    top = [i for i, c in enumerate(m.coords) if c[2] > 1 - tol]
    # count face-weights via boundary faces of leaves
    from ddpca_admm.fem.assembly import distribute_face_load
    from ddpca_admm.utils.quadrature import HEX_FACES

    leaves = m.leaf_elems()
    faces = []
    for e in leaves:
        for f in range(6):
            nodes = m.elem_corn[e, HEX_FACES[f]]
            if (m.coords[nodes][:, 2] > 1 - tol).all():
                faces.append(nodes)
    distribute_face_load(m, np.array(faces), lambda x: np.array([0, 0, p]), forc)
    return m, A, cons, forc, (E, nu, p)


def test_uniaxial_compression_direct():
    import scipy.sparse.linalg as spla

    m, A, cons, forc, (E, nu, p) = uniaxial_problem(div=2, levels=1)
    sysm = constrain(m, A, cons, forc)
    u = spla.spsolve(sysm.cons_stif[-1].tocsc(), sysm.cons_forc)
    full = sysm.full_displacement(u)
    # uniaxial stress state: u_z = p*z/E, u_x = -nu*p*x/E
    uz = full[2::3]
    ux = full[0::3]
    assert np.allclose(uz, p * m.coords[:, 2] / E, rtol=1e-8, atol=1e-15)
    assert np.allclose(ux, -nu * p * m.coords[:, 0] / E, rtol=1e-8, atol=1e-15)


def test_constraint_hierarchy_shapes():
    m, A, cons, forc, _ = uniaxial_problem(div=2, levels=2)
    sysm = constrain(m, A, cons, forc)
    assert len(sysm.cons_stif) == 3      # levels 0..2
    assert len(sysm.real_prol) == 2
    for l, P in enumerate(sysm.real_prol):
        assert P.shape == (
            sysm.cons_stif[l + 1].shape[0],
            sysm.cons_stif[l].shape[0],
        )
    # every level matrix SPD after constraint elimination
    for Al in sysm.cons_stif:
        w = np.linalg.eigvalsh(Al.toarray())
        assert w.min() > 0
