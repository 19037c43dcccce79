import numpy as np

from ddpca_admm.contact.geometry import (
    clip_pairs,
    project_normal_to_quads,
    project_points_to_quads,
    triangle_gauss,
)
from ddpca_admm.contact.search import (
    IntegralPoints,
    bucket_pairs,
    mortar_integrate,
    region_search,
    surface_faces,
)
from ddpca_admm.mesh.hexmesh import HexMesh


def test_project_point_to_flat_quad():
    corners = np.array([[0.0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]])[None]
    pts = np.array([[0.5, 0.5, 0.7]])
    xi, gap = project_points_to_quads(corners, pts)
    assert np.allclose(xi, [[-0.5, -0.5]])
    assert np.isclose(gap[0], 0.7)  # normal +z for this orientation


def test_project_point_to_warped_quad():
    rng = np.random.default_rng(0)
    corners = np.array([[0.0, 0, 0], [1, 0, 0.1], [1, 1, -0.05], [0, 1, 0.2]])[None]
    # pick a point ON the surface: xi=(0.3,-0.4)
    from ddpca_admm.contact.geometry import bilinear_coeffs, quad4_eval

    coef = bilinear_coeffs(corners)
    target_xi = np.array([[0.3, -0.4]])
    p = quad4_eval(coef, target_xi)
    xi, gap = project_points_to_quads(corners, p)
    assert np.allclose(xi, target_xi, atol=1e-10)
    assert abs(gap[0]) < 1e-12


def test_clip_identical_squares():
    proj = np.array([[[-1.0, -1], [1, -1], [1, 1], [-1, 1]]])
    tri, valid, area = clip_pairs(proj)
    assert np.isclose(area[0], 4.0)
    xi, w = triangle_gauss(tri)
    assert np.isclose(w[valid].sum(), 4.0)


def test_clip_offset_squares():
    # slave shifted by (1,1): overlap is unit square [0,1]^2 -> area 1
    proj = np.array([[[0.0, 0], [2, 0], [2, 2], [0, 2]]])
    tri, valid, area = clip_pairs(proj)
    assert np.isclose(area[0], 1.0)
    xi, w = triangle_gauss(tri)
    assert np.isclose(w[valid].sum(), 1.0)
    # integrate xi*eta over [0,1]^2 = 1/4
    val = (xi[..., 0] * xi[..., 1] * w)[valid].sum()
    assert np.isclose(val, 0.25)


def test_clip_disjoint():
    proj = np.array([[[5.0, 5], [7, 5], [7, 7], [5, 7]]])
    tri, valid, area = clip_pairs(proj)
    assert not valid.any()


def test_clip_rotated_overlap():
    # slave rotated 45 degrees about origin, much larger -> fully covers master
    th = np.pi / 4
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    big = 3.0 * np.array([[-1.0, -1], [1, -1], [1, 1], [-1, 1]]) @ R.T
    tri, valid, area = clip_pairs(big[None])
    xi, w = triangle_gauss(tri)
    assert np.isclose(w[valid].sum(), 4.0)


def test_mortar_flat_non_matching():
    """Two flat patches with non-matching discretizations: mortar weights
    must reproduce the overlap area and zero gap (patch-test prerequisite)."""
    # master: single 2x2 face at z=0; slave: offset 1.5x1.5 face at z=0
    mast = np.array([[[0.0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]]])
    slav = np.array([[[0.5, 0.5, 0], [2.5, 0.5, 0], [2.5, 2.5, 0], [0.5, 2.5, 0]]])
    pair, mxi, sxi, w, basis, gap = mortar_integrate(mast, slav)
    assert np.isclose(w.sum(), 1.5 * 1.5)
    assert np.allclose(gap, 0.0, atol=1e-12)
    # master normal (outward from reference face orientation) is +-z
    assert np.allclose(np.abs(basis[:, 0, 2]), 1.0)


def test_mortar_gap_sign():
    # slave plane at z=0.3 above master: gap = n.(x_s - x_m)
    mast = np.array([[[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]])
    slav = np.array([[[0.0, 0, 0.3], [1, 0, 0.3], [1, 1, 0.3], [0, 1, 0.3]]])
    pair, mxi, sxi, w, basis, gap = mortar_integrate(mast, slav)
    n_z = basis[0, 0, 2]
    assert np.allclose(gap, 0.3 * np.sign(n_z))


def test_bucket_pairs_cover_neighbors():
    mast_uv = np.array([[0.1, 0.1], [0.9, 0.9], [0.5, 0.5]])
    slav_uv = np.array([[0.45, 0.55]])
    pm, ps = bucket_pairs(mast_uv, slav_uv, (2, 2))
    # with 2x2 buckets all three masters are within one bucket ring
    assert set(pm.tolist()) == {0, 1, 2}


def test_region_search_two_blocks():
    """Two stacked blocks with non-matching meshes: total mortar area equals
    the smaller interface area."""
    top = HexMesh()
    top.add_box_grid(np.array([0.0, 0.0, 1.0]), np.array([0.5, 0.5, 0.5]), (2, 2, 2))
    bot = HexMesh()
    bot.add_box_grid(np.array([-0.1, -0.1, 0.0]), np.array([0.4, 0.4, 1.0]), (3, 3, 1))
    tol = 1e-9
    mast_faces = surface_faces(bot, lambda c: np.abs(c[..., 2] - 1.0) < tol)
    slav_faces = surface_faces(top, lambda c: np.abs(c[..., 2] - 1.0) < tol)
    assert mast_faces.shape[0] == 9
    assert slav_faces.shape[0] == 4
    ip = region_search(
        mast_faces, slav_faces, bot, top,
        lambda x: x[:, :2], (3, 3),
    )
    # overlap: top [0,1]^2 inside bottom [-0.1,1.1]^2 -> area 1
    assert np.isclose(ip.weight.sum(), 1.0)
    assert np.allclose(ip.gap, 0.0, atol=1e-12)
    # shape functions sum to 1
    assert np.allclose(ip.shape.sum(-1), 1.0)
