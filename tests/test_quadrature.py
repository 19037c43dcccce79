import numpy as np

from ddpca_admm.utils.quadrature import (
    HEX_QUAD,
    QUAD_QUAD,
    TRI_QUAD,
    hex8_shape,
    hex8_shape_grad,
    surface_jacobian,
)


def test_hex_rule_integrates_polynomials():
    # 3x3x3 Gauss is exact for degree <= 5 per axis
    pts, w = HEX_QUAD.points, HEX_QUAD.weights
    assert np.isclose(w.sum(), 8.0)
    f = pts[:, 0] ** 4 * pts[:, 1] ** 2
    exact = (2.0 / 5.0) * (2.0 / 3.0) * 2.0
    assert np.isclose((w * f).sum(), exact)


def test_hex_shape_partition_of_unity():
    rng = np.random.default_rng(0)
    nat = rng.uniform(-1, 1, size=(50, 3))
    N = hex8_shape(nat)
    assert np.allclose(N.sum(axis=-1), 1.0)
    dN = hex8_shape_grad(nat)
    assert np.allclose(dN.sum(axis=-1), 0.0, atol=1e-14)


def test_shape_interpolates_corners():
    from ddpca_admm.utils.quadrature import HEX_CORNERS

    N = hex8_shape(HEX_CORNERS)
    assert np.allclose(N, np.eye(8))


def test_quad_rule():
    assert np.isclose(QUAD_QUAD.weights.sum(), 4.0)
    f = QUAD_QUAD.points[:, 0] ** 2
    assert np.isclose((QUAD_QUAD.weights * f).sum(), 4.0 / 3.0)


def test_triangle_rule():
    # weights integrate 1 over reference triangle area 1/2
    assert np.isclose(TRI_QUAD.weights.sum(), 0.5)
    # integrate x over triangle (0,0),(1,0),(0,1): exact 1/6
    x = TRI_QUAD.bary[:, 1]  # barycentric w.r.t. vertices -> x coordinate
    assert np.isclose((TRI_QUAD.weights * x).sum(), 1.0 / 6.0)
    # quadratic: integral of x^2 = 1/12
    assert np.isclose((TRI_QUAD.weights * x**2).sum(), 1.0 / 12.0)


def test_surface_jacobian_flat_quad():
    corners = np.array(
        [[0.0, 0, 0], [2.0, 0, 0], [2.0, 3.0, 0], [0.0, 3.0, 0]]
    )
    jac = surface_jacobian(np.zeros(2), corners)
    # area = 6, natural area = 4 -> jac = 1.5
    assert np.isclose(jac, 1.5)
