"""Isotropic linear elasticity: material law and hex8 element kernels.

Reference semantics: MULTIGRID.h:950-1039 (STIF_MATR: 27-pt Gauss hex8
stiffness with engineering-strain B matrices), :1041-1082 (GET_VOLUME),
:1316-1433 (per-element L2 stress projection).  Defaults E=210 GPa, nu=0.3
(MULTIGRID.h:99-100).

Element kernels exist twice on purpose:
  * NumPy batched versions for the host setup/assembly path;
  * jitted JAX versions (vmapped einsum over elements) for
    device-side assembly/benchmarks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.quadrature import HEX_QUAD

DEFAULT_E = 210.0e9
DEFAULT_NU = 0.3


def elastic_matrix(e_mod: float = DEFAULT_E, nu: float = DEFAULT_NU) -> np.ndarray:
    """6x6 isotropic elasticity matrix in Voigt order (xx,yy,zz,xy,yz,zx)."""
    lam = e_mod * nu / (1.0 + nu) / (1.0 - 2.0 * nu)
    mu = e_mod / 2.0 / (1.0 + nu)
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] = 2.0 * mu + lam
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    return D


def _b_matrix_np(dndx: np.ndarray) -> np.ndarray:
    """Engineering-strain B (...,6,24) from shape gradients (...,3,8)."""
    shape = dndx.shape[:-2]
    B = np.zeros(shape + (6, 24))
    for a in range(8):
        gx, gy, gz = dndx[..., 0, a], dndx[..., 1, a], dndx[..., 2, a]
        B[..., 0, 3 * a + 0] = gx
        B[..., 1, 3 * a + 1] = gy
        B[..., 2, 3 * a + 2] = gz
        B[..., 3, 3 * a + 0] = gy
        B[..., 3, 3 * a + 1] = gx
        B[..., 4, 3 * a + 1] = gz
        B[..., 4, 3 * a + 2] = gy
        B[..., 5, 3 * a + 0] = gz
        B[..., 5, 3 * a + 2] = gx
    return B


def element_stiffness(exyz: np.ndarray, D: np.ndarray) -> np.ndarray:
    """Batched hex8 stiffness: exyz (E,8,3) -> (E,24,24).  NumPy host path.

    Structured as a loop over Gauss points with batched matmuls (BLAS) —
    much faster than one mega-einsum for large element batches."""
    exyz = np.asarray(exyz, dtype=np.float64)
    E = exyz.shape[0]
    K = np.zeros((E, 24, 24))
    for g in range(HEX_QUAD.n_gp):
        dN = HEX_QUAD.shape_grad[g]                 # (3,8)
        w = HEX_QUAD.weights[g]
        J = np.einsum("di,eic->edc", dN, exyz)      # (E,3,3)
        detJ = np.linalg.det(J)
        dndx = np.linalg.solve(J, np.broadcast_to(dN, (E, 3, 8)))  # (E,3,8)
        B = _b_matrix_np(dndx)                      # (E,6,24)
        DB = np.matmul(D, B)                        # (E,6,24)
        K += (w * detJ)[:, None, None] * np.matmul(B.transpose(0, 2, 1), DB)
    return K


def element_volumes(exyz: np.ndarray) -> np.ndarray:
    """Batched 27-pt Gauss volumes: exyz (E,8,3) -> (E,)."""
    dN = HEX_QUAD.shape_grad
    J = np.einsum("gdi,eic->egdc", dN, exyz, optimize=True)
    return np.einsum("eg,g->e", np.linalg.det(J), HEX_QUAD.weights, optimize=True)


# ------------------------------------------------------------------ JAX path
def _inv3x3(J: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form 3x3 inverse + determinant (elementwise, batches freely)."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    Dm = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * Dm + c * G
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([Dm, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None], det


@jax.jit
def element_stiffness_jax(exyz: jnp.ndarray, D: jnp.ndarray) -> jnp.ndarray:
    """Device hex8 stiffness (E,8,3)->(E,24,24), vmapped einsum."""
    dN = jnp.asarray(HEX_QUAD.shape_grad)
    w = jnp.asarray(HEX_QUAD.weights)
    J = jnp.einsum("gdi,eic->egdc", dN, exyz)
    Jinv, detJ = _inv3x3(J)
    dndx = jnp.einsum("egdc,gci->egdi", Jinv, dN)

    gx, gy, gz = dndx[..., 0, :], dndx[..., 1, :], dndx[..., 2, :]
    zeros = jnp.zeros_like(gx)
    # rows of B grouped per node a: (E,27,6,8) per dof component
    bx = jnp.stack([gx, zeros, zeros, gy, zeros, gz], axis=-2)
    by = jnp.stack([zeros, gy, zeros, gx, gz, zeros], axis=-2)
    bz = jnp.stack([zeros, zeros, gz, zeros, gy, gx], axis=-2)
    B = jnp.stack([bx, by, bz], axis=-1).reshape(*gx.shape[:-1], 6, 24)
    DB = jnp.einsum("st,egtq->egsq", D, B)
    return jnp.einsum("egsp,egsq,eg,g->epq", B, DB, detJ, w)


def element_stress_projection(
    exyz: np.ndarray, edisp: np.ndarray, D: np.ndarray
) -> np.ndarray:
    """Per-element L2 projection of Gauss stresses to the 8 nodes
    (MULTIGRID.h:1348-1372): solve (N^T N) S = N^T sigma_g per element.

    exyz (E,8,3), edisp (E,24) -> nodal stresses (E,8,6).
    """
    dN = HEX_QUAD.shape_grad
    Nsh = HEX_QUAD.shape                            # (27,8)
    w = HEX_QUAD.weights
    J = np.einsum("gdi,eic->egdc", dN, exyz, optimize=True)
    detJ = np.linalg.det(J)
    dndx = np.einsum("egdc,gci->egdi", np.linalg.inv(J), dN, optimize=True)
    B = _b_matrix_np(dndx)                          # (E,27,6,24)
    sig = np.einsum("st,egtq,eq->egs", D, B, edisp, optimize=True)  # (E,27,6)
    wd = w * detJ                                   # (E,27)
    rhs = np.einsum("ga,egs,eg->eas", Nsh, sig, wd, optimize=True)  # (E,8,6)
    M = np.einsum("ga,gb,eg->eab", Nsh, Nsh, wd, optimize=True)     # (E,8,8)
    return np.linalg.solve(M, rhs)


def von_mises(stress6: np.ndarray) -> np.ndarray:
    """Equivalent von Mises stress from Voigt components (...,6)."""
    s = stress6
    return np.sqrt(
        (
            (s[..., 0] - s[..., 1]) ** 2
            + (s[..., 1] - s[..., 2]) ** 2
            + (s[..., 0] - s[..., 2]) ** 2
            + 6.0 * (s[..., 3] ** 2 + s[..., 4] ** 2 + s[..., 5] ** 2)
        )
        / 2.0
    )
