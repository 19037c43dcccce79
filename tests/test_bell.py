"""BlockEll (block-sparse format) correctness vs scipy and Ell."""

import numpy as np
import pytest
import scipy.sparse as sp

from ddpca_admm.sparse.bell import (
    CB,
    RB,
    BlockEll,
    bell_from_csr_list,
    round_up,
)


def _rand_csr(rng, n, m, density=0.02):
    return sp.random(
        n, m, density=density, random_state=np.random.RandomState(rng),
        format="csr",
    )


@pytest.mark.parametrize("n,m", [(100, 100), (57, 300), (260, 130)])
def test_single_matvec_matches_scipy(n, m):
    A = _rand_csr(0, n, m)
    e = bell_from_csr_list([A], dtype=np.float64)
    x = np.random.default_rng(1).standard_normal(round_up(m, CB))
    y = np.asarray(e.mv(x))
    assert y.shape == (round_up(n, RB),)
    np.testing.assert_allclose(y[:n], A @ x[:m], rtol=1e-12)
    np.testing.assert_allclose(y[n:], 0.0)


def test_batched_broadcast_matvec():
    mats = [_rand_csr(i, 40, 70) for i in range(6)]
    e = bell_from_csr_list(mats, dtype=np.float64, batch_shape=(3, 2))
    x = np.random.default_rng(2).standard_normal((3, 2, round_up(70, CB)))
    y = np.asarray(e.mv(x))
    for i in range(3):
        for s in range(2):
            np.testing.assert_allclose(
                y[i, s, :40], mats[2 * i + s] @ x[i, s, :70], rtol=1e-12
            )
    # matrix batch broadcast against unbatched x
    y2 = np.asarray(e.mv(x[0, 0]))
    np.testing.assert_allclose(y2[0, 0], y[0, 0], rtol=1e-12)


def test_duplicate_entries_sum():
    A = sp.coo_matrix(
        (np.array([1.0, 2.0, 3.0]), (np.array([1, 1, 5]), np.array([4, 4, 9]))),
        shape=(8, 128),
    )
    e = bell_from_csr_list([A], dtype=np.float64)
    x = np.zeros(128)
    x[4] = 1.0
    x[9] = 2.0
    y = np.asarray(e.mv(x))
    assert y[1] == 3.0 and y[5] == 6.0
