"""PlaneDia (per-z-plane-deduplicated DIA) unit tests vs scipy ground truth."""

import numpy as np
import pytest
import scipy.sparse as sp

from ddpca_admm.sparse.dia import (
    Dia,
    dia_from_csr_list,
    plane_dia_from_csr_list,
)


def _banded_grid_matrix(nz, ny, nx, rng, repeat_planes=False):
    """Random matrix with stencil sparsity on an (nz,ny,nx)*3 grid."""
    P = 3 * ny * nx
    n = nz * P
    offs = [0, 1, -1, 3, -3, P, -P, P + 3, -P - 3]
    rows, cols, data = [], [], []
    for off in offs:
        r = np.arange(max(0, -off), min(n, n - off))
        if repeat_planes:
            # identical interior planes: value depends on (row mod P) only,
            # with special first/last planes
            base = rng.standard_normal(P)[r % P]
            z = r // P
            v = np.where(z == 0, base + 2.0, np.where(z == nz - 1, base - 1.0, base))
        else:
            v = rng.standard_normal(r.size)
        rows.append(r)
        cols.append(r + off)
        data.append(v)
    return sp.csr_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def test_plane_dia_matches_scipy_and_dia():
    rng = np.random.default_rng(0)
    nz, ny, nx = 6, 3, 2
    mats = [_banded_grid_matrix(nz, ny, nx, rng) for _ in range(2)]
    n = mats[0].shape[0]
    pd = plane_dia_from_csr_list(mats, (nz, ny, nx), n, np.float64,
                                 max_classes=2 * nz)
    assert pd is not None
    x = rng.standard_normal((2, n))
    y = np.asarray(pd.mv(x))
    ref = np.stack([m @ x[b] for b, m in enumerate(mats)])
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)
    d = dia_from_csr_list(mats, n, np.float64)
    np.testing.assert_allclose(y, np.asarray(d.mv(x)), rtol=1e-12, atol=1e-12)


def test_plane_dia_dedups_repeated_planes():
    rng = np.random.default_rng(1)
    nz, ny, nx = 8, 2, 2
    mats = [_banded_grid_matrix(nz, ny, nx, rng, repeat_planes=True)]
    n = mats[0].shape[0]
    pd = plane_dia_from_csr_list(mats, (nz, ny, nx), n, np.float64,
                                 max_classes=64)
    assert pd is not None
    # first plane, last plane, interior-adjacent-to-first/last, interior:
    # construction guarantees <= 5 distinct slabs (boundary-truncated offsets
    # make z=1 and z=nz-2 differ from deep interior)
    assert pd.vals.shape[0] <= 5 < nz   # vals is (C, D, P)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(pd.mv(x))[0], mats[0] @ x, rtol=1e-12, atol=1e-12
    )


def test_plane_dia_identity_tail_and_padding():
    rng = np.random.default_rng(2)
    nz, ny, nx = 4, 2, 2
    m = _banded_grid_matrix(nz, ny, nx, rng)
    n = m.shape[0]
    n_pad = n + 40
    padded = sp.block_diag([m, sp.identity(40)], format="csr")
    pd = plane_dia_from_csr_list([padded], (nz, ny, nx), n_pad, np.float64,
                                 max_classes=2 * nz)
    assert pd is not None
    x = rng.standard_normal(n_pad)
    y = np.asarray(pd.mv(x))[0]
    np.testing.assert_allclose(y[:n], m @ x[:n], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y[n:], x[n:], rtol=1e-12)   # identity tail
    # zero tail for transfer stencils
    pd0 = plane_dia_from_csr_list([padded], (nz, ny, nx), n_pad, np.float64,
                                  pad_identity=False, max_classes=2 * nz)
    # padded identity tail is rejected in non-identity mode
    assert pd0 is None or np.allclose(np.asarray(pd0.mv(x))[0, n:], 0.0)


def test_plane_dia_falls_back_when_uncompressible():
    rng = np.random.default_rng(3)
    nz, ny, nx = 6, 3, 2
    mats = [_banded_grid_matrix(nz, ny, nx, rng)]
    pd = plane_dia_from_csr_list(mats, (nz, ny, nx), mats[0].shape[0],
                                 np.float64, max_classes=2)
    assert pd is None


def test_structured_plane_dia_solve_matches_bell(monkeypatch):
    """Force the structured DIA path (BlockEll byte budget = 0) on a small
    BLOCK problem and check the ADMM solution matches the default path —
    the 8.8M-DOF format exercised end-to-end at test scale."""
    import ddpca_admm.sparse.bell as bell
    from ddpca_admm.admm.loop import contact_analysis
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.block import BlockConfig, build_block_model
    from ddpca_admm.solvers.mg import BatchBlocks

    cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(cfg)
    prob_ref, meta = build_problem(
        model.systems, model.regions, dole=[0] * len(model.systems)
    )
    st_ref = contact_analysis(prob_ref, tuple(meta.group_modes), max_iter=1500)
    assert bool(st_ref.converged)

    monkeypatch.setattr(bell, "BELL_MAX_BYTES", 0)
    # tiny fixture: defeat the latency-bound plain-Dia demotion so the
    # PlaneDia solve path is actually exercised (solvers/mg.py policy)
    import ddpca_admm.solvers.mg as mgmod

    monkeypatch.setattr(mgmod, "DIA_LATENCY_BYTES", 0)
    prob_dia, meta2 = build_problem(
        model.systems, model.regions, dole=[0] * len(model.systems)
    )
    # the hierarchy must actually have taken the PlaneDia path
    A = prob_dia.mg.levels[-1].A
    assert isinstance(A, BatchBlocks)
    assert any(type(op).__name__ == "PlaneDia" for op in A.ops)
    st = contact_analysis(prob_dia, tuple(meta2.group_modes), max_iter=1500)
    assert bool(st.converged)
    ur = np.asarray(st_ref.u)
    ud = np.asarray(st.u)
    scale = np.abs(ur).max()
    assert np.abs(ud - ur).max() <= 1e-6 * scale


@pytest.mark.parametrize("pad", [0, 64])
@pytest.mark.parametrize("tail_identity", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plane_dia_mv_matches_scipy(dtype, tail_identity, pad):
    """PlaneDia.mv against scipy on the stored (rounded) values, for both
    tail conventions (identity: hierarchy padding; zero: transfer
    stencils) with and without padded rows past the active grid."""
    rng = np.random.default_rng(7)
    nz, ny, nx = 10, 3, 2
    mats = [_banded_grid_matrix(nz, ny, nx, rng) for _ in range(3)]
    n = mats[0].shape[0]
    n_pad = n + pad
    if tail_identity and pad:
        mats = [sp.block_diag([m, sp.identity(pad)], format="csr")
                for m in mats]
    pd = plane_dia_from_csr_list(mats, (nz, ny, nx), n_pad, dtype,
                                 pad_identity=tail_identity,
                                 max_classes=3 * nz + 2)
    assert pd is not None
    assert pd.n_rows == n_pad and pd.n_active == n
    x = rng.standard_normal((3, n_pad)).astype(dtype)
    y = np.asarray(pd.mv(x))
    assert y.shape == (3, n_pad) and y.dtype == dtype
    ref = np.zeros((3, n_pad))
    for b, m in enumerate(mats):
        m32 = m.astype(dtype).astype(np.float64)   # the stored values
        ref[b, :n] = (m32 @ x[b, : m.shape[1]].astype(np.float64))[:n]
        ref[b, n:] = x[b, n:] if tail_identity else 0.0
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()
