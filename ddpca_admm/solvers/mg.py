"""Batched geometric-multigrid V-cycle.

Re-design of the reference MGPIS (MGPIS.h:40-128).  The reference smoother is
one symmetric Gauss-Seidel sweep written as two sequential triangular solves
(MGPIS.h:64-77) — inherently row-sequential and unvectorizable.  Here it is
replaced by a degree-``CHEB_DEGREE`` Chebyshev polynomial smoother on
D^{-1}A (documented deviation; the multigrid convergence criterion and the
outer Krylov tolerances are unchanged).  The coarsest level uses a dense
Cholesky factor (reference: cached SimplicialLDLT, MGPIS.h:57-60) — here a
padded explicit inverse applied as one batched matmul over subdomains.

All level operators are batched sparse matrices (ELL, or DIA/PlaneDia on
structured grids) with a leading ``domain`` axis: one V-cycle call smooths
*all* subdomains at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg
import scipy.sparse as sp

from ..sparse.bell import device_sparse, round_up
from ..sparse.dia import Dia, dia_from_csr_list
from ..sparse.ell import Ell, stack_ells, to_device
from ..utils.constants import DENSE_COARSE_MAXI


@jax.tree_util.register_pytree_node_class
class BatchBlocks:
    """Block-diagonal over the leading batch axis: each contiguous body
    range gets its own operator (different structured-grid shapes need
    different DIA offset sets, sparse/dia.py)."""

    def __init__(self, ops: tuple, bounds: tuple[tuple[int, int], ...]):
        self.ops = tuple(ops)
        self.bounds = tuple((int(a), int(b)) for a, b in bounds)

    def tree_flatten(self):
        return self.ops, self.bounds

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children, aux)

    @property
    def n_rows(self) -> int:
        return self.ops[0].n_rows

    @property
    def dtype(self):
        return self.ops[0].dtype

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        outs = [
            op.mv(x[a:b]) for op, (a, b) in zip(self.ops, self.bounds)
        ]
        return jnp.concatenate(outs, axis=0)


def _stuff_axis(x: jnp.ndarray, axis: int, stride: int, n_f: int) -> jnp.ndarray:
    """Zero-stuff one grid axis: coarse length n_c -> fine length n_f with
    coarse values at positions 0, stride, 2*stride, ... (pure layout ops)."""
    n_c = x.shape[axis]
    if stride == 1:
        assert n_f == n_c
        return x
    z = jnp.zeros_like(x)
    y = jnp.stack([x, z], axis=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n_c
    y = y.reshape(shape)
    return jax.lax.slice_in_dim(y, 0, n_f, axis=axis)


@jax.tree_util.register_pytree_node_class
class StructuredProl:
    """Prolongation on nested grids:  P e_c = S @ stuff(e_c)  where stuff
    zero-fills the coarse values into their fine-grid slots (layout ops
    only) and S is the interpolation stencil as a square fine-grid DIA —
    the gather-free transfer (MULTIGRID::TRANSFER)."""

    def __init__(self, S: Dia, fshape, cshape, strides, n_c_pad: int):
        self.S = S
        self.fshape = tuple(fshape)    # (nz, ny, nx) fine node grid
        self.cshape = tuple(cshape)
        self.strides = tuple(strides)  # (sz, sy, sx)
        self.n_c_pad = int(n_c_pad)

    def tree_flatten(self):
        return (self.S,), (self.fshape, self.cshape, self.strides,
                           self.n_c_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    def _stuff(self, e_c: jnp.ndarray) -> jnp.ndarray:
        nzc, nyc, nxc = self.cshape
        nzf, nyf, nxf = self.fshape
        batch = e_c.shape[:-1]
        x = e_c[..., : 3 * nzc * nyc * nxc].reshape(
            batch + (nzc, nyc, nxc, 3)
        )
        nb = len(batch)
        for ax, (s, nf) in enumerate(zip(self.strides,
                                         (nzf, nyf, nxf))):
            x = _stuff_axis(x, nb + ax, s, nf)
        x = x.reshape(batch + (3 * nzf * nyf * nxf,))
        pad = self.S.n_rows - x.shape[-1]
        if pad:
            x = jnp.pad(x, [(0, 0)] * nb + [(0, pad)])
        return x

    def mv(self, e_c: jnp.ndarray) -> jnp.ndarray:
        return self.S.mv(self._stuff(e_c))


@jax.tree_util.register_pytree_node_class
class StructuredRest:
    """Restriction = P^T:  r_c = unstuff(S^T r) — strided slice of the
    transposed stencil's output."""

    def __init__(self, St: Dia, fshape, cshape, strides, n_c_pad: int):
        self.St = St
        self.fshape = tuple(fshape)
        self.cshape = tuple(cshape)
        self.strides = tuple(strides)
        self.n_c_pad = int(n_c_pad)

    def tree_flatten(self):
        return (self.St,), (self.fshape, self.cshape, self.strides,
                            self.n_c_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    def mv(self, r: jnp.ndarray) -> jnp.ndarray:
        nzc, nyc, nxc = self.cshape
        nzf, nyf, nxf = self.fshape
        batch = r.shape[:-1]
        y = self.St.mv(r)[..., : 3 * nzf * nyf * nxf]
        g = y.reshape(batch + (nzf, nyf, nxf, 3))
        nb = len(batch)
        sz, sy, sx = self.strides
        g = g[..., ::sz, ::sy, ::sx, :]
        out = g.reshape(batch + (3 * nzc * nyc * nxc,))
        pad = self.n_c_pad - out.shape[-1]
        if pad:
            out = jnp.pad(out, [(0, 0)] * nb + [(0, pad)])
        return out

CHEB_DEGREE = 3

# Below this un-deduplicated DIA footprint the SpMV is latency-bound, not
# bandwidth-bound, and plain Dia's direct per-offset reads avoid the
# PlaneDia class gather.  Weakly-compressing groups (<4x plane dedup) under
# this size take plain Dia; tests pin it to 0 to force the PlaneDia path on
# tiny fixtures.  The threshold has not been re-measured on the GPU.
DIA_LATENCY_BYTES = 64 << 20
CHEB_LOWER_FRACTION = 0.25   # smoothing interval [lmax/4, 1.02*lmax]
CHEB_UPPER_SAFETY = 1.02


class MgLevel(NamedTuple):
    A: Ell            # (B, n_l, kA) stiffness at this level
    inv_diag: jnp.ndarray  # (B, n_l)
    lmax: jnp.ndarray      # (B,) upper eigenvalue estimate of D^{-1}A
    P: Ell | None     # prolongation from level below: (B, n_l, kP), or None at 0
    Pt: Ell | None    # restriction to level below: (B, n_{l-1}, kR)


class MgHierarchy(NamedTuple):
    levels: tuple[MgLevel, ...]   # index 0 = coarsest (precond dtype, f32)
    # (B, n0, n0) explicit coarse inverses, or None when the coarse space is
    # too large to dense-invert (DENSE_COARSE_MAXI) — the V-cycle then ends
    # in an aggressive Chebyshev sweep at level 0 instead of an exact solve
    # (still a fixed SPD linear operator, so valid as a CG preconditioner)
    coarse_inv: jnp.ndarray | None
    A_top: Ell                    # finest-level operator in f64 (Krylov matvec)


COARSE_CHEB_DEGREE = 12  # level-0 sweep when coarse_inv is None


def _stencil_matrix(P: sp.spmatrix, zmap: np.ndarray) -> sp.csr_matrix:
    """Square fine-grid stencil S with S[r, embed(c)] = P[r, c], where
    embed maps each coarse node to its fine-grid slot (GridInfo.zmaps) —
    the host-side construction behind StructuredProl."""
    P = P.tocoo()
    cn, ck = P.col // 3, P.col % 3
    cols = 3 * zmap[cn] + ck
    n_f = P.shape[0]
    return sp.csr_matrix((P.data, (P.row, cols)), shape=(n_f, n_f))


def estimate_lmax(A: sp.spmatrix, iters: int = 20, seed: int = 0) -> float:
    """Power iteration upper bound for lambda_max(D^{-1}A) (host, setup)."""
    A = A.tocsr()
    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = (A @ x) / d
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam


def build_hierarchy(
    cons_stif: list[list[sp.spmatrix]],
    real_prol: list[list[sp.spmatrix]],
    dtype=jnp.float32,
    assume_sym: bool = True,
    a_top_dtype=None,
    grids=None,
) -> MgHierarchy:
    """Build a batched hierarchy from per-subdomain scipy matrices.

    ``cons_stif[b][l]`` level-l constrained stiffness of subdomain b
    (l=0 coarsest); ``real_prol[b][l]`` maps level l -> l+1.  All subdomains
    must have the same number of levels; shapes are padded to the batch max.

    Precision design: the V-cycle runs in ``dtype`` (default f32; it is only
    a preconditioner, so reduced precision costs a few extra Krylov
    iterations, not accuracy, and halves the bytes every smoother SpMV
    reads), while ``A_top`` keeps the finest operator in the solve dtype
    (f64) for true residuals down to the reference's 1e-14 tolerances.  The
    coarse level applies an explicit inverse (one batched matmul) instead of
    two sequential triangular solves, which are latency-bound.
    """
    B = len(cons_stif)
    L = len(cons_stif[0])
    assert all(len(cs) == L for cs in cons_stif), "uniform level count required"

    levels = []
    for l in range(L):
        mats = [cons_stif[b][l] for b in range(B)]
        # pad to a (8,128)-tile multiple (uniform for ELL and BlockEll)
        n_pad = round_up(max(m.shape[0] for m in mats), 128)
        # pad diagonal with 1.0 so padded rows stay decoupled identity
        padded = []
        for m in mats:
            m = m.tocsr()
            if m.shape[0] < n_pad:
                extra = n_pad - m.shape[0]
                m = sp.block_diag([m, sp.identity(extra)], format="csr")
            padded.append(m)
        diag = np.stack([np.asarray(m.diagonal()) for m in padded])
        inv_diag = np.where(diag != 0.0, 1.0 / np.where(diag == 0, 1, diag), 1.0)
        lmax = np.array([estimate_lmax(m) for m in padded])
        levels.append(
            dict(
                mats=padded, inv_diag=inv_diag, lmax=lmax, n_pad=n_pad,
                pmats=(
                    [real_prol[b][l - 1] for b in range(B)] if l > 0 else None
                ),
            )
        )

    # coarse dense inverses (host scipy f64 factorization, shipped in dtype);
    # skipped entirely when the coarse space is too large to dense-invert
    # (the DOUBLE_M global coarse operator with many macro unknowns) — the
    # V-cycle then ends in a Chebyshev sweep at level 0.
    n0 = levels[0]["n_pad"]
    if n0 > DENSE_COARSE_MAXI:
        inv = None
    else:
        inv = np.zeros((B, n0, n0))
        for b in range(B):
            m = cons_stif[b][0].toarray()
            nb = m.shape[0]
            dense = np.eye(n0)
            dense[:nb, :nb] = m
            try:
                if not assume_sym:
                    raise scipy.linalg.LinAlgError  # go straight to LU
                cho = scipy.linalg.cho_factor(dense)
                inv[b] = scipy.linalg.cho_solve(cho, np.eye(n0))
            except scipy.linalg.LinAlgError:
                # semi-definite coarse matrix (weakly constrained body): LU
                # with a tiny Tikhonov shift keeps the V-cycle a valid
                # preconditioner
                shift = 1e-12 * np.abs(np.diag(dense)).max()
                lu = scipy.linalg.lu_factor(dense + shift * np.eye(n0))
                inv[b] = scipy.linalg.lu_solve(lu, np.eye(n0))

    structured = grids is not None and all(g is not None for g in grids)
    if structured:
        # group contiguous bodies with identical grid shapes (BatchBlocks)
        bounds = []
        start = 0
        for b in range(1, B + 1):
            if b == B or grids[b].shapes != grids[start].shapes:
                bounds.append((start, b))
                start = b

        def _grouped(build_one):
            return BatchBlocks(
                tuple(build_one(a, b) for a, b in bounds), tuple(bounds)
            )

    def _bell_fits(mats, n_rows, n_cols, dt):
        # a general sparse format (ELL/BlockEll via device_sparse) while its
        # BlockEll tiles would fit the byte budget; DIA is the at-scale
        # fallback where tiles would exhaust device memory
        from ..sparse.bell import BELL_MAX_BYTES, CB, RB, _max_slots

        S = _max_slots(mats, round_up(n_cols, CB))
        entries = len(mats) * (round_up(n_rows, RB) // RB) * S * RB * CB
        return entries * np.dtype(dt).itemsize <= BELL_MAX_BYTES

    if structured:
        from ..sparse.dia import dia_from_csr_list as _dia
        from ..sparse.dia import plane_dia_from_csr_list as _pdia

        def _dia_auto(mats, shape, n_rows, dt, pad_identity=True):
            # per-z-plane dedup FIRST: PlaneDia is 10-25x smaller than bell
            # tiles or plain Dia at the 8.8M-DOF scale — preferred whenever
            # the dedup pays (>=4x) or the un-deduplicated bytes would be
            # bandwidth-bound.  Small weakly-compressing groups take plain
            # Dia; ELL/BlockEll only where no structured format applies.
            pd = _pdia(mats, shape, n_rows, dt, pad_identity=pad_identity)
            if pd is not None:
                C, D, P = pd.vals.shape
                planes = pd.kz.size
                dia_bytes = planes * D * P * np.dtype(dt).itemsize
                if 4 * C <= planes or dia_bytes > DIA_LATENCY_BYTES:
                    return pd
                return _dia(mats, n_rows, dt, pad_identity=pad_identity)
            if _bell_fits(mats, n_rows, n_rows, dt) and pad_identity:
                return device_sparse(mats, n_rows, n_rows, jnp.dtype(dt))
            return _dia(mats, n_rows, dt, pad_identity=pad_identity)

    dev_levels = []
    for l, lv in enumerate(levels):
        if structured:
            np_dtype = np.dtype(jnp.dtype(dtype).name)
            A = _grouped(
                lambda a, b, lv=lv, l=l: _dia_auto(
                    lv["mats"][a:b], grids[a].shapes[l], lv["n_pad"], np_dtype
                )
            )
            if l > 0:
                n_f, n_c = lv["n_pad"], levels[l - 1]["n_pad"]

                def _prols(a, b, l=l, n_f=n_f, n_c=n_c, transpose=False):
                    g0 = grids[a]
                    mats = []
                    for bb in range(a, b):
                        S = _stencil_matrix(
                            real_prol[bb][l - 1], grids[bb].zmaps[l - 1]
                        )
                        mats.append(S.T.tocsr() if transpose else S)
                    Sd = _dia_auto(
                        mats, g0.shapes[l], n_f, np_dtype, pad_identity=False
                    )
                    fshape = g0.shapes[l]
                    cshape = g0.shapes[l - 1]
                    strides = g0.strides[l - 1]
                    if transpose:
                        return StructuredRest(Sd, fshape, cshape, strides, n_c)
                    return StructuredProl(Sd, fshape, cshape, strides, n_c)

                P = _grouped(lambda a, b: _prols(a, b))
                Pt = _grouped(lambda a, b: _prols(a, b, transpose=True))
            else:
                P = Pt = None
        else:
            if l > 0:
                n_fine, n_coar = lv["n_pad"], levels[l - 1]["n_pad"]
                P = device_sparse(lv["pmats"], n_fine, n_coar, dtype)
                Pt = device_sparse(
                    [m.T.tocsr() for m in lv["pmats"]], n_coar, n_fine, dtype
                )
            else:
                P = Pt = None
            A = device_sparse(lv["mats"], lv["n_pad"], lv["n_pad"], dtype)
        dev_levels.append(
            MgLevel(
                A=A,
                inv_diag=jnp.asarray(lv["inv_diag"], dtype),
                lmax=jnp.asarray(lv["lmax"], dtype),
                P=P,
                Pt=Pt,
            )
        )
    # Krylov matvec operator: f64 for true 1e-14-relative residuals (the
    # default solve dtype); in an f32 solve the solve dtype equals the
    # hierarchy dtype, so A_top aliases the finest-level buffers instead of
    # duplicating the largest operator in memory.  ``a_top_dtype`` lets the
    # caller (build_problem) thread its explicitly requested solve dtype
    # instead of re-deriving it from the global backend policy.
    from ..utils.precision import solve_dtype

    sd = a_top_dtype if a_top_dtype is not None else solve_dtype()
    if jnp.dtype(sd) == jnp.dtype(dtype):
        A_top = dev_levels[-1].A
    elif structured:
        A_top = _grouped(
            lambda a, b: _dia_auto(
                levels[-1]["mats"][a:b], grids[a].shapes[-1],
                levels[-1]["n_pad"], np.dtype(jnp.dtype(sd).name),
            )
        )
    else:
        A_top = device_sparse(
            levels[-1]["mats"], levels[-1]["n_pad"], levels[-1]["n_pad"], sd
        )
    return MgHierarchy(
        levels=tuple(dev_levels),
        coarse_inv=None if inv is None else jnp.asarray(inv, dtype),
        A_top=A_top,
    )


def chebyshev_smooth(
    A: Ell,
    inv_diag: jnp.ndarray,
    lmax: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    degree: int = CHEB_DEGREE,
) -> jnp.ndarray:
    """Chebyshev(degree) smoothing of A x = b on [lmax*frac, lmax*safety].

    Saad, Iterative Methods for Sparse Linear Systems, Alg. 12.1, with Jacobi
    left preconditioning.  ``lmax`` may carry batch axes matching b's.
    """
    lmax_s = (CHEB_UPPER_SAFETY * lmax)[..., None]
    lmin_s = (CHEB_LOWER_FRACTION * lmax)[..., None]
    theta = 0.5 * (lmax_s + lmin_s)
    delta = 0.5 * (lmax_s - lmin_s)
    r = b - A.mv(x)
    d = inv_diag * r / theta
    x = x + d
    rho = delta / theta
    for _ in range(degree - 1):
        r = r - A.mv(d)
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (inv_diag * r)
        x = x + d
        rho = rho_new
    return x


def coarse_solve(chol: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dense Cholesky solve (B,n0,n0) x (B,n0) (host-factored)."""
    y = jax.scipy.linalg.solve_triangular(chol, b[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), y, lower=False
    )
    return x[..., 0]


def vcycle(mg: MgHierarchy, b: jnp.ndarray, x: jnp.ndarray | None = None) -> jnp.ndarray:
    """One V(1,1) cycle on the finest level (MGPIS::MULT_VCYC semantics with
    the Chebyshev smoother).  b, x: (B, n_finest) in any float dtype; the
    cycle itself runs in the hierarchy's (f32) dtype and casts back."""
    L = len(mg.levels) - 1
    in_dtype = b.dtype
    dtype = mg.levels[-1].A.dtype

    def cycle(l: int, bl: jnp.ndarray, xl: jnp.ndarray) -> jnp.ndarray:
        if l == 0:
            if mg.coarse_inv is None:
                lv0 = mg.levels[0]
                return chebyshev_smooth(
                    lv0.A, lv0.inv_diag, lv0.lmax, bl, xl,
                    degree=COARSE_CHEB_DEGREE,
                )
            return jnp.einsum(
                "...ij,...j->...i", mg.coarse_inv, bl,
                preferred_element_type=dtype,
            )
        lv = mg.levels[l]
        xl = chebyshev_smooth(lv.A, lv.inv_diag, lv.lmax, bl, xl)
        r = bl - lv.A.mv(xl)
        rc = lv.Pt.mv(r)
        ec = cycle(l - 1, rc, jnp.zeros_like(rc))
        xl = xl + lv.P.mv(ec)
        xl = chebyshev_smooth(lv.A, lv.inv_diag, lv.lmax, bl, xl)
        return xl

    # scale into a well-ranged f32 window (residual norms can be ~1e-14*b)
    scale = jnp.maximum(
        jnp.abs(b).max(axis=-1, keepdims=True), jnp.finfo(b.dtype).tiny
    )
    b_s = (b / scale).astype(dtype)
    x_s = jnp.zeros_like(b_s) if x is None else (x / scale).astype(dtype)
    out = cycle(L, b_s, x_s)
    return out.astype(in_dtype) * scale
