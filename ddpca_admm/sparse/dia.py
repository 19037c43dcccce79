"""DIA (diagonal) sparse format: the gather-free SpMV for structured grids.

A hex8 stiffness on a UNIFORM Cartesian grid in coordinate-lexicographic
node order (z,y,x major, 3 dof minor) is a pure stencil: every row's
couplings sit at a fixed set of ``col - row`` offsets (99 distinct offsets
for the 8.8M-DOF BLOCK stiffness).  Storing the matrix as one value-vector
per offset turns SpMV into

    y = sum_d  vals[d] * shift(x, offset_d)

— static slices of a padded x, no gather at all.  This is the 8.8M-DOF BLOCK
path: BlockEll tiles at that scale would need ~50 GB while DIA stores
~1.2x nnz.

``offsets`` are static (pytree aux data) so the shifts compile to
``lax.slice``; vals rows are aligned so vals[..., d, i] = A[i, i + off_d]
(zero where out of range).  Batched over a leading body axis like Ell.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_pytree_node_class
class Dia:
    """Batched DIA matrix; vals (..., D, n_active), offsets static tuple.

    Rows beyond ``n_active`` (the padded tail up to ``n_rows``) store NO
    values: the tail acts as identity (hierarchy padding convention) or zero
    (``tail_identity=False``, used by the transfer stencils) — storing
    explicit tail values wasted ~1 GB of zeros for small-body groups padded
    to the batch maximum at the 8.8M-DOF scale."""

    def __init__(self, vals, offsets: tuple[int, ...], n_rows: int,
                 tail_identity: bool = True):
        self.vals = vals
        self.offsets = tuple(int(o) for o in offsets)
        self._n_rows = int(n_rows)
        self.tail_identity = bool(tail_identity)

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self._n_rows, self.tail_identity)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2])

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def n_cols(self) -> int:
        return self._n_rows

    @property
    def n_active(self) -> int:
        return self.vals.shape[-1]

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x; batch axes broadcast against the matrix's batch axes.
        Square case (n_rows == n_cols) with per-offset aligned values."""
        batch = jnp.broadcast_shapes(self.vals.shape[:-2], x.shape[:-1])
        n = self._n_rows
        na = self.n_active
        xb = jnp.broadcast_to(x, batch + (n,))
        vals = jnp.broadcast_to(self.vals, batch + self.vals.shape[-2:])
        lo = min(self.offsets + (0,))
        hi = max(self.offsets + (0,))
        pad = [(0, 0)] * len(batch) + [(-lo, hi)]
        xp = jnp.pad(xb, pad)
        y = jnp.zeros(batch + (na,), jnp.promote_types(self.dtype, x.dtype))
        for d, off in enumerate(self.offsets):
            start = off - lo
            win = jax.lax.slice_in_dim(xp, start, start + na, axis=-1)
            y = y + vals[..., d, :] * win
        if na == n:
            return y
        tail = (
            xb[..., na:]
            if self.tail_identity
            else jnp.zeros(batch + (n - na,), y.dtype)
        )
        return jnp.concatenate([y, tail], axis=-1)

    def nbytes(self) -> int:
        return self.vals.nbytes


@jax.tree_util.register_pytree_node_class
class PlaneDia:
    """Per-z-plane-deduplicated batched DIA for uniform structured grids.

    A hex8 stiffness (or transfer stencil) on a uniform grid in
    coordinate-lex order is translation-invariant along z except on special
    planes (grid boundary, Dirichlet mask, contact-penalty faces): the
    (D, P)-slab of diagonal values for one z-plane of nodes (P = 3*ny*nx
    dofs) takes only a handful of DISTINCT values over z.  Storing one slab
    per equivalence class plus an int32 class id per (body, plane) cuts the
    8.8M-DOF finest level from ~139 MB/body to ~15 MB/body.

    vals: (C, D, P) unique value slabs; kz: (B, nz) class per plane.  The
    SpMV gathers whole value ROWS per (body, plane, offset), so it does DIA
    arithmetic while storing C slabs instead of nz.
    """

    def __init__(self, vals, kz, offsets: tuple[int, ...], n_rows: int,
                 plane: int, tail_identity: bool = True):
        self.vals = vals          # (C, D, P)
        self.kz = kz              # (B, nz) int32
        self.offsets = tuple(int(o) for o in offsets)
        self._n_rows = int(n_rows)
        self.plane = int(plane)
        self.tail_identity = bool(tail_identity)

    def tree_flatten(self):
        return (self.vals, self.kz), (
            self.offsets, self._n_rows, self.plane, self.tail_identity
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def n_cols(self) -> int:
        return self._n_rows

    @property
    def n_active(self) -> int:
        return self.kz.shape[-1] * self.plane

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        nz = self.kz.shape[-1]
        P = self.plane
        na = nz * P
        n = self._n_rows
        batch = jnp.broadcast_shapes(self.kz.shape[:-1], x.shape[:-1])
        xb = jnp.broadcast_to(x, batch + (n,))
        kzb = jnp.broadcast_to(self.kz, batch + (nz,))
        lo = min(self.offsets + (0,))
        hi = max(self.offsets + (0,))
        pad = [(0, 0)] * len(batch) + [(-lo, hi)]
        xp = jnp.pad(xb[..., :na], pad)
        out_dtype = jnp.promote_types(self.dtype, x.dtype)
        y = jnp.zeros(batch + (nz, P), out_dtype)
        for d, off in enumerate(self.offsets):
            start = off - lo
            win = jax.lax.slice_in_dim(xp, start, start + na, axis=-1)
            win = win.reshape(batch + (nz, P))
            Vd = jnp.take(self.vals[:, d, :], kzb, axis=0)  # fast row gather
            y = y + Vd * win
        y = y.reshape(batch + (na,))
        if na == n:
            return y
        tail = (
            xb[..., na:]
            if self.tail_identity
            else jnp.zeros(batch + (n - na,), y.dtype)
        )
        return jnp.concatenate([y, tail], axis=-1)

    def nbytes(self) -> int:
        return self.vals.nbytes + self.kz.nbytes


# plane-dedup merge radius (relative): translated copies of the same
# element pattern differ only by fp noise from the mesh subdivision
# arithmetic (~1e-13 relative, measured on BLOCK leve4), so slabs within
# DEDUP_RTOL merge; genuinely different planes (Dirichlet mask, penalty
# faces) sit decades apart.  The stored representative is an EXACT slab
# from one member plane, so the effective operator perturbation is the
# actual within-class spread (~1e-13), not the merge radius.  Bitwise
# hashing cannot express this (dense ulp noise straddles any quantization
# boundary somewhere in a 700k-entry slab), hence representative
# comparison, pre-filtered by cheap scalar signatures.
DEDUP_RTOL = 1.0e-8


class _SlabDedup:
    def __init__(self, amax: float):
        self.amax = max(float(amax), 1.0e-300)
        self.reps: list[np.ndarray] = []
        self.sigs: list[tuple[float, float]] = []

    def lookup(self, slab: np.ndarray) -> int | None:
        tol = DEDUP_RTOL * self.amax
        s1 = float(slab.sum())
        s2 = float(np.abs(slab).sum())
        n = slab.size
        for cid, (r1, r2) in enumerate(self.sigs):
            if abs(s1 - r1) > n * tol or abs(s2 - r2) > n * tol:
                continue
            if np.allclose(slab, self.reps[cid], rtol=0.0, atol=tol):
                return cid
        return None

    def add(self, slab: np.ndarray) -> int:
        self.reps.append(slab)
        self.sigs.append((float(slab.sum()), float(np.abs(slab).sum())))
        return len(self.reps) - 1


def plane_dia_from_csr_list(
    mats: Sequence[sp.spmatrix],
    shape: tuple[int, int, int],
    n_rows: int,
    dtype=np.float32,
    offsets: np.ndarray | None = None,
    pad_identity: bool = True,
    max_classes: int = 2048,
) -> "PlaneDia | None":
    """Build a PlaneDia for a batch of same-grid matrices, or None when the
    planes do not deduplicate into at most ``max_classes`` distinct slabs
    (the caller falls back to ELL/plain Dia; the bound also caps the
    quadratic cost of the dedup search).  ``shape`` = (nz, ny, nx) node
    grid; active rows are exactly 3*nz*ny*nx, anything beyond (hierarchy
    padding) follows the Dia tail convention."""
    nz, ny, nx = (int(s) for s in shape)
    P = 3 * ny * nx
    n_act = nz * P
    if n_act > n_rows or n_act == 0:
        return None
    if offsets is None:
        offsets = dia_offsets(mats)
    if 0 not in offsets:
        offsets = np.sort(np.append(offsets, 0))
    offsets = np.asarray(offsets, np.int64)
    D = offsets.size
    B = len(mats)
    kz = np.zeros((B, nz), np.int32)
    amax = max(
        (float(np.abs(m.data).max()) if m.nnz else 0.0) for m in mats
    )
    dedup = _SlabDedup(amax)
    for b, m in enumerate(mats):
        c = m.tocoo()
        if m.shape[0] > n_act:
            # hierarchy padding must be a bare unit diagonal
            tail = c.row >= n_act
            if not (
                (c.col[tail] == c.row[tail]).all()
                and (c.data[tail] == 1.0).all()
            ):
                return None
        vals = np.zeros((D, n_act), np.float64)
        keep = c.row < n_act
        k = np.searchsorted(
            offsets, c.col[keep].astype(np.int64) - c.row[keep]
        )
        np.add.at(vals, (k, c.row[keep]), c.data[keep])
        if pad_identity and m.shape[0] < n_act:
            zero_slot = int(np.searchsorted(offsets, 0))
            vals[zero_slot, m.shape[0]:] = 1.0
        v3 = vals.reshape(D, nz, P)
        for z in range(nz):
            slab = np.ascontiguousarray(v3[:, z, :])
            cid = dedup.lookup(slab)
            if cid is None:
                cid = dedup.add(slab)
                if cid + 1 > max_classes:
                    return None
            kz[b, z] = cid
    pvals = np.stack(
        [r.astype(dtype) for r in dedup.reps], axis=0
    )   # (C, D, P)
    return PlaneDia(
        jnp.asarray(pvals), jnp.asarray(kz),
        tuple(int(o) for o in offsets), n_rows, P,
        tail_identity=pad_identity,
    )


def dia_offsets(mats: Sequence[sp.spmatrix]) -> np.ndarray:
    """Union of col-row offsets over a batch of square matrices."""
    offs = [np.zeros(0, np.int64)]
    for m in mats:
        c = m.tocoo()
        offs.append(np.unique(c.col.astype(np.int64) - c.row))
    return np.unique(np.concatenate(offs))


def dia_from_csr_list(
    mats: Sequence[sp.spmatrix],
    n_rows: int | None = None,
    dtype=np.float32,
    offsets: np.ndarray | None = None,
    pad_identity: bool = True,
) -> Dia:
    """Stack square matrices as a batched Dia padded to ``n_rows``.  The
    padded tail (and any trailing identity block the caller already appended)
    is NOT stored: Dia.mv treats rows past ``n_active`` as identity
    (``pad_identity=True``, hierarchy convention) or zero."""
    n = n_rows or max(m.shape[0] for m in mats)
    coos = [m.tocoo() for m in mats]
    # active range: rows that are anything but a bare 1.0 diagonal
    n_act = 1
    for c in coos:
        nontrivial = (c.col != c.row) | (c.data != 1.0)
        if nontrivial.any():
            n_act = max(n_act, int(c.row[nontrivial].max()) + 1)
        if not pad_identity and c.row.size:
            n_act = max(n_act, int(c.row.max()) + 1)
    n_act = min(n, n_act)
    if offsets is None:
        offsets = dia_offsets(mats)
    if 0 not in offsets:
        offsets = np.sort(np.append(offsets, 0))
    offsets = np.asarray(offsets, np.int64)
    zero_slot = int(np.searchsorted(offsets, 0))
    B = len(mats)
    vals = np.zeros((B, offsets.size, n_act), dtype)
    for b, c in enumerate(coos):
        keep = c.row < n_act
        k = np.searchsorted(
            offsets, c.col[keep].astype(np.int64) - c.row[keep]
        )
        np.add.at(vals[b], (k, c.row[keep]), c.data[keep].astype(dtype))
        if pad_identity:
            # unit diagonal on stored-but-inactive rows of SMALLER batch
            # members (their tail within n_act must stay decoupled identity
            # unless the matrix itself provided it)
            m_n = mats[b].shape[0]
            if m_n < n_act:
                vals[b, zero_slot, m_n:] = 1.0
    return Dia(
        jnp.asarray(vals), tuple(int(o) for o in offsets), n,
        tail_identity=pad_identity,
    )
