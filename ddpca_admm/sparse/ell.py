"""Fixed-topology ELL sparse matrices for XLA.

The reference leans on Eigen row-major CSR SpMV everywhere; under XLA the
idiomatic equivalent for *static* sparsity (frozen after setup — true for
every operator in this framework) is ELL: per-row column indices padded to the
max row length.  SpMV is then a gather + multiply + row-sum, which XLA fuses
into a single memory-bound kernel, and batches of same-shape operators vmap
cleanly (one subdomain per batch lane).

Transposed operators (restriction = prolongation^T etc.) are materialized as
their own ELL at setup — scatter-free applies only.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

# unroll the slot axis into accumulated per-slot gathers/scatters up to this
# row degree; beyond it, fall back to the one-shot gathered product (large-k
# operators are rare and never the memory-critical ones)
ELL_UNROLL_MAX = 32


class Ell(NamedTuple):
    """ELL matrix; also used batched with leading axes on vals/cols."""

    vals: jnp.ndarray   # (..., n_rows, k)
    cols: jnp.ndarray   # (..., n_rows, k) int32; padded entries point at 0
    n_cols: int         # static logical column count

    @property
    def n_rows(self) -> int:
        return self.vals.shape[-2]

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x; x (..., n_cols) with batch axes broadcast against the
        matrix's batch axes.  Implemented as per-SLOT gathers accumulated
        into y — never materializes an (n_rows, n_cols) intermediate, and
        (for k <= ELL_UNROLL_MAX) never a (..., n_rows, k) one either: a
        compiler that tile-pads the minor k axis would expand that temp
        about tenfold at the 8.8M-DOF scale."""
        batch = jnp.broadcast_shapes(self.vals.shape[:-2], x.shape[:-1])
        n_rows, k = self.vals.shape[-2:]
        n_cols = x.shape[-1]
        if not batch:
            if k <= ELL_UNROLL_MAX:
                acc = self.vals[:, 0] * x[self.cols[:, 0]]
                for j in range(1, k):
                    acc = acc + self.vals[:, j] * x[self.cols[:, j]]
                return acc
            return (self.vals * x[self.cols]).sum(axis=-1)
        vals = jnp.broadcast_to(self.vals, batch + (n_rows, k))
        cols = jnp.broadcast_to(self.cols, batch + (n_rows, k))
        xb = jnp.broadcast_to(x, batch + (n_cols,))
        flat = int(np.prod(batch))

        if k <= ELL_UNROLL_MAX:
            def one(v, c, xx):
                acc = v[:, 0] * xx[c[:, 0]]
                for j in range(1, k):
                    acc = acc + v[:, j] * xx[c[:, j]]
                return acc
        else:
            def one(v, c, xx):
                return (v * xx[c]).sum(axis=-1)
        out = jax.vmap(one)(
            vals.reshape(flat, n_rows, k),
            cols.reshape(flat, n_rows, k),
            xb.reshape(flat, n_cols),
        )
        return out.reshape(batch + (n_rows,))

    def tmv(self, x: jnp.ndarray, n_out: int | None = None) -> jnp.ndarray:
        """y = A.T @ x via scatter-add: each stored entry (r, cols[r,k])
        contributes vals[r,k]*x[r] into y[cols[r,k]].  Padded entries carry
        value 0 and scatter harmlessly into slot 0.  The memory-sane way to
        apply operators whose *transpose* has bounded row degree (e.g.
        inteInpo: every integral point touches exactly 4 nodes, while a node
        may touch thousands of points)."""
        n_out = n_out or self.n_cols
        batch = jnp.broadcast_shapes(self.vals.shape[:-2], x.shape[:-1])
        n_rows, k = self.vals.shape[-2:]
        vals = jnp.broadcast_to(self.vals, batch + (n_rows, k))
        cols = jnp.broadcast_to(self.cols, batch + (n_rows, k))
        xb = jnp.broadcast_to(x, batch + (n_rows,))
        dtype = jnp.promote_types(self.dtype, x.dtype)
        if not batch:
            if k <= ELL_UNROLL_MAX:
                out = jnp.zeros(n_out, dtype)
                for j in range(k):
                    out = out.at[cols[:, j]].add(vals[:, j] * x)
                return out
            contrib = vals * xb[..., :, None]
            return jnp.zeros(n_out, contrib.dtype).at[cols.ravel()].add(
                contrib.ravel()
            )
        flat = int(np.prod(batch))

        if k <= ELL_UNROLL_MAX:
            # per-slot scatter accumulation: same total scatter work, but no
            # (..., n_rows, k) k-minor temp (see mv docstring)
            def one(v, c, xx):
                out = jnp.zeros(n_out, dtype)
                for j in range(k):
                    out = out.at[c[:, j]].add(v[:, j] * xx)
                return out

            out = jax.vmap(one)(
                vals.reshape(flat, n_rows, k),
                cols.reshape(flat, n_rows, k),
                xb.reshape(flat, n_rows),
            )
            return out.reshape(batch + (n_out,))
        contrib = vals * xb[..., :, None]
        out = jax.vmap(
            lambda c, cc: jnp.zeros(n_out, c.dtype).at[cc.ravel()].add(
                c.ravel()
            )
        )(contrib.reshape(flat, n_rows * k), cols.reshape(flat, n_rows * k))
        return out.reshape(batch + (n_out,))


def ell_from_csr(A: sp.spmatrix, k: int | None = None, n_rows: int | None = None) -> Ell:
    """Convert scipy sparse to ELL (NumPy arrays; cheap to ship to device).

    ``k`` pads the row length, ``n_rows`` pads the row count (for batching).
    Padded entries have value 0 and column 0.
    """
    A = A.tocsr()
    A.sum_duplicates()
    counts = np.diff(A.indptr)
    kmax = int(counts.max()) if counts.size else 1
    k = max(kmax, k or 1)
    n = A.shape[0] if n_rows is None else n_rows
    assert n >= A.shape[0]
    vals = np.zeros((n, k), dtype=A.dtype)
    cols = np.zeros((n, k), dtype=np.int32)
    # vectorized fill: position of each nnz within its row
    if A.nnz:
        rows = np.repeat(np.arange(A.shape[0]), counts)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        vals[rows, offs] = A.data
        cols[rows, offs] = A.indices
    return Ell(vals=vals, cols=cols, n_cols=int(A.shape[1]))


def stack_ells(mats: Sequence[sp.spmatrix], n_rows: int | None = None,
               n_cols: int | None = None, k: int | None = None) -> Ell:
    """Pad a list of sparse matrices to common shape and stack on axis 0."""
    kmax = max(
        (int(np.diff(m.tocsr().indptr).max()) if m.nnz else 1) for m in mats
    )
    k = max(kmax, k or 1)
    n = max(m.shape[0] for m in mats) if n_rows is None else n_rows
    nc = max(m.shape[1] for m in mats) if n_cols is None else n_cols
    ells = [ell_from_csr(m, k=k, n_rows=n) for m in mats]
    return Ell(
        vals=np.stack([e.vals for e in ells]),
        cols=np.stack([e.cols for e in ells]),
        n_cols=int(nc),
    )


def to_device(e: Ell, dtype=None) -> Ell:
    vals = jnp.asarray(e.vals, dtype=dtype)
    return Ell(vals=vals, cols=jnp.asarray(e.cols, dtype=jnp.int32), n_cols=e.n_cols)
