"""Block-ELL sparse format: SpMV as a block gather + dense tile einsum.

Plain ELL SpMV (ell.py) is a per-element gather ``x[cols]``.  Block-ELL
stores the matrix as dense tiles instead:

  * rows grouped into blocks of RB=8,
  * columns grouped into blocks of CB=128,
  * per row-block, the S distinct column-blocks it touches are stored as
    dense (8, 128) tiles + one int32 block index each.

SpMV is then a gather of whole 128-wide vectors + an einsum over the tiles.
The cost is storage (tiles are ~10% occupied for hex8 stiffness), which is
why ConstrainedSystem applies an RCM reordering (fem/constraints.py): it
drops S from ~18 to ~6 column-blocks per row-block.  The default device
format is plain ELL (``use_block_format``); Block-ELL is selected with
``DDPCA_SPARSE_FORMAT=bell``.

Role in the reference: these are the Eigen RowMajor SpMV kernels
(MGPIS.h:66-77 smoother sweeps, MCONTACT.h:2520-2522 coupling applies).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

RB = 8     # row-block
CB = 128   # column-block
# BlockEll stores dense (8,128) tiles, so low nnz/tile-entry fill wastes
# memory and bandwidth.  When Block-ELL is selected it is taken whenever the
# padded tiles fit this absolute byte budget (env-overridable); larger
# operators drop to ELL.
BELL_MAX_BYTES = int(
    os.environ.get("DDPCA_BELL_MAX_BYTES", str(2 << 30))
)


def round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def use_block_format() -> bool:
    """Device sparse format policy: plain ELL on every backend (XLA's
    element gather is fast on the CPU and the GPU, and block padding only
    costs memory and bandwidth).  DDPCA_SPARSE_FORMAT=bell selects
    Block-ELL (format-equality tests, format comparisons)."""
    return os.environ.get("DDPCA_SPARSE_FORMAT") == "bell"


class BlockEll(NamedTuple):
    """Block-ELL matrix; batched with leading axes on tiles/cblk.

    tiles: (..., n_rb, S, RB, CB) dense tiles (zero-padded slots)
    cblk:  (..., n_rb, S) int32 column-block indices (padded slots -> 0)
    n_cols: static padded column count (multiple of CB)
    """

    tiles: jnp.ndarray
    cblk: jnp.ndarray
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.tiles.shape[-4] * RB

    @property
    def dtype(self):
        return self.tiles.dtype

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x; batch axes broadcast like Ell.mv."""
        mat_batch = self.tiles.shape[:-4]
        batch = jnp.broadcast_shapes(mat_batch, x.shape[:-1])
        n_rb, S = self.tiles.shape[-4:-2]
        acc = jnp.promote_types(self.tiles.dtype, x.dtype)

        def one(tiles, cblk, xx):
            xb = xx.reshape(-1, CB)
            xg = xb[cblk]                      # (n_rb, S, CB) block gather
            # HIGHEST: never let an f32 tile product run in TF32 — the
            # solver precision policy needs true-f32 matvecs (also enforced
            # globally via jax_default_matmul_precision in __init__, but kept
            # explicit here so the kernel is correct standalone).
            y = jnp.einsum(
                "rsic,rsc->ri", tiles, xg, preferred_element_type=acc,
                precision=jax.lax.Precision.HIGHEST,
            )
            return y.reshape(-1)

        if not batch:
            return one(self.tiles, self.cblk, x)
        tiles = jnp.broadcast_to(self.tiles, batch + self.tiles.shape[-4:])
        cblk = jnp.broadcast_to(self.cblk, batch + self.cblk.shape[-2:])
        xb = jnp.broadcast_to(x, batch + x.shape[-1:])
        flat = int(np.prod(batch))
        out = jax.vmap(one)(
            tiles.reshape((flat,) + self.tiles.shape[-4:]),
            cblk.reshape((flat,) + self.cblk.shape[-2:]),
            xb.reshape(flat, x.shape[-1]),
        )
        return out.reshape(batch + (n_rb * RB,))


def _bell_arrays_single(
    A: sp.spmatrix, n_rows: int, n_cols: int, S: int, dtype
) -> tuple[np.ndarray, np.ndarray]:
    """Tile one csr matrix into (n_rb, S, RB, CB) + (n_rb, S) arrays.
    ``n_rows``/``n_cols`` are the padded sizes (multiples of RB/CB)."""
    n_rb = n_rows // RB
    ncb = n_cols // CB
    A = A.tocoo()
    if A.nnz == 0:
        return (
            np.zeros((n_rb, S, RB, CB), dtype),
            np.zeros((n_rb, S), np.int32),
        )
    rb = A.row // RB
    cb = A.col // CB
    key = rb.astype(np.int64) * ncb + cb
    uk, inv = np.unique(key, return_inverse=True)
    urb = (uk // ncb).astype(np.int64)
    ucb = (uk % ncb).astype(np.int32)
    starts = np.searchsorted(urb, np.arange(n_rb), side="left")
    slot_of_uk = np.arange(uk.size) - starts[urb]
    need = int(slot_of_uk.max()) + 1
    if need > S:
        raise ValueError(f"slot overflow: need {need} > S={S}")
    cblk = np.zeros((n_rb, S), np.int32)
    cblk[urb, slot_of_uk] = ucb
    tiles = np.zeros((n_rb, S, RB, CB), dtype)
    np.add.at(
        tiles,
        (rb, slot_of_uk[inv], A.row % RB, A.col % CB),
        A.data.astype(dtype),
    )
    return tiles, cblk


def _max_slots(mats: Sequence[sp.spmatrix], n_cols: int) -> int:
    """Max distinct column-blocks touched by any row-block, over the batch."""
    ncb = n_cols // CB
    S = 1
    for A in mats:
        A = A.tocoo()
        if A.nnz == 0:
            continue
        key = (A.row // RB).astype(np.int64) * ncb + A.col // CB
        uk = np.unique(key)
        counts = np.bincount(uk // ncb)
        S = max(S, int(counts.max()))
    return S


def bell_from_csr_list(
    mats: Sequence[sp.spmatrix],
    n_rows: int | None = None,
    n_cols: int | None = None,
    dtype=np.float32,
    batch_shape: tuple[int, ...] | None = None,
) -> BlockEll:
    """Build a (stacked) device BlockEll from scipy matrices; sizes padded to
    (RB, CB) multiples and the batch maxima.  ``batch_shape`` reshapes the
    leading stack axis (e.g. (R, 2))."""
    n_rows = round_up(n_rows or max(m.shape[0] for m in mats), RB)
    n_cols = round_up(n_cols or max(m.shape[1] for m in mats), CB)
    S = _max_slots(mats, n_cols)
    parts = [_bell_arrays_single(m, n_rows, n_cols, S, dtype) for m in mats]
    tiles = np.stack([p[0] for p in parts])
    cblk = np.stack([p[1] for p in parts])
    if batch_shape is not None:
        tiles = tiles.reshape(batch_shape + tiles.shape[1:])
        cblk = cblk.reshape(batch_shape + cblk.shape[1:])
    elif len(mats) == 1:
        tiles, cblk = tiles[0], cblk[0]
    return BlockEll(
        tiles=jnp.asarray(tiles), cblk=jnp.asarray(cblk), n_cols=n_cols
    )


def device_sparse(
    mats: Sequence[sp.spmatrix],
    n_rows: int | None = None,
    n_cols: int | None = None,
    dtype=None,
    batch_shape: tuple[int, ...] | None = None,
    force_ell: bool = False,
):
    """Format-dispatching device sparse builder: ELL, or BlockEll where
    ``use_block_format`` selects it.  Row/column counts are always padded to
    (RB, CB)=(8, 128) multiples so the two formats produce identically
    shaped vectors.  ``force_ell`` keeps plain ELL even where BlockEll is
    selected (operators applied by transpose-scatter, Ell.tmv)."""
    from .ell import Ell, stack_ells, to_device

    n_rows = round_up(n_rows or max(m.shape[0] for m in mats), RB)
    n_cols = round_up(n_cols or max(m.shape[1] for m in mats), CB)
    if use_block_format() and not force_ell:
        # 3-D FEM bands grow like n^(2/3), so tile fill collapses at scale
        # (5% at the 180k-DOF BLOCK); pay the padding as long as the tiles
        # fit the byte budget — see BELL_MAX_BYTES above.
        S = _max_slots(mats, n_cols)
        # materialize and budget in the eventual solve dtype: uploading f64
        # tiles and downcasting later (cast_pytree) would triple the peak
        # device memory of the build
        from ..utils.precision import solve_dtype

        eff = np.dtype(dtype) if dtype else np.dtype(
            jnp.dtype(solve_dtype()).name
        )
        tile_bytes = len(mats) * (n_rows // RB) * S * RB * CB * eff.itemsize
        take = tile_bytes <= BELL_MAX_BYTES
        if os.environ.get("DDPCA_SPARSE_DEBUG"):
            nnz = sum(m.nnz for m in mats)
            print(
                f"[sparse] {len(mats)}x({n_rows}x{n_cols}) S={S} "
                f"tiles={tile_bytes / 1e6:.0f}MB nnz={nnz / 1e6:.2f}M "
                f"fill={nnz * eff.itemsize / max(tile_bytes, 1):.3f}"
                f" -> {'bell' if take else 'ELL'}",
                flush=True,
            )
        if take:
            return bell_from_csr_list(
                mats, n_rows, n_cols, dtype=eff, batch_shape=batch_shape,
            )
    e = stack_ells(mats, n_rows=n_rows, n_cols=n_cols)
    if batch_shape is not None:
        e = Ell(
            vals=e.vals.reshape(batch_shape + e.vals.shape[1:]),
            cols=e.cols.reshape(batch_shape + e.cols.shape[1:]),
            n_cols=e.n_cols,
        )
    elif len(mats) == 1:
        e = Ell(vals=e.vals[0], cols=e.cols[0], n_cols=e.n_cols)
    if dtype is None:
        # same peak-HBM rule as the bell path: upload in the solve dtype
        from ..utils.precision import solve_dtype

        dtype = solve_dtype()
    return to_device(e, dtype)


def compact_device_sparse(
    mats_groups: "Sequence[Sequence[sp.spmatrix]]",
    n_cols: int,
    batch_shape: tuple[int, ...],
    row_offsets: "Sequence[int] | None" = None,
    idx_dtype=np.int32,
):
    """Row-compact stacking for tall operators that are nonzero on few rows.

    ``mats_groups``: one or more lists of equally-indexed sparse matrices
    (e.g. [TtP_list, Tt_list]) sharing row sparsity; the union row set per
    slot is used for all groups so they share one scatter index.
    ``row_offsets``: optional per-slot offset added to the stored row ids
    (e.g. body*n_pad for scatter into a stacked (B, n) vector).

    Returns ([Ell, ...] one per group — (batch..., r_pad, k), idx
    (batch..., r_pad)); padded rows carry no entries (mv -> exact 0) and
    scatter into slot 0 harmlessly.  Applied as
    ``full.at[idx].add(ell.mv(x))``.
    """
    n_slots = len(mats_groups[0])
    rowsets = []
    for j in range(n_slots):
        rs = np.unique(
            np.concatenate(
                [g[j].tocoo().row for g in mats_groups]
                + [np.zeros(0, dtype=np.int64)]
            )
        )
        rowsets.append(rs)
    r_pad = int(round_up(max([rs.size for rs in rowsets] + [1]), 8))
    idxs = np.zeros((n_slots, r_pad), dtype=idx_dtype)
    for j, rs in enumerate(rowsets):
        off = 0 if row_offsets is None else int(row_offsets[j])
        idxs[j, : rs.size] = rs + off
    ells = []
    for g in mats_groups:
        comp = [
            m.tocsr()[rs] if rs.size else sp.csr_matrix((0, m.shape[1]))
            for m, rs in zip(g, rowsets)
        ]
        ells.append(
            device_sparse(comp, r_pad, n_cols, batch_shape=batch_shape)
        )
    import jax.numpy as _jnp

    return ells, _jnp.asarray(idxs.reshape(tuple(batch_shape) + (r_pad,)))
