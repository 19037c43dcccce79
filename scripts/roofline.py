"""Roofline artifact: measured device-memory bandwidth of the hot kernels.

Times the finest-level SpMV and one full V-cycle on the bench problem
(reference BLOCK menu-1 geometry) on the GPU — the op is chained inside one
jitted ``fori_loop`` so per-dispatch host latency cannot pollute the number
— and derives achieved GB/s from the bytes each kernel must move (operator
values + indices + vectors), as a share of the card's published peak.
Writes ``artifacts/roofline_<size>.json``.  Refuses to run on a non-GPU
backend or on a card missing from ``HBM_PEAK_GBS``.

Usage:  python scripts/roofline.py [small|medium]
"""

from __future__ import annotations

import json
import os
import sys
import time

HBM_PEAK_GBS = {
    # device-memory bandwidth by jax device_kind (NVIDIA H100 SXM data sheet)
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def _nbytes(tree) -> int:
    import jax

    seen = set()
    tot = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "nbytes") and id(leaf) not in seen:
            seen.add(id(leaf))
            tot += leaf.nbytes
    return tot


def _nbytes_dia_equiv(tree) -> int:
    """Bytes the operator WOULD occupy as plain (un-deduplicated) DIA —
    the roofline denominator comparable across formats: PlaneDia stores
    C class slabs but stands in for nz planes per body, so achieved-GB/s
    on stored bytes alone would reward slower kernels for compressing."""
    from ddpca_admm.sparse.dia import PlaneDia

    import jax

    tot = 0
    seen = set()

    def walk(obj):
        nonlocal tot
        if isinstance(obj, PlaneDia):
            if id(obj) in seen:
                return
            seen.add(id(obj))
            B, nz = obj.kz.shape
            C, D, P = obj.vals.shape
            tot += B * nz * D * P * obj.vals.dtype.itemsize + obj.kz.nbytes
            return
        leaves, treedef = jax.tree_util.tree_flatten(
            obj, is_leaf=lambda x: isinstance(x, PlaneDia) and x is not obj
        )
        for lf in leaves:
            if isinstance(lf, PlaneDia):
                walk(lf)
            elif hasattr(lf, "nbytes") and id(lf) not in seen:
                seen.add(id(lf))
                tot += lf.nbytes

    walk(tree)
    return tot


def chain_time(apply, op, x, n: int) -> float:
    """Seconds per op, measured as one jitted chain of n dependent calls
    fenced by ``block_until_ready``.  ``op`` is a jit ARGUMENT, not a
    closure: closing over a full-scale operator would embed its arrays as
    HLO constants."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def g(op, x):
        def body(i, c):
            y = apply(op, c)
            return y / (jnp.abs(y).max() + 1.0)
        return jax.lax.fori_loop(0, n, body, x)

    jax.block_until_ready(g(op, x))
    t0 = time.perf_counter()
    jax.block_until_ready(g(op, x))
    return (time.perf_counter() - t0) / n


def main() -> None:
    size = sys.argv[1] if len(sys.argv) > 1 else "small"
    os.environ.setdefault("DDPCA_BENCH_SIZE", size)
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import SIZE_LEVE, build

    from ddpca_admm.solvers.mg import vcycle
    from ddpca_admm.utils.device import nvidia_smi, require_gpu

    require_gpu()
    dev = jax.devices()[0]
    if dev.device_kind not in HBM_PEAK_GBS:
        raise SystemExit(f"no peak bandwidth on record for {dev.device_kind!r}")
    peak = HBM_PEAK_GBS[dev.device_kind]

    prob, meta, _ = build(SIZE_LEVE[size])
    mg = prob.mg
    x = jnp.ones_like(prob.cons_forc)

    # finest-level SpMV: bytes = operator (tiles+indices) + x + y
    top = mg.A_top
    mv_s = chain_time(lambda t, c: t.mv(c), top, x, 100)
    mv_bytes = _nbytes(top) + 2 * x.nbytes
    mv_bytes_equiv = _nbytes_dia_equiv(top) + 2 * x.nbytes
    # V-cycle: every level's operator read once per smoother application
    # (CHEB_DEGREE matvecs pre + post + 1 residual at each level) + P/Pt
    from ddpca_admm.solvers.mg import CHEB_DEGREE

    vc_s = chain_time(lambda m, c: vcycle(m, c), mg, x, 30)
    vc_bytes = vc_bytes_equiv = 0
    for lv in mg.levels:
        per_smooth = CHEB_DEGREE
        vc_bytes += _nbytes(lv.A) * (2 * per_smooth + 1)
        vc_bytes_equiv += _nbytes_dia_equiv(lv.A) * (2 * per_smooth + 1)
        if lv.P is not None:
            vc_bytes += _nbytes(lv.P) + _nbytes(lv.Pt)
            vc_bytes_equiv += _nbytes_dia_equiv(lv.P) + _nbytes_dia_equiv(lv.Pt)
    if mg.coarse_inv is not None:
        vc_bytes += mg.coarse_inv.nbytes
        vc_bytes_equiv += mg.coarse_inv.nbytes

    out = {
        "device": dev.device_kind,
        "nvidia_smi": nvidia_smi(),
        "size": size,
        "hbm_peak_gbs": peak,
        "spmv": {
            "seconds": mv_s,
            "bytes": mv_bytes,
            "achieved_gbs": round(mv_bytes / mv_s / 1e9, 1),
            "pct_of_peak": round(100.0 * mv_bytes / mv_s / 1e9 / peak, 1),
            "dia_equiv_gbs": round(mv_bytes_equiv / mv_s / 1e9, 1),
            "dia_equiv_pct_of_peak": round(
                100.0 * mv_bytes_equiv / mv_s / 1e9 / peak, 1),
        },
        "vcycle": {
            "seconds": vc_s,
            "bytes_model": vc_bytes,
            "achieved_gbs": round(vc_bytes / vc_s / 1e9, 1),
            "pct_of_peak": round(100.0 * vc_bytes / vc_s / 1e9 / peak, 1),
            "dia_equiv_gbs": round(vc_bytes_equiv / vc_s / 1e9, 1),
            "dia_equiv_pct_of_peak": round(
                100.0 * vc_bytes_equiv / vc_s / 1e9 / peak, 1),
        },
    }
    os.makedirs(os.path.join(os.path.dirname(__file__), "..", "artifacts"),
                exist_ok=True)
    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        f"roofline_{size}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
