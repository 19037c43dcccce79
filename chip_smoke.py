#!/usr/bin/env python3
"""GPU smoke test: the ADMM contact solve end to end on one card.

    python3 chip_smoke.py            # phases build, operators, block, cylinder
    python3 chip_smoke.py --multi    # only the 4-card sharded-vs-single check

Phases, in one process and in sequence:

  build      BLOCK menu 1 at glob_leve 2 (180,684 DOF, 30 bodies, divi 6^3,
             doleMcsc 1, muscSett 2) through ``bench.build``.
  operators  every SpMV format the leve-2 problem uses at its finest level
             and in one transfer operator (PlaneDia, Dia, and ELL or
             Block-ELL) against scipy's f64 product on the same stored
             values: max|y - y_ref| <= 1e-5 max|y_ref| for
             f32 operators (the GPU sums in another order), 1e-12 for f64.
  block      ``contact_analysis`` on that problem: converged within 3000
             iterations, and the patch-test oracle |u_z - p z / E| <=
             1e-4 |p| 0.075 / E on every body.
  cylinder   CYLINDER Hertz contact (hanging nodes, the ELL hierarchy,
             coarse correction A): converged, contact force within 5 % of
             the applied line load, peak pressure in (0.6, 1.3) x Hertz p_max.
  multi      (``--multi`` only) ``__graft_entry__.dryrun_multichip(4)``: the
             1-axis and 2x2 meshes against the single-card solve, rel 1e-9
             and the same iteration count.

Each phase prints one JSON line with its result, its seconds and the peak
device memory; then the cards' name and power limit from nvidia-smi; then,
only if every phase passed, the last line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, when JAX's backend is not a GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import scipy.sparse as sp

ROOT = os.path.dirname(os.path.abspath(__file__))
GLOB_LEVE = 2
BASELINE_KEY = "block_divi6_leve2_doma2"
TOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- operators


def _dia_csr(vals: np.ndarray, offsets, n: int, n_cols: int,
             tail_identity: bool) -> sp.csr_matrix:
    """One body's DIA values (D, na) as an (n, n) CSR matrix; columns at or
    past ``n_cols`` read zero (PlaneDia reads only its active rows of x)."""
    D, na = vals.shape
    rows, cols, data = [], [], []
    i = np.arange(na)
    for d, off in enumerate(offsets):
        j = i + off
        keep = (j >= 0) & (j < n_cols)
        rows.append(i[keep])
        cols.append(j[keep])
        data.append(vals[d, keep])
    if tail_identity and na < n:
        t = np.arange(na, n)
        rows.append(t)
        cols.append(t)
        data.append(np.ones(n - na, vals.dtype))
    return sp.csr_matrix(
        (np.concatenate(data).astype(np.float64),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def to_scipy(op) -> list[sp.csr_matrix]:
    """Per-body f64 scipy matrices holding exactly the values ``op`` stores
    (PlaneDia, Dia, Ell or BlockEll with one leading body axis)."""
    from ddpca_admm.sparse.bell import CB, RB, BlockEll
    from ddpca_admm.sparse.dia import Dia, PlaneDia
    from ddpca_admm.sparse.ell import Ell

    if isinstance(op, PlaneDia):
        vals = np.asarray(op.vals)             # (C, D, P)
        kz = np.asarray(op.kz)                 # (B, nz)
        na = kz.shape[1] * op.plane
        return [
            _dia_csr(vals[kz[b]].transpose(1, 0, 2).reshape(vals.shape[1], na),
                     op.offsets, op.n_rows, na, op.tail_identity)
            for b in range(kz.shape[0])
        ]
    if isinstance(op, Dia):
        vals = np.asarray(op.vals)             # (B, D, na)
        return [
            _dia_csr(v, op.offsets, op.n_rows, op.n_rows, op.tail_identity)
            for v in vals
        ]
    if isinstance(op, Ell):
        vals, cols = np.asarray(op.vals), np.asarray(op.cols)  # (B, n, k)
        n, k = vals.shape[-2:]
        r = np.repeat(np.arange(n), k)
        return [
            sp.csr_matrix((v.reshape(-1).astype(np.float64),
                           (r, c.reshape(-1))), shape=(n, op.n_cols))
            for v, c in zip(vals, cols)
        ]
    if isinstance(op, BlockEll):
        tiles, cblk = np.asarray(op.tiles), np.asarray(op.cblk)
        out = []
        for t, cb in zip(tiles, cblk):          # t (n_rb, S, RB, CB)
            n_rb, S = cb.shape
            rb, s, i, c = np.meshgrid(np.arange(n_rb), np.arange(S),
                                      np.arange(RB), np.arange(CB),
                                      indexing="ij")
            out.append(sp.csr_matrix(
                (t.reshape(-1).astype(np.float64),
                 ((rb * RB + i).reshape(-1),
                  (cb[rb, s] * CB + c).reshape(-1))),
                shape=(n_rb * RB, op.n_cols)))
        return out
    raise TypeError(f"no scipy reference for {type(op).__name__}")


def compare(name: str, op, x: np.ndarray) -> dict:
    """max|op.mv(x) - scipy(op) @ x| against the dtype's tolerance."""
    import jax

    y = jax.jit(lambda o, v: o.mv(v))(op, x)
    y = np.asarray(jax.block_until_ready(y), np.float64)
    ref = np.stack([
        m @ xb.astype(np.float64) for m, xb in zip(to_scipy(op), x)
    ])
    check(y.shape == ref.shape, f"{name}: shape {y.shape} != {ref.shape}")
    check(bool(np.isfinite(y).all()), f"{name}: non-finite output")
    scale = float(np.abs(ref).max())
    err = float(np.abs(y - ref).max()) / scale
    tol = TOL[np.dtype(op.dtype)]
    check(err <= tol, f"{name}: rel err {err:.3e} > {tol:.0e}")
    return {"op": name, "format": type(op).__name__,
            "dtype": str(np.dtype(op.dtype)), "rel_err": err}


def _one_batch_axis(op):
    """An ELL / Block-ELL with its leading (region, side) axes merged into
    one batch axis."""
    from ddpca_admm.sparse.bell import BlockEll
    from ddpca_admm.sparse.ell import Ell

    if isinstance(op, Ell):
        k = op.vals.shape[-2:]
        return Ell(op.vals.reshape((-1,) + k), op.cols.reshape((-1,) + k),
                   op.n_cols)
    t, c = op.tiles.shape[-4:], op.cblk.shape[-2:]
    return BlockEll(op.tiles.reshape((-1,) + t), op.cblk.reshape((-1,) + c),
                    op.n_cols)


def check_operators(prob, seed: int = 0) -> dict:
    """Phase (a): the finest-level operators (V-cycle f32 and Krylov f64),
    the inner stencil of one transfer operator, the Gram operator, and one
    interface-trace operator (ELL or Block-ELL), each group of bodies
    separately."""
    from ddpca_admm.solvers.mg import BatchBlocks
    from ddpca_admm.sparse.dia import PlaneDia

    rng = np.random.default_rng(seed)
    top = prob.mg.levels[-1]

    def groups(op):
        return op.ops if isinstance(op, BatchBlocks) else (op,)

    named = []
    for label, container in (("A_f32", top.A), ("A_top", prob.mg.A_top)):
        for gi, op in enumerate(groups(container)):
            named.append((f"{label}[{gi}]", op))
    for gi, prol in enumerate(groups(top.P)):
        named.append((f"P.S[{gi}]", getattr(prol, "S", prol)))
    named.append(("gram", prob.gram))
    named.append(("Bp", _one_batch_axis(prob.groups[0].Bp)))

    results = []
    for name, op in named:
        B = (op.kz if isinstance(op, PlaneDia) else
             op.vals if hasattr(op, "vals") else op.tiles).shape[0]
        n = op.n_cols
        x = rng.standard_normal((B, n)).astype(np.dtype(op.dtype))
        results.append(compare(name, op, x))
    return {"checked": results}


# -------------------------------------------------------------- main paths


def solve_block(prob, meta, model) -> dict:
    """Phase (b): converge, then the patch-test oracle on every body."""
    import jax

    from ddpca_admm.admm.loop import contact_analysis

    modes = tuple(meta.group_modes)
    t0 = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=3000)
    jax.block_until_ready(st.u)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=3000)
    jax.block_until_ready(st.u)
    solve_s = time.perf_counter() - t0
    check(bool(st.converged), f"not converged after {int(st.it)} iterations")
    cfg = model.cfg
    E, p = cfg.e_mod, cfg.pressure
    tol = 1e-4 * abs(p) * 0.075 / E
    worst = 0.0
    for b, (body, sysm) in enumerate(zip(model.bodies, meta.systems)):
        full = sysm.full_displacement(np.asarray(st.u[b])[: sysm.n_dof])
        err = np.abs(full[2::3] - p * body.mesh.coords[:, 2] / E).max()
        check(bool(np.isfinite(err)), f"body {b}: non-finite displacement")
        worst = max(worst, float(err))
    check(worst <= tol, f"patch test: max |u_z - pz/E| {worst:.3e} > {tol:.3e}")
    with open(os.path.join(ROOT, "baseline_measured.json")) as f:
        ref_it = json.load(f)[BASELINE_KEY]["admm_iterations"]
    return {"iterations": int(st.it), "reference_iterations": ref_it,
            "inner_cg_iterations": int(st.inner_iters),
            "compile_and_solve_s": first_s, "solve_s": solve_s,
            "patch_err": worst, "patch_tol": tol}


def solve_cylinder() -> dict:
    """Phase (c): tests/test_cylinder_stack.py's mirror-half case and its
    checks."""
    import jax

    from ddpca_admm.admm.loop import contact_analysis
    from ddpca_admm.models.cylinder import (
        CylinderConfig,
        build_cylinder_model,
        region_pressures,
    )

    cfg = CylinderConfig(
        glob_inho=2, glob_homo=0, loca_leve=3, divi=(2, 2, 1, 2),
        band_widt=8e-4, stack4=True, cross_corner=False, copy_numb=1,
    )
    prob, meta, bodies, cfg = build_cylinder_model(cfg)
    t0 = time.perf_counter()
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800)
    jax.block_until_ready(st.u)
    solve_s = time.perf_counter() - t0
    check(bool(st.converged), f"not converged after {int(st.it)} iterations")
    _, p_max = cfg.hertz
    pres = region_pressures(meta, st)
    f_expect = abs(cfg.load_inte) * cfg.leng / 2   # mirror halves
    forces = [pres[ri][1] for ri in range(4)]
    peaks = [pres[ri][0] for ri in range(4)]
    for ri in range(4):
        check(abs(forces[ri] - f_expect) <= 0.05 * f_expect,
              f"region {ri}: force {forces[ri]:.6g} vs {f_expect:.6g}")
        check(0.6 * p_max < peaks[ri] < 1.3 * p_max,
              f"region {ri}: peak {peaks[ri]:.6g} vs p_max {p_max:.6g}")
    check(abs(peaks[0] - peaks[3]) <= 0.02 * abs(peaks[3]),
          f"bottom/top peaks differ: {peaks[0]:.6g} vs {peaks[3]:.6g}")
    for ri in list(pres)[4:]:     # mid-circle interfaces
        check(pres[ri][0] < 0.5 * p_max,
              f"interface {ri}: peak {pres[ri][0]:.6g} >= p_max / 2")
    return {"bodies": len(bodies), "iterations": int(st.it),
            "compile_and_solve_s": solve_s, "force_expect": f_expect,
            "forces": forces, "peaks": peaks, "hertz_p_max": p_max}


def run_multi() -> dict:
    """Phase (d): the sharded solves on four cards against one card."""
    import jax

    sys.path.insert(0, ROOT)
    from __graft_entry__ import dryrun_multichip

    n = len(jax.devices())
    check(n == 4, f"--multi needs 4 devices, JAX sees {n}")
    dryrun_multichip(4)
    return {"devices": n, "meshes": ["4", "2x2"]}


# -------------------------------------------------------------------- driver


def run_phase(name: str, fn) -> bool:
    """Run one phase, print its JSON line, and say whether it passed."""
    from ddpca_admm.utils.device import peak_bytes_in_use

    t0 = time.perf_counter()
    ok = True
    try:
        info = fn()
    except Exception as e:  # report the phase and go on to the verdict
        traceback.print_exc()
        ok, info = False, {"error": f"{type(e).__name__}: {e}"}
    line = {"phase": name, "ok": ok,
            "seconds": time.perf_counter() - t0,
            "peak_bytes_in_use": peak_bytes_in_use(), **info}
    print(json.dumps(line, default=float), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded-vs-single phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the operator-check vectors")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from ddpca_admm.utils.device import device_info, nvidia_smi, require_gpu

    require_gpu()
    oks = []
    if args.multi:
        oks.append(run_phase("multi", run_multi))
    else:
        import bench

        built = []

        def build():
            built.extend(bench.build(GLOB_LEVE))
            return {"glob_leve": GLOB_LEVE, "bodies": len(built[1].systems),
                    "dof": sum(s.n_dof for s in built[1].systems)}

        oks.append(run_phase("build", build))
        if oks[-1]:
            prob, meta, model = built
            oks.append(run_phase(
                "operators", lambda: check_operators(prob, args.seed)))
            oks.append(run_phase(
                "block", lambda: solve_block(prob, meta, model)))
            del prob, meta, model
            built.clear()
        oks.append(run_phase("cylinder", solve_cylinder))
    print(nvidia_smi(), flush=True)
    if not all(oks):
        print(f"chip_smoke: {oks.count(False)} phase(s) failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
