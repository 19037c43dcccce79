"""Command-line driver for the example problems.

Replaces the reference's interactive stdin menus (Test.cpp:33-67 and the
per-example .cpp drivers) with argparse subcommands.  Each example runs the
full pipeline (mesh -> search -> ESTABLISH -> ADMM and/or LAGRANGE), writes
the reference-compatible result files (resuNode_/resuElem_/resuDisp_/
resuStre_/resuCont_*.txt), and prints a JSON summary line.

Usage:
  python -m ddpca_admm.cli block    [--divi 2 --glob-leve 1 --doma 1 ...]
  python -m ddpca_admm.cli torsion  [--scale small|full]
  python -m ddpca_admm.cli beam     [--scale small|full]
  python -m ddpca_admm.cli cylinder [--scale small|full]
  python -m ddpca_admm.cli boxes    [--lagrange]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _solve_and_write(prob, meta, bodies, outdir: str, max_iter: int = 3000,
                     moni: bool = False, chunk: int | None = None):
    import jax
    import numpy as np

    from .admm.loop import contact_analysis
    from .utils import io as rio
    from .utils import timing

    t0 = time.time()
    # --moni stays on the fast path: the jitted loop accumulates every
    # iteration's monitor ratios in an on-device buffer (loop.py moni_hist)
    # DDPCA_PROFILE_DIR captures a jax.profiler trace of the whole solve
    with timing.trace():
        state = contact_analysis(
            prob, tuple(meta.group_modes), max_iter=max_iter,
            record_moni=moni, chunk=chunk
        )
        jax.block_until_ready(state.u)
    solve_s = time.time() - t0
    if moni:
        hist = np.asarray(state.moni_hist)[: int(state.it)]
        rio.write_moni(outdir, hist)

    os.makedirs(outdir, exist_ok=True)
    for b, (body, sysm) in enumerate(zip(bodies, meta.systems)):
        u = np.asarray(state.u[b])[: sysm.n_dof]
        full = sysm.full_displacement(u)
        rio.write_mesh(outdir, body.mesh, b)
        rio.write_displacement(outdir, full, b, body.node_rota)
        stre = rio.stress_recovery(
            body.mesh, full, body.e_mod, body.nu, body.node_rota
        )
        rio.write_stress(outdir, stre, b)
    for g_i, mode in enumerate(meta.group_modes):
        gs = state.groups[g_i]
        for slot, ri in enumerate(meta.group_region_idx[g_i]):
            ip = meta.regions[ri].region.ip
            ndof = ip.n if mode == "scalar" else 3 * ip.n
            gamma = np.asarray(gs.gamma[slot])[:ndof]
            rio.write_contact(outdir, gamma, ip.basis, mode == "scalar", ri)
            rio.write_integral_points(outdir, ip, ri)
            rio.write_segments(outdir, ip, ri)
            for side in (0, 1):
                mr = meta.regions[ri].sides[side]
                mdof = mr.inte_mass.shape[0]
                rio.write_aula(
                    outdir,
                    np.asarray(gs.z[slot, side])[:mdof],
                    np.asarray(gs.lam[slot, side])[:mdof],
                    mode == "scalar", ri, side,
                )
    return {
        "iterations": int(state.it),
        "converged": bool(state.converged),
        "inner_cg_iterations": int(state.inner_iters),
        "solve_seconds": round(solve_s, 3),
        "setup_phases": {t: round(s, 3) for t, s in timing.reset()},
        "outdir": outdir,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ddpca_admm")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("block", help="3-block contact patch test (BLOCK)")
    p.add_argument("--divi", type=int, default=2)
    p.add_argument("--glob-leve", type=int, default=1)
    p.add_argument("--doma", type=int, default=1)
    p.add_argument(
        "--coarse-solver", choices=["auto", "direct", "ddmg"], default="auto",
        help="coarse-correction solve: dense inverse or DOUBLE_M DD-multigrid"
             " (auto switches at 120k coarse DOF, PREP.h DIRE_MAXI)",
    )
    p.add_argument(
        "--cross-corner", action="store_true",
        help="BLOCK_1 variant: no guard slabs, subdomain corners on the "
             "contact interfaces (examples/BLOCK_1.h)",
    )
    p.add_argument(
        "--dole", type=int, default=None,
        help="doleMcsc coarse level (reference: 1, BLOCK.cpp:69-71; "
             "default 1 when glob_leve>=1 else 0)",
    )
    p.add_argument("--outdir", default="Block")

    p = sub.add_parser("torsion", help="hollow cylinder under torque (TORSION)")
    p.add_argument("--scale", choices=["small", "full"], default="small")
    p.add_argument("--outdir", default="Torsion")

    p = sub.add_parser("beam", help="pre-twisted tapered cantilever (BEAM)")
    p.add_argument("--scale", choices=["small", "full"], default="small")
    p.add_argument("--outdir", default="Beam")

    p = sub.add_parser("cylinder", help="Hertz contact of cylinders (CYLINDER)")
    p.add_argument("--scale", choices=["small", "full"], default="small")
    p.add_argument(
        "--stack4", action="store_true",
        help="full 4-section stack x mirror halves (CYLINDER.h:440-551)",
    )
    p.add_argument(
        "--copy-numb", type=int, default=1,
        help="axial copies replicated by COPY+RIGI_ROTR (CYLINDER.h:41; "
             "reference: 16)",
    )
    p.add_argument(
        "--cross-corner", action="store_true",
        help="CYLINDER_1 cross-corner variant (4 full sections per copy, "
             "fixed penalty 210e9*1000)",
    )
    p.add_argument("--outdir", default="Cylinder")

    p = sub.add_parser(
        "dehw", help="double-enveloping hourglass worm drive (DEHW, flagship)"
    )
    p.add_argument(
        "--self-locking", action="store_true",
        help="self-locking analysis with driving wheel: mu=0.2, distCrit "
             "{65,45,25} um (DEHW.cpp ISNO_SELO; DEHW.h:1619,2229-2234)",
    )
    p.add_argument(
        "--tape-coef", type=float, default=25.0,
        choices=[0.025, 0.25, 2.5, 25.0],
        help="tangential/normal penalty ratio menu (DEHW.h:6, "
             "DEHW.cpp:123-153)",
    )
    p.add_argument(
        "--full", action="store_true",
        help="reference-scale grid: worm_numb (4,2,2,4,4), whee_numb "
             "(4,4,2,4,8), globInho=1 globHomo=2 locaLeve=3 "
             "(DEHWSURF.h:185-196)",
    )
    p.add_argument(
        "--no-dd", action="store_true",
        help="menu 0: ADMM without DD (1 worm + 1 wheel domain)",
    )
    p.add_argument(
        "--cross-corner", action="store_true",
        help="DEHW_1 variant: wheel teeth split by face-width sections with "
             "full-width blocks — DD corners cross the contact zone "
             "(examples/DEHW_1.h:762-812)",
    )
    p.add_argument("--glob-inho", type=int, default=None)
    p.add_argument("--glob-homo", type=int, default=None)
    p.add_argument("--loca-leve", type=int, default=None)
    p.add_argument(
        "--apps", choices=["global", "coarse", "macro"], default=None,
        help="eigen analysis instead of contact solve (DEHW.cpp:110-121: "
             "1 = global problem, 2 = global coarse problem; macro = "
             "APPS_MPL on the variant-A coarse operator, "
             "MCONTACT.h:2405-2474); writes resuFreq.txt + per-body modes",
    )
    p.add_argument("--outdir", default="Dehw")

    p = sub.add_parser("boxes", help="two-box contact demo / LAGRANGE check")
    p.add_argument("--lagrange", action="store_true")
    p.add_argument(
        "--prec-type", type=int, choices=[1, 2], default=2,
        help="LAGRANGE preconditioner: 1=restricted-GMG, 2=Jacobi "
             "(reference precType menu)",
    )
    p.add_argument("--levels", type=int, default=0,
                   help="global refinement levels of the two boxes")
    p.add_argument("--outdir", default="Boxes")

    p = sub.add_parser(
        "postprocess",
        help="render result files to PNGs (Postprocess.m equivalent)",
    )
    p.add_argument("outdir", help="result directory written by a solve run")

    for sp in sub.choices.values():
        if sp.prog.endswith("postprocess"):
            continue
        sp.add_argument(
            "--moni", action="store_true",
            help="write resuMoni.txt per-iteration convergence monitors "
                 "(MCONTACT.h:2742)",
        )
        sp.add_argument(
            "--max-iter", type=int, default=3000,
            help="ADMM outer-iteration cap (MCONTACT.h:2502 maxiIter)",
        )
        sp.add_argument(
            "--chunk", type=int, default=None,
            help="dispatch the ADMM loop in chunks of N jitted single "
                 "iterations with a host convergence check per chunk "
                 "instead of one on-device while_loop (the default)",
        )

    args = ap.parse_args(argv)
    t0 = time.time()

    if args.cmd == "postprocess":
        from .utils.postprocess import postprocess

        paths = postprocess(args.outdir)
        print(json.dumps({"plots": paths}))
        return

    moni = getattr(args, "moni", False)

    if args.cmd == "block":
        from .admm.problem import build_problem
        from .models.block import BlockConfig, build_block_model

        cfg = BlockConfig(
            divi=(args.divi,) * 3,
            glob_leve=args.glob_leve,
            doma_numb=(args.doma,) * 3,
            guard_slabs=not args.cross_corner,
        )
        model = build_block_model(cfg)
        dole_lv = args.dole if args.dole is not None else (
            1 if args.glob_leve >= 1 else 0
        )
        prob, meta = build_problem(
            model.systems, model.regions,
            dole=[dole_lv] * len(model.systems),
            coarse_solver=args.coarse_solver,
        )
        summary = _solve_and_write(prob, meta, model.bodies, args.outdir,
                                   moni=moni, max_iter=args.max_iter,
                                   chunk=args.chunk)
    elif args.cmd == "torsion":
        from .models.torsion import TorsionConfig, build_torsion_model

        cfg = (
            TorsionConfig(divi=(1, 8, 2), doma=(1, 4, 2), glob_inho=1,
                          glob_homo=1)
            if args.scale == "small" else TorsionConfig()
        )
        prob, meta, bodies, cfg = build_torsion_model(cfg)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, moni=moni,
                                   max_iter=args.max_iter,
                                   chunk=args.chunk)
        summary["analytic_twist"] = cfg.analytic_twist
    elif args.cmd == "beam":
        from .models.beam import BeamConfig, build_beam_model

        cfg = (
            BeamConfig(divi=(8, 4, 2), doma=(4, 2, 1), glob_leve=1)
            if args.scale == "small" else BeamConfig()
        )
        prob, meta, bodies, cfg = build_beam_model(cfg)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, moni=moni,
                                   max_iter=args.max_iter,
                                   chunk=args.chunk)
    elif args.cmd == "cylinder":
        from .models.cylinder import CylinderConfig, build_cylinder_model

        cfg = (
            CylinderConfig(glob_inho=2, glob_homo=0, loca_leve=4,
                           divi=(2, 2, 1, 2), band_widt=8e-4)
            if args.scale == "small" else CylinderConfig()
        )
        if args.scale == "small" and (args.stack4 or args.cross_corner):
            cfg.loca_leve = 3
        cfg.stack4 = args.stack4
        cfg.copy_numb = args.copy_numb
        cfg.cross_corner = args.cross_corner
        prob, meta, bodies, cfg = build_cylinder_model(cfg)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, moni=moni,
                                   max_iter=args.max_iter,
                                   chunk=args.chunk)
        a, p_max = cfg.hertz
        summary["hertz_half_width"] = a
        summary["hertz_p_max"] = p_max
    elif args.cmd == "dehw":
        from .models.dehw_assembly import (
            DehwDDConfig,
            build_dehw_assembly,
            finalize_dehw_problem,
        )
        from .models.dehw_surf import DehwGrid

        if args.full:
            grid = DehwGrid()
        else:
            grid = DehwGrid(
                worm_numb=(2, 1, 1, 2, 2), whee_numb=(2, 2, 1, 2, 2),
                glob_inho=0, glob_homo=1, loca_leve=1,
            )
        for name in ("glob_inho", "glob_homo", "loca_leve"):
            v = getattr(args, name)
            if v is not None:
                setattr(grid, name, v)
        cfg = DehwDDConfig(
            grid=grid,
            drive="wheel" if args.self_locking else "worm",
            dode=not args.no_dd,
            tape_coef=args.tape_coef,
            cross_corner=args.cross_corner,
        )
        bodies, regions, info = build_dehw_assembly(cfg)
        if args.apps:
            # APPS eigen-analysis path (SOLVE appsCont <= 0,
            # DEHW.h:2261-2272): global problem uses the finest level as the
            # "coarse" space, coarse uses doleMcsc
            import numpy as np

            from .admm.eigen import (
                run_apps,
                run_apps_mpl,
                write_freq,
                write_modes,
            )
            from .models.simple import assemble_bodies

            systems = assemble_bodies(bodies, regions)
            if args.apps == "global":
                dole = [s.n_levels - 1 for s in systems]
            else:
                dole = [cfg.dole] * len(systems)
            if args.apps == "macro":
                res = run_apps_mpl(
                    systems, regions, [b.mesh for b in bodies], dole
                )
            else:
                res = run_apps(systems, regions, dole)
            write_freq(args.outdir, res.vals, res.corr)
            write_modes(args.outdir, res, bodies)
            summary = {
                "solver": "apps",
                "frequencies": [float(v) for v in res.vals],
                "correlations": [float(c) for c in res.corr],
                "outdir": args.outdir,
            }
            summary["total_seconds"] = round(time.time() - t0, 3)
            print(json.dumps(summary))
            return
        prob, meta = finalize_dehw_problem(bodies, regions, cfg)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, moni=moni,
                                   max_iter=args.max_iter,
                                   chunk=args.chunk)
        summary["self_locking"] = args.self_locking
        summary["tape_coef"] = args.tape_coef
        summary["n_worm"] = info["n_worm"]
        summary["n_whee"] = info["n_whee"]
        summary["n_contact_regions"] = sum(
            1 for k in info["region_kinds"] if k[0] == "contact"
        )
    elif args.cmd == "boxes":
        from .models.simple import stacked_boxes_problem

        prob, meta, bodies = stacked_boxes_problem(levels=args.levels)
        if args.lagrange:
            import numpy as np

            from .admm.lagrange import solve_lagrange
            from .models.simple import assemble_bodies
            from .utils import io as rio

            systems = assemble_bodies(bodies, meta.regions,
                                      include_penalty=False)
            res = solve_lagrange(systems, meta.regions,
                                 [b.mesh for b in bodies],
                                 prec_type=args.prec_type)
            os.makedirs(args.outdir, exist_ok=True)
            for b, (body, sysm) in enumerate(zip(bodies, systems)):
                full = sysm.full_displacement(res.u[b])
                rio.write_mesh(args.outdir, body.mesh, b)
                rio.write_displacement(args.outdir, full, b)
            for ri, r in enumerate(meta.regions):
                rio.write_lagrange(
                    args.outdir, res.lagr[ri], res.status[ri],
                    res.nm_nodes[ri], float(r.region.fric), ri,
                )
            summary = {
                "solver": "lagrange",
                "newton_iterations": res.iters,
                "outdir": args.outdir,
            }
        else:
            summary = _solve_and_write(prob, meta, bodies, args.outdir, moni=moni,
                                   max_iter=args.max_iter,
                                   chunk=args.chunk)

    summary["total_seconds"] = round(time.time() - t0, 3)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
