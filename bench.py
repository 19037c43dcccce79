"""Benchmark: ADMM iterations/second on the reference's own BLOCK problem.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...phases}.
Runs on a GPU only: with any other JAX backend it exits non-zero and prints
no result.

Problem: the reference BLOCK menu-1 configuration — 3 stacked blocks, divi
6^3 per block, 2^3 core subdomains + 2 guard slabs per block (30 bodies),
perfect interfaces + 2 frictionless contact planes, MULTISCALE_1 coarse
correction with doleMcsc=1 (examples/BLOCK.cpp:65-83, BLOCK.h:33-54) — at a
refinement level selected by DDPCA_BENCH_SIZE:

  small  -> glob_leve 1 (default: fits the driver budget)
  medium -> glob_leve 2 (matches the patched-reference leve2 measurement)
  full   -> glob_leve 4 (the reference's exact compiled-in scale, 8.8M DOF)

Structure (one compile-and-converge run, then ONE warm fresh-state
convergence run that is the measurement):

  setup_s    host geometry/assembly/problem build
  compile_s  first contact_analysis call: jit compile + first convergence
  solve_s    second contact_analysis from a FRESH zero state, warm compile
  it         ADMM iterations to converge in the measured run — the step
             no-ops once converged (admm/loop.py), so this equals the
             reference's iterNumbReco (MCONTACT.h:2714) cadence exactly
  value      it / solve_s

``vs_baseline`` divides by the *measured* C++ reference throughput on the
identical problem (same geometry, domains, tolerances), recorded in
``baseline_measured.json`` by scripts/measure_reference.sh runs of the
compiled reference (g++ -O3 -fopenmp, makefile:11) on this host.  If the
matching measurement is absent the field is null — never a stand-in number.

On SIGTERM/SIGALRM (driver timeout / DDPCA_BENCH_BUDGET seconds) a PARTIAL
JSON line with every phase completed so far is printed instead of dying
silently.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

BASELINE_FILE = os.path.join(os.path.dirname(__file__), "baseline_measured.json")
SIZE_LEVE = {"small": 1, "medium": 2, "full": 4}

RESULT: dict = {"metric": "admm_iterations_per_second", "value": None,
                "unit": "iter/s", "vs_baseline": None, "phase": "start"}


def emit() -> None:
    print(json.dumps(RESULT), flush=True)


def _bail(signum, frame):
    RESULT["interrupted_by"] = signal.Signals(signum).name
    emit()
    os._exit(0)


def build(glob_leve: int):
    """(device problem, meta, host model) of BLOCK menu 1 at ``glob_leve``,
    built from source (the leve-4 host build takes about 44 minutes)."""
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.block import BlockConfig, build_block_model

    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=glob_leve, doma_numb=(2, 2, 2))
    model = build_block_model(cfg)
    prob, meta = build_problem(
        model.systems, model.regions,
        dole=[1] * len(model.systems),   # doleMcsc=1, BLOCK.cpp:69-71
        musc_sett=2,                     # muscSett=(1<<1), BLOCK.h:38
    )
    return prob, meta, model


def main() -> None:
    signal.signal(signal.SIGTERM, _bail)
    signal.signal(signal.SIGINT, _bail)
    budget = int(os.environ.get("DDPCA_BENCH_BUDGET", "0"))
    if budget:
        signal.signal(signal.SIGALRM, _bail)
        signal.alarm(budget)

    size = os.environ.get("DDPCA_BENCH_SIZE", "small")
    glob_leve = SIZE_LEVE[size]
    key = f"block_divi6_leve{glob_leve}_doma2"
    RESULT["metric"] = f"admm_iterations_per_second_{key}"
    RESULT["size"] = size
    # 0 = the on-device while_loop; N = N jitted single-iteration
    # dispatches per host convergence check (admm/loop.py)
    chunk = int(os.environ.get("DDPCA_BENCH_CHUNK", "0")) or None

    import jax

    from ddpca_admm.admm.loop import contact_analysis
    from ddpca_admm.utils.device import device_info, nvidia_smi, require_gpu

    require_gpu()
    RESULT["device"] = device_info()
    RESULT["nvidia_smi"] = nvidia_smi()

    RESULT["phase"] = "setup"
    t0 = time.perf_counter()
    prob, meta, _ = build(glob_leve)
    RESULT["setup_s"] = round(time.perf_counter() - t0, 2)
    seen: set = set()
    RESULT["problem_gb"] = round(
        sum(
            (seen.add(id(x)) or x.nbytes)
            for x in jax.tree_util.tree_leaves(prob)
            if hasattr(x, "nbytes") and id(x) not in seen
        )
        / 1e9,
        2,
    )
    modes = tuple(meta.group_modes)

    # run 1: jit compile + first convergence
    RESULT["phase"] = "compile"
    t0 = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=3000, chunk=chunk)
    jax.block_until_ready(st.u)
    RESULT["compile_s"] = round(time.perf_counter() - t0, 2)
    RESULT["it_run1"] = int(st.it)
    RESULT["converged_run1"] = bool(st.converged)

    # run 2 (the measurement): fresh zero state, warm executable — a full
    # convergence history, not a degenerate converged-state step timing
    RESULT["phase"] = "solve"
    t0 = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=3000, chunk=chunk)
    jax.block_until_ready(st.u)
    dt = time.perf_counter() - t0
    it = int(st.it)
    RESULT["solve_s"] = round(dt, 2)
    RESULT["it"] = it
    RESULT["converged"] = bool(st.converged)
    RESULT["inner_cg_iterations"] = int(st.inner_iters)
    RESULT["phase"] = "done"
    if not bool(st.converged):
        # still report throughput of the non-converged run, flagged as such
        RESULT["warning"] = "did not converge within 3000 iterations"
    RESULT["value"] = round(it / dt, 3)

    try:
        with open(BASELINE_FILE) as f:
            ref = json.load(f).get(key)
        if ref and ref.get("it_per_s"):
            RESULT["vs_baseline"] = round(RESULT["value"] / ref["it_per_s"], 3)
            RESULT["baseline_it"] = ref.get("admm_iterations")
            # wall-clock honesty: it/s can flatter a run that needs more
            # iterations than the reference; report the time-to-solution
            # ratio alongside (>1 = faster than the reference end to end)
            bt = ref["admm_iterations"] / ref["it_per_s"]
            RESULT["time_to_solution_s"] = RESULT["solve_s"]
            RESULT["baseline_time_s"] = round(bt, 3)
            RESULT["vs_baseline_time"] = round(bt / max(dt, 1e-9), 3)
    except (OSError, ValueError):
        pass
    emit()


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # never die silently: the partial JSON is the
        RESULT["error"] = f"{type(e).__name__}: {e}"     # diagnostic artifact
        emit()
        sys.exit(1)
