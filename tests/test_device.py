"""Compile-cache placement and the GPU-only entry points, on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_update, cwd=ROOT):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_placement(preset, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits in
    the checkout's .jax_cache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if preset else {}
    r = _run(["-c", "import ddpca_admm, jax; "
                    "print(jax.config.jax_compilation_cache_dir)"],
             env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if preset else os.path.join(ROOT, ".jax_cache")
    assert r.stdout.strip() == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    """No quiet CPU fallback: a non-GPU backend exits non-zero and prints
    no result."""
    r = _run([os.path.join(ROOT, script)], {})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "needs a GPU" in r.stderr


@pytest.mark.parametrize("fmt", ["ell", "bell"])
def test_smoke_operator_check(fmt, monkeypatch):
    """The smoke's operator phase on a small BLOCK problem: every format's
    scipy image reproduces its SpMV (PlaneDia forced on the finest level,
    ELL or Block-ELL on the interface operators)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    import ddpca_admm.solvers.mg as mgmod
    from ddpca_admm.admm.problem import build_problem
    from ddpca_admm.models.block import BlockConfig, build_block_model

    monkeypatch.setenv("DDPCA_SPARSE_FORMAT", fmt)
    monkeypatch.setattr(mgmod, "DIA_LATENCY_BYTES", 0)
    model = build_block_model(
        BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1)))
    prob, _ = build_problem(model.systems, model.regions,
                            dole=[0] * len(model.systems))
    checked = chip_smoke.check_operators(prob)["checked"]
    formats = {c["format"] for c in checked}
    assert "PlaneDia" in formats
    assert ("BlockEll" if fmt == "bell" else "Ell") in formats
    assert all(c["rel_err"] <= chip_smoke.TOL[np.dtype(c["dtype"])]
               for c in checked)
