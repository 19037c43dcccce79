"""Stage-0 probe for the 8.8M-DOF BLOCK run: build the full-scale problem
HOST-SIDE ONLY (JAX_PLATFORMS=cpu) and report where every byte goes.

Two outputs:
  * artifacts/cache/block_leve{L}_model.pkl — the host model (systems +
    regions) after the expensive mesh/assembly stage, so repeat probes
    skip the ~44-minute setup.
  * artifacts/probe_full_breakdown.json — bytes per pytree path, sorted,
    so device-memory cuts target the real hogs instead of the guessed ones.

Run:  JAX_PLATFORMS=cpu python scripts/probe_full.py [glob_leve]
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    glob_leve = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    cache_dir = os.path.join(REPO, "artifacts", "cache")
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"block_leve{glob_leve}_model.pkl")

    t0 = time.perf_counter()
    if os.path.exists(cache):
        print(f"[probe] loading cached model {cache}", flush=True)
        with open(cache, "rb") as f:
            systems, regions = pickle.load(f)
    else:
        from ddpca_admm.models.block import BlockConfig, build_block_model

        cfg = BlockConfig(divi=(6, 6, 6), glob_leve=glob_leve,
                          doma_numb=(2, 2, 2))
        model = build_block_model(cfg)
        systems, regions = model.systems, model.regions
        with open(cache, "wb") as f:
            pickle.dump((systems, regions), f, protocol=5)
        print(f"[probe] model built+cached in {time.perf_counter()-t0:.0f}s",
              flush=True)

    from ddpca_admm.admm.problem import build_problem

    t1 = time.perf_counter()
    prob, meta = build_problem(
        systems, regions, dole=[1] * len(systems), musc_sett=2
    )
    print(f"[probe] build_problem {time.perf_counter()-t1:.0f}s", flush=True)

    import jax

    sizes: dict[str, int] = {}
    seen: set[int] = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(prob)[0]:
        if not hasattr(leaf, "nbytes") or id(leaf) in seen:
            continue
        seen.add(id(leaf))
        key = jax.tree_util.keystr(path)
        sizes[key] = int(leaf.nbytes)
    total = sum(sizes.values())
    out = {
        "glob_leve": glob_leve,
        "total_gb": round(total / 1e9, 3),
        "fields": {
            k: round(v / 1e6, 2)
            for k, v in sorted(sizes.items(), key=lambda kv: -kv[1])
        },
    }
    path = os.path.join(REPO, "artifacts", "probe_full_breakdown.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"total_gb": out["total_gb"], "n_fields": len(sizes),
                      "wrote": path}), flush=True)
    top = list(out["fields"].items())[:25]
    for k, mb in top:
        print(f"{mb:10.1f} MB  {k}", flush=True)


if __name__ == "__main__":
    main()
