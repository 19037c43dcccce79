"""ddpca_admm — Domain-Decomposition Parallel Contact Analysis by ADMM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++/OpenMP code QuanchengP/DDPCA-ADMM (3-D linear-elastic multibody frictional
contact on adaptively refined octree hex meshes, solved by an ADMM domain
decomposition with geometric-multigrid preconditioned Krylov subdomain solvers,
plus a dual-mortar monolithic comparison solver).

Architecture:
  * setup phase  — host NumPy/SciPy float64: meshing, octree refinement,
    contact search / mortar clipping, operator assembly.  Output: frozen,
    padded arrays (static shapes for XLA).
  * solve phase  — pure JAX, jitted: batched per-subdomain multigrid-
    preconditioned Krylov (Chebyshev smoother instead of the reference's
    row-sequential symmetric Gauss-Seidel, which cannot vectorize), ADMM
    consensus loop as ``lax.while_loop``, interface collectives via
    sharding over a device mesh.

Contact analysis needs 1e-12-scale tolerances (reference MCONTACT.h:2733),
so float64 is enabled globally; only the multigrid preconditioner runs in
f32 (utils/precision.py).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)
# Full-precision matmuls everywhere: on the GPU an f32 product may otherwise
# run in TF32 (about three decimal digits), which would break the f32
# V-cycle's smoothing and coarse-inverse applies.  All einsum/matmul in this
# package are solver algebra (SpMV tiles, coarse inverse applies, element
# stiffness); none tolerates a truncated mantissa.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compile cache: where JAX_COMPILATION_CACHE_DIR says (JAX reads
# the variable itself), else a fixed directory in the checkout, so repeat
# runs of the same problem skip the XLA compile.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(_repo, ".jax_cache"))

__version__ = "0.1.0"
