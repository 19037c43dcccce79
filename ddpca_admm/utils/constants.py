"""Solver thresholds and tolerances.

Mirrors the semantics of the reference constants (PREP.h:62-77) so that
solver-selection behavior and convergence criteria are comparable, while the
*mechanisms* differ (no sparse LDLT on the device: the "direct" path maps to
a dense Cholesky for small padded systems, the iterative path to batched
MG-PCG).
"""

# Maximum number of subdomains / interfaces (PREP.h:64-66).  Here
# these are soft limits used only for sanity checks — arrays are sized to the
# actual problem.
MAXI_DOMA_NUMB = 1000
MAXI_INTE_NUMB = 1000

# DOF thresholds selecting direct vs iterative solves (PREP.h:69-73).
DIRE_MAXI = 120_000        # macroscopic / interface problems
DIRE_MAXI_SUBD = 50_000    # subdomain problems
# Dense-inverse cutoff for the coarse-space correction solve.  The
# reference's DIRE_MAXI assumes a *sparse* LDLT (PREP.h:69); our device
# stand-in is a padded dense inverse (O(N^2) memory, O(N^3) host setup), so
# the automatic dispatch flips to the DOUBLE_M DD-multigrid path much
# earlier.  8192: an 8k^2 f32 inverse is 268 MB of device memory and
# ~30 s of host LAPACK — worth it, because a V-cycle whose coarsest solve
# is exact (one matmul) instead of a Chebyshev sweep cuts the latency-bound
# coarse-correction CG of each ADMM step (BLOCK leve 1: the coarse DD-MG's
# own coarsest level is 6400 dofs, which a 6144 cap would just miss).  Not
# re-measured on the GPU.
DENSE_COARSE_MAXI = 8_192
COGR_MAXI = 100_000        # plain-CG fallback (rarely reached)

# Dense-solve cutoff: below this row count a padded dense Cholesky beats
# iterating.  (No reference analogue.)
DENSE_MAXI = 4096

# Krylov tolerances (MGPIS.h:135,175,250,363).
CG_RTOL = 1.0e-14
GMRES_RTOL = 1.0e-12
BICGSTAB_RTOL = 1.0e-14
GMRES_RESTART = 10

# ADMM convergence criteria (MCONTACT.h:2732-2734).
ADMM_MAX_ITER = 3000
ADMM_MONI_CYCLE = 10
ADMM_CRIT_OSCI = 0.1       # oscillation/median ratio freezing coarse correction
ADMM_CRIT_DISP = 1.0e-12   # ||du||^2 <= crit * ||u||^2
ADMM_CRIT_LAGR = 1.0e-10   # tracked but non-gating (MCONTACT.h:2825-2831)

# Coordinate dedup tolerance (PREP.h:180-185 COOR::operator<).
COOR_TOL = 1.0e-10
