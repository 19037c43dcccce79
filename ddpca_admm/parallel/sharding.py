"""Multi-chip sharding of the ADMM problem over a ``domain`` device mesh.

The reference parallelizes the ADMM x-update with OpenMP over subdomains
(MCONTACT.h:2511-2538) in shared memory.  The equivalent here: the
batched body axis (B) of every solver array is sharded over the mesh axis
``domain`` — each GPU owns a slice of subdomains and runs their multigrid
V-cycles locally; the interface consensus (z/lambda updates need the
neighbor body's trace B_p^T u, MCONTACT.h:2629-2704) crosses GPUs, which
XLA lowers to all-gather/reduce-scatter collectives (NCCL over NVLink) from
the sharding constraints alone (GSPMD).  The coarse-space correction and all
region-group operators are replicated: a contact region couples two bodies
that may live on different chips, and the coarse problem couples all bodies
(small by construction — mirroring the reference's sequential coarse solve).

Placement is by *field*, not by shape: every AdmmProblem/AdmmState field is
named below as either body-batched (leading axis B -> P('domain')) or
replicated.  A shape heuristic would silently mis-shard region-group arrays
whose leading axis R (regions) happens to equal B.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..admm.loop import AdmmState
from ..admm.problem import AdmmProblem

# AdmmProblem fields whose every array leaf is batched over bodies (axis 0=B).
# The multigrid hierarchy ("mg") is NOT here: its containers need type-aware
# placement (PlaneDia class tables are shared, not body-batched) — see
# _place_mg_op in shard_problem.
_PROBLEM_DOMAIN_FIELDS = frozenset(
    {"cons_forc", "gram", "gram_lin", "gram_const", "u_mask"}
)
# AdmmProblem fields replicated on every device.
_PROBLEM_REPLICATED_FIELDS = frozenset({"groups", "coarse"})
# AdmmState: only u is body-batched; z/lambda/gamma lead with R (regions),
# monitors and scalars are global.
_STATE_DOMAIN_FIELDS = frozenset({"u"})
_STATE_REPLICATED_FIELDS = frozenset(
    {"groups", "it", "converged", "moni", "mult_frozen", "inner_iters",
     "coarse_x", "moni_hist"}
)


def domain_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=("domain",))


def host_domain_mesh(n_hosts: int, n_per_host: int | None = None) -> Mesh:
    """2-axis ``(host, domain)`` mesh: the outer axis maps to hosts, the
    inner to GPUs within a host.  Bodies are sharded over BOTH axes (B split
    across all devices); everything replicated (region groups, coarse
    correction) is computed redundantly per device, so the coarse solve
    itself generates NO cross-device traffic — only the coarse residual
    gather ``tranD.mv(u)`` reduces over the body axis, which XLA stages as
    a reduce-scatter within the inner axis followed by a small all-reduce
    over the outer one (NCCL; SURVEY §5: 'coarse-space residual gather +
    replicated coarse solve across hosts').  Within one host every GPU
    reaches every other over NVLink at the same rate, so the axis split is
    the algorithm's, not the wiring's."""
    devs = jax.devices()
    n_per_host = n_per_host or len(devs) // n_hosts
    n = n_hosts * n_per_host
    return Mesh(
        np.array(devs[:n]).reshape(n_hosts, n_per_host),
        axis_names=("host", "domain"),
    )


def _check_divisible(B: int, mesh: Mesh) -> None:
    n_dev = mesh.devices.size
    if B % n_dev != 0:
        raise ValueError(
            f"body count B={B} is not divisible by the {n_dev}-device "
            f"{'x'.join(map(str, mesh.devices.shape))} mesh "
            f"{mesh.axis_names}: every chip must own the same number of "
            f"subdomains (SPMD).  Pad the body list (add empty bodies) or "
            f"use a mesh size dividing {B}."
        )


def _place_fields(tree, field_names, domain_fields, replicated_fields, mesh,
                  passthrough=frozenset()):
    """device_put every array leaf by its top-level field membership.  On a
    multi-axis mesh the body axis is sharded over ALL mesh axes (flattened
    host x domain placement)."""
    sharded = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    replicated = NamedSharding(mesh, P())

    def put(sub, sh):
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sh) if hasattr(x, "shape") else x,
            sub,
        )

    parts = {}
    for name in field_names:
        sub = getattr(tree, name)
        if name in passthrough:
            parts[name] = sub        # placed by a dedicated pass
        elif name in domain_fields:
            parts[name] = put(sub, sharded)
        elif name in replicated_fields:
            parts[name] = put(sub, replicated)
        else:  # pragma: no cover - new field added without a placement
            raise KeyError(
                f"field {name!r} has no sharding placement; add it to the "
                "field tables in parallel/sharding.py"
            )
    return type(tree)(**parts)


def _place_mg_op(op, mesh, sharded, replicated):
    """Type-aware placement for hierarchy operator containers.

    * Ell / Dia / plain arrays lead with the body axis -> shard over
      'domain' (each GPU owns its bodies' operator rows; SpMV is local).
    * PlaneDia: the (C, D, P) class-slab table is SHARED by construction
      (plane dedup, sparse/dia.py) and small -> replicate it; the per-body
      class ids (B, nz) shard with the bodies when the mesh divides B.  The
      mv then runs with zero communication: a per-device row gather from
      the local table copy against locally owned kz/x rows.
    * BatchBlocks (heterogeneous body-shape groups): each group's op covers
      a body SLICE [a, b) that generally does not align with shard
      boundaries, so its leaves are replicated wholesale and GSPMD keeps the
      solve sharded through the elementwise/gather ops against the
      replicated operands (u's sharding is asserted post-step by
      assert_state_sharding).  After plane dedup the replicated bytes are
      the small class tables, not the O(B*n) value arrays.
    """
    from ..solvers.mg import BatchBlocks, StructuredProl, StructuredRest
    from ..sparse.dia import Dia, PlaneDia

    def put(x, sh):
        return jax.device_put(x, sh) if hasattr(x, "shape") else x

    if op is None:
        return None
    if isinstance(op, BatchBlocks):
        if len(op.ops) == 1:
            return BatchBlocks(
                (_place_mg_op(op.ops[0], mesh, sharded, replicated),),
                op.bounds,
            )
        return jax.tree_util.tree_map(lambda x: put(x, replicated), op)
    if isinstance(op, (StructuredProl, StructuredRest)):
        inner = op.S if isinstance(op, StructuredProl) else op.St
        placed = _place_mg_op(inner, mesh, sharded, replicated)
        args = (placed, op.fshape, op.cshape, op.strides, op.n_c_pad)
        return type(op)(*args)
    if isinstance(op, PlaneDia):
        n_dev = mesh.devices.size
        kz = (
            jax.device_put(op.kz, sharded)
            if op.kz.shape[0] % n_dev == 0
            else jax.device_put(op.kz, replicated)
        )
        return PlaneDia(
            jax.device_put(op.vals, replicated), kz, op.offsets,
            op.n_rows, op.plane, op.tail_identity,
        )
    if isinstance(op, Dia):
        return Dia(
            jax.device_put(op.vals, sharded), op.offsets, op.n_rows,
            op.tail_identity,
        )
    # Ell / arrays / anything body-batched
    return jax.tree_util.tree_map(lambda x: put(x, sharded), op)


def shard_problem(prob: AdmmProblem, mesh: Mesh) -> AdmmProblem:
    """Place every problem field per the placement tables above."""
    _check_divisible(prob.cons_forc.shape[0], mesh)
    from ..solvers.mg import MgHierarchy, MgLevel

    placed = _place_fields(
        prob, AdmmProblem._fields, _PROBLEM_DOMAIN_FIELDS,
        _PROBLEM_REPLICATED_FIELDS, mesh, passthrough=frozenset({"mg"}),
    )
    # re-place the hierarchy with the type-aware rules (the blanket pass
    # above would shard PlaneDia class tables over their CLASS axis)
    sharded = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    replicated = NamedSharding(mesh, P())
    levels = tuple(
        MgLevel(
            A=_place_mg_op(lv.A, mesh, sharded, replicated),
            inv_diag=jax.device_put(lv.inv_diag, sharded),
            lmax=jax.device_put(lv.lmax, sharded),
            P=_place_mg_op(lv.P, mesh, sharded, replicated),
            Pt=_place_mg_op(lv.Pt, mesh, sharded, replicated),
        )
        for lv in prob.mg.levels
    )
    mg = MgHierarchy(
        levels=levels,
        coarse_inv=(
            None
            if prob.mg.coarse_inv is None
            else jax.device_put(prob.mg.coarse_inv, sharded)
        ),
        # A_top aliases the finest-level A when dtypes match (solvers/mg.py)
        # — keep the alias so the largest operator is not placed twice
        A_top=(
            levels[-1].A
            if prob.mg.A_top is prob.mg.levels[-1].A
            else _place_mg_op(prob.mg.A_top, mesh, sharded, replicated)
        ),
    )
    return placed._replace(mg=mg)


def shard_state(state: AdmmState, prob: AdmmProblem, mesh: Mesh) -> AdmmState:
    _check_divisible(prob.cons_forc.shape[0], mesh)
    return _place_fields(
        state, AdmmState._fields, _STATE_DOMAIN_FIELDS,
        _STATE_REPLICATED_FIELDS, mesh,
    )


def assert_state_sharding(state: AdmmState, mesh: Mesh) -> None:
    """Verify the post-step state keeps the designed placement of the big
    loop-carried array: u stays sharded over 'domain' (anything else means
    every ADMM iteration pays an all-to-all reshard of all body DOFs).
    Group-state leaves (z/lambda/gamma, small) are left to GSPMD — it may
    pick a partial placement for them, which is fine as long as it is
    consistent across iterations (guaranteed inside the jitted while_loop)."""
    u_sh = state.u.sharding
    expect = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    if not u_sh.is_equivalent_to(expect, state.u.ndim):
        raise AssertionError(f"state.u resharded: {u_sh} != {expect}")
