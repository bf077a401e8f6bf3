"""Sharding layer: row-partitioned sparse solver over a device mesh.

The reference is a serial C solver (SURVEY.md §2b "MPI": none in the main
path); distribution is a new first-class layer here
(BASELINE.md north star).  Design follows the XLA/GSPMD recipe: pick a
1-D mesh axis "p", annotate row-sharded layouts on every per-row array
(ELL planes, smoother slices, aggregate maps, vectors), keep coarse-grid
data replicated, and let XLA insert the collectives (all-gathers for SpMV
column footprints, psums for Krylov dot products).

Scaling model: the fine-grid rows (the memory+bandwidth hog) are split
across devices; coarse levels below `replicate_below` rows stay replicated
(redundant coarse solves — the standard small-coarse-grid strategy; coarse
agglomeration onto device subsets is the planned refinement).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse import ELL
from ..sparse.dia import DIA
from ..amg.hierarchy import MGLevel, MGPreconditioner
from ..amg.structured import BlockChebyshevSmoother, StructuredLevel
from ..amg.grid import GridLevel, ChebyshevDiagSmoother
from ..smoothers import (JacobiSmoother, L1JacobiSmoother,
                         ChebyshevSmoother, MulticolorGS, SchwarzSmoother,
                         MetricSmoother)


def init_multihost(coordinator_address, num_processes, process_id):
    """Multi-process bring-up: `jax.distributed.initialize` with an
    explicit coordinator (`"localhost:<port>"` on one host), then return
    the global device mesh.  After this, every process runs the SAME
    program over jax.devices() spanning all processes; the sharded
    solvers below are process-count agnostic."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return device_mesh()


def device_mesh(n_devices=None, devices=None):
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devices), ("p",))


def _put(x, mesh, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


def _put_best(x, mesh, spec):
    """device_put with `spec` if every sharded dim divides by the mesh,
    else replicate. (Grid-path arrays have (n+1)-derived sizes that rarely
    divide; padding the grid itself to mesh-divisible dims is the planned
    fix — see docs/ARCHITECTURE.md aux notes.)"""
    ndev = mesh.devices.size
    ok = all(x.shape[i] % ndev == 0
             for i, ax in enumerate(spec) if ax is not None)
    return _put(x, mesh, spec if ok else P())


def replicate(x, mesh):
    return jax.tree_util.tree_map(
        lambda a: _put(a, mesh, P()) if hasattr(a, "shape") else a, x)


def shard_ell(A: ELL, mesh) -> ELL:
    """Row-shard the ELL planes across the mesh axis."""
    return ELL(_put(A.cols, mesh, P("p", None)),
               _put(A.vals, mesh, P("p", None)), A.shape, A.nnz)


def shard_vector(v, mesh):
    return _put(v, mesh, P("p"))


def _pad_rows(a, mult, fill):
    """Pad leading dim to a multiple of mult with `fill`."""
    n = a.shape[0]
    n2 = ((n + mult - 1) // mult) * mult
    if n2 == n:
        return a
    pad = jnp.full((n2 - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype)
    return jnp.concatenate([a, pad], axis=0)


def _shard_smoother(sm, mesh, row_sharded, nrows=0):
    """Shard smoother state: per-row arrays follow the rows; color slices
    and Schwarz block batches are sharded on their own leading dim, padded
    to mesh divisibility with inert rows (ghost column targets and zero
    scaling, so padded updates add exactly 0)."""
    ndev = mesh.devices.size
    if isinstance(sm, (JacobiSmoother, L1JacobiSmoother)):
        invd = _put(sm.invd, mesh, P("p") if row_sharded else P())
        return type(sm)(invd, sm.omega)
    if isinstance(sm, ChebyshevSmoother):
        invd = _put(sm.invd, mesh, P("p") if row_sharded else P())
        return ChebyshevSmoother(invd, sm.lmax, sm.lmin, sm.degree)
    if isinstance(sm, MulticolorGS):
        spec_m = P("p", None) if row_sharded else P()
        spec_v = P("p") if row_sharded else P()
        rows, ids, invd = [], [], []
        for e, i, d in zip(sm.color_rows, sm.color_ids, sm.color_invd):
            if row_sharded:
                # pad: ghost-column matrix rows, ids -> row 0, invd -> 0
                e = ELL(_pad_rows(e.cols, ndev, e.shape[1]),
                        _pad_rows(e.vals, ndev, 0), e.shape, e.nnz)
                i = _pad_rows(i, ndev, 0)
                d = _pad_rows(d, ndev, 0)
            rows.append(ELL(_put(e.cols, mesh, spec_m),
                            _put(e.vals, mesh, spec_m), e.shape, e.nnz))
            ids.append(_put(i, mesh, spec_v))
            invd.append(_put(d, mesh, spec_v))
        return MulticolorGS(tuple(rows), tuple(ids), tuple(invd),
                            sm.omega, sm.symmetric)
    if isinstance(sm, SchwarzSmoother):
        spec_i = P("p", None) if row_sharded else P()
        spec_b = P("p", None, None) if row_sharded else P()
        ids, inv = [], []
        for i, v in zip(sm.dof_ids, sm.inv_blocks):
            if row_sharded:
                # ghost blocks: all dofs point at the x-pad slot (= nrows),
                # zero inverse -> contributes exactly nothing
                i = _pad_rows(i, ndev, nrows)
                v = _pad_rows(v, ndev, 0)
            ids.append(_put(i, mesh, spec_i))
            inv.append(_put(v, mesh, spec_b))
        return SchwarzSmoother(tuple(ids), tuple(inv), sm.symmetric,
                               sm.additive, sm.weight)
    if isinstance(sm, MetricSmoother):
        return MetricSmoother(
            _shard_smoother(sm.schwarz, mesh, row_sharded, nrows),
            _shard_smoother(sm.gs, mesh, row_sharded, nrows)
            if sm.gs is not None else None)
    return sm


def shard_dia(A: DIA, mesh, row_sharded=True) -> DIA:
    """Shard a DIA operator: diagonal-value planes split along rows."""
    spec = P(None, "p") if row_sharded else P()
    return DIA(A.offsets, _put_best(A.data, mesh, spec), A.shape, A.nnz)


def _shard_grid_level(L, mesh, row_sharded):
    """Shard GridLevel/StructuredLevel state. Row-dim shardings may be
    repartitioned by XLA around the reshape transfers (non-divisible grid
    dims); semantics are unchanged."""
    spec_v = P("p") if row_sharded else P()
    A = shard_dia(L.A, mesh, row_sharded)
    mask = _put_best(L.mask, mesh, spec_v)
    sm = L.smoother
    if isinstance(sm, BlockChebyshevSmoother):
        sm = BlockChebyshevSmoother(
            _put_best(sm.blockinv, mesh,
                      P("p", None, None) if row_sharded else P()),
            _put_best(sm.mask, mesh, spec_v), sm.lmax, sm.lmin, sm.degree)
    elif isinstance(sm, ChebyshevDiagSmoother):
        sm = ChebyshevDiagSmoother(
            _put_best(sm.invd, mesh, spec_v),
            _put_best(sm.mask, mesh, spec_v),
            sm.lmax, sm.lmin, sm.degree)
    if isinstance(L, GridLevel):
        return GridLevel(A, sm, mask, L.dims, L.F)
    return StructuredLevel(A, sm, mask, L.s, L.n_groups, L.nc)


def shard_preconditioner(prec: MGPreconditioner, mesh,
                         replicate_below=4096) -> MGPreconditioner:
    """Row-shard fine levels; replicate levels below the size threshold
    (and the coarse dense inverse). Handles the algebraic (ELL/MGLevel)
    hierarchy and the structured DIA hierarchies (GridLevel /
    StructuredLevel)."""
    levels = []
    for L in prec.levels:
        if isinstance(L, (GridLevel, StructuredLevel)):
            levels.append(_shard_grid_level(
                L, mesh, L.A.shape[0] >= replicate_below))
            continue
        row_sharded = L.A.shape[0] >= replicate_below
        spec_m = P("p", None) if row_sharded else P()
        spec_v = P("p") if row_sharded else P()
        A = ELL(_put(L.A.cols, mesh, spec_m),
                _put(L.A.vals, mesh, spec_m), L.A.shape, L.A.nnz)
        agg = _put(L.agg, mesh, spec_v) if L.agg is not None else None
        Pm = ELL(_put(L.P.cols, mesh, spec_m),
                 _put(L.P.vals, mesh, spec_m), L.P.shape, L.P.nnz) \
            if L.P is not None else None
        Rm = ELL(_put(L.R.cols, mesh, spec_m),
                 _put(L.R.vals, mesh, spec_m), L.R.shape, L.R.nnz) \
            if L.R is not None else None
        sm = _shard_smoother(L.smoother, mesh, row_sharded,
                             nrows=L.A.shape[0])
        levels.append(MGLevel(A, sm, agg=agg, P=Pm, R=Rm, nc=L.nc))
    coarse_inv = _put(prec.coarse_inv, mesh, P())
    return MGPreconditioner(levels, coarse_inv, cycle=prec.cycle,
                            maxit=prec.maxit, presmooth=prec.presmooth,
                            postsmooth=prec.postsmooth,
                            amli_degree=prec.amli_degree,
                            max_w_work=prec.max_w_work,
                            coarse_scaling=prec.coarse_scaling)


# ---------------------------------------------------------------------------
# Coarse agglomeration onto device subsets (SURVEY.md §5.7/§5.8 north star;
# round-1 backlog).  A 2-D mesh ("po", "pi") expresses three residency
# tiers per level:
#   n >= shard_below      -> P(("po","pi")): rows over ALL devices,
#   agglomerate window    -> P("po"):        rows over the po groups only —
#                            each row lives on |pi| devices (replicated
#                            within the group): the coarse problem has been
#                            agglomerated onto a device subset, so its
#                            smaller collectives ride the group's links,
#   below replicate_below -> P():            fully replicated (redundant
#                            compute, zero comms — the standard endgame).
# GSPMD inserts the re-sharding collectives at the level transfers.
# ---------------------------------------------------------------------------

def device_mesh2d(outer=None, inner=None, devices=None):
    """2-D ("po", "pi") mesh for agglomerated hierarchies."""
    if devices is None:
        devices = jax.devices()
    ndev = len(devices)
    if outer is None:
        outer = max(1, ndev // (inner or 2))
    if inner is None:
        inner = ndev // outer
    assert outer * inner <= ndev
    arr = np.array(devices[:outer * inner]).reshape(outer, inner)
    return Mesh(arr, ("po", "pi"))


def _spec_axis_size(mesh, ax):
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in ax]))
    return int(mesh.shape[ax])


def _put_spec(x, mesh, spec):
    """device_put with spec if every sharded dim divides, else replicate."""
    ok = all(x.shape[i] % _spec_axis_size(mesh, ax) == 0
             for i, ax in enumerate(spec))
    return _put(x, mesh, spec if ok else P())


def _shard_grid_level_axes(L, mesh, row_ax):
    """GridLevel/StructuredLevel with rows sharded over `row_ax`
    (None / "po" / ("po","pi"))."""
    spec_v = P(row_ax) if row_ax is not None else P()
    spec_d = P(None, row_ax) if row_ax is not None else P()
    A = DIA(L.A.offsets, _put_spec(L.A.data, mesh, spec_d), L.A.shape,
            L.A.nnz)
    mask = _put_spec(L.mask, mesh, spec_v)
    sm = L.smoother
    if isinstance(sm, BlockChebyshevSmoother):
        sm = BlockChebyshevSmoother(
            _put_spec(sm.blockinv, mesh,
                      P(row_ax, None, None) if row_ax is not None
                      else P()),
            _put_spec(sm.mask, mesh, spec_v), sm.lmax, sm.lmin, sm.degree)
    elif isinstance(sm, ChebyshevDiagSmoother):
        sm = ChebyshevDiagSmoother(
            _put_spec(sm.invd, mesh, spec_v),
            _put_spec(sm.mask, mesh, spec_v), sm.lmax, sm.lmin, sm.degree)
    if isinstance(L, GridLevel):
        return GridLevel(A, sm, mask, L.dims, L.F)
    return StructuredLevel(A, sm, mask, L.s, L.n_groups, L.nc)


def shard_preconditioner_agglomerated(prec: MGPreconditioner, mesh,
                                      agglomerate_below=65536,
                                      replicate_below=4096):
    """Three-tier residency over a 2-D ("po","pi") mesh (see module note).

    Grid/Structured (DIA) hierarchies only."""
    assert tuple(mesh.axis_names) == ("po", "pi"), mesh.axis_names
    levels = []
    for L in prec.levels:
        n = L.A.shape[0]
        if n >= agglomerate_below:
            row_ax = ("po", "pi")
        elif n >= replicate_below:
            row_ax = "po"
        else:
            row_ax = None
        levels.append(_shard_grid_level_axes(L, mesh, row_ax))
    coarse_inv = _put(prec.coarse_inv, mesh, P())
    return MGPreconditioner(levels, coarse_inv, cycle=prec.cycle,
                            maxit=prec.maxit, presmooth=prec.presmooth,
                            postsmooth=prec.postsmooth,
                            amli_degree=prec.amli_degree,
                            max_w_work=prec.max_w_work,
                            coarse_scaling=prec.coarse_scaling)
