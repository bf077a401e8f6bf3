"""Distributed solve entry points.

``distributed_solve``: host AMG setup -> shard hierarchy + operator over
the mesh -> one jitted PCG program whose SpMVs, smoother sweeps and dot
products run SPMD with XLA-inserted collectives (all_gather on the sharded
row gathers, psum on reductions).

``distributed_pcg_step``: a single sharded operator+preconditioner+CG-step
application — the "training step" analog used by the multi-chip dry run
(__graft_entry__.dryrun_multichip).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR, ELL, matvec_op
from ..amg import setup_amg, as_operator
from ..config import AMGParameters
from ..krylov import pcg
from .sharding import (device_mesh, shard_ell, shard_vector,
                       shard_preconditioner)


def _pad_problem(A_host, b, ndev):
    from ..sparse.host import pad_csr_identity
    n = A_host.shape[0]
    A2 = pad_csr_identity(A_host, ndev)
    b2 = np.zeros(A2.shape[0], dtype=np.float64)
    b2[:n] = np.asarray(b)
    return A2, b2, n


def distributed_solve(A_host: HostCSR, b, params: AMGParameters = None,
                      idofs=None, mesh=None, tol=1e-8, maxiter=500,
                      dtype=jnp.float32):
    """Full distributed PCG solve; returns (CGResult with x trimmed to the
    original size, mesh)."""
    if mesh is None:
        mesh = device_mesh()
    ndev = mesh.devices.size
    if params is None:
        params = AMGParameters(aggregation_type="hem", cycle_type="v",
                               dtype=np.dtype(dtype).name)
    A2, b2, n = _pad_problem(A_host, b, ndev)
    prec = setup_amg(A2, params, idofs=idofs, pad_multiple=ndev)
    prec = shard_preconditioner(prec, mesh)
    Ae = shard_ell(ELL.from_host(A2, dtype=dtype), mesh)
    bj = shard_vector(jnp.asarray(b2, dtype=dtype), mesh)
    res = pcg(matvec_op(Ae), bj, M=as_operator(prec), tol=tol,
              maxiter=maxiter)
    res.x = np.asarray(res.x)[:n]
    return res, mesh


def _cg_step(A, M, x, r, z, p, rz):
    """One CG update (the solver's 'training step')."""
    Ap = A(p)
    alpha = rz / jnp.vdot(p, Ap).real
    x = x + alpha * p
    r = r - alpha * Ap
    z = M(r)
    rz_new = jnp.vdot(r, z).real
    beta = rz_new / rz
    p = z + beta * p
    return x, r, z, p, rz_new


def distributed_pcg_step(A_host: HostCSR, b, params: AMGParameters = None,
                         idofs=None, mesh=None, dtype=jnp.float32):
    """Build the sharded operators and run ONE jitted CG step SPMD.
    Returns the jitted step fn and its example state (for dry runs)."""
    if mesh is None:
        mesh = device_mesh()
    ndev = mesh.devices.size
    if params is None:
        params = AMGParameters(aggregation_type="hem", cycle_type="v",
                               schwarz_levels=1,
                               dtype=np.dtype(dtype).name)
    A2, b2, _ = _pad_problem(A_host, b, ndev)
    prec = setup_amg(A2, params, idofs=idofs, pad_multiple=ndev)
    prec = shard_preconditioner(prec, mesh)
    Ae = shard_ell(ELL.from_host(A2, dtype=dtype), mesh)
    bj = shard_vector(jnp.asarray(b2, dtype=dtype), mesh)
    Afn = matvec_op(Ae)
    Mfn = as_operator(prec)

    # operators as traced args (Partial pytrees), not closure constants
    jitted = jax.jit(_cg_step)

    def step(x, r, z, p, rz):
        return jitted(Afn, Mfn, x, r, z, p, rz)

    x0 = jnp.zeros_like(bj)
    r0 = bj
    z0 = Mfn(r0)
    rz0 = jnp.vdot(r0, z0).real
    return step, (x0, r0, z0, z0, rz0)


# ---------------------------------------------------------------------------
# Distributed grid path (DIA + reshape transfers) — pads the slowest grid
# axis to ndev * 2**shard_depth ghost vertices so levels 0..shard_depth
# divide the mesh exactly and _put_best shards them for real.
# Because dof order is axis-0-major, a row shard is a contiguous slab of
# grid rows: the 2x window restriction/prolongation reshapes stay entirely
# shard-local (device boundaries fall on even axis-0 offsets).
# ---------------------------------------------------------------------------

def _vertex_embedding(dims, dims2):
    """newv[v]: flat vertex index in dims2 of old vertex v (lex order,
    last axis fastest)."""
    nv = int(np.prod(dims))
    coords = []
    rem = np.arange(nv)
    for ax in reversed(range(len(dims))):
        coords.append(rem % dims[ax])
        rem //= dims[ax]
    coords = coords[::-1]
    newv = np.zeros(nv, dtype=np.int64)
    for ax in range(len(dims)):
        newv = newv * dims2[ax] + coords[ax]
    return newv


def pad_grid_problem(A_host: HostCSR, b, dims, F, mult):
    """Append ghost vertices up to per-axis multiples.

    mult: int (axis 0 only — mesh divisibility) or a per-axis tuple.
    A_host/b are field-major
    ([u1-block; u2-block]).  Ghost rows are identity with mask 0
    (excluded from smoothing and coarse sums).
    Returns (A2, b2, dims2, mask2)."""
    if np.isscalar(mult):
        mults = (int(mult),) + (1,) * (len(dims) - 1)
    else:
        mults = tuple(int(m) for m in mult)
    dims2 = tuple(-(-d // m) * m for d, m in zip(dims, mults))
    nv = int(np.prod(dims))
    if dims2 == tuple(dims):
        return A_host, np.asarray(b, dtype=np.float64), tuple(dims), \
            np.ones(nv * F)
    nv2 = int(np.prod(dims2))
    newv = _vertex_embedding(dims, dims2)
    r, c, v = A_host.to_coo()
    r2 = (r // nv) * nv2 + newv[r % nv]
    c2 = (c // nv) * nv2 + newv[c % nv]
    mask2 = np.zeros(nv2 * F)
    for f in range(F):
        mask2[f * nv2 + newv] = 1.0
    ghosts = np.flatnonzero(mask2 == 0)
    A2 = HostCSR.from_coo(
        np.concatenate([r2, ghosts]), np.concatenate([c2, ghosts]),
        np.concatenate([v, np.ones(len(ghosts))]), (nv2 * F, nv2 * F))
    b2 = np.zeros(nv2 * F)
    bb = np.asarray(b, dtype=np.float64)
    for f in range(F):
        b2[f * nv2 + newv] = bb[f * nv:(f + 1) * nv]
    return A2, b2, dims2, mask2


def unpad_grid_vector(x2, dims, dims2, F):
    """Inverse of pad_grid_problem's vector embedding."""
    nv = int(np.prod(dims))
    nv2 = int(np.prod(dims2))
    if nv == nv2:
        return np.asarray(x2)
    newv = _vertex_embedding(dims, dims2)
    x = np.empty(nv * F)
    x2 = np.asarray(x2)
    for f in range(F):
        x[f * nv:(f + 1) * nv] = x2[f * nv2 + newv]
    return x


def distributed_grid_solve(A_host: HostCSR, b, dims, F=1,
                           params: AMGParameters = None, mesh=None,
                           tol=1e-8, maxiter=500, dtype=jnp.float32,
                           shard_depth=3, cheb_degree=3):
    """Row-sharded grid-hierarchy PCG over the device mesh.

    Levels 0..shard_depth are sharded (operators, masks, block inverses,
    iterates all P("p") on rows); deeper levels replicate.  Collectives
    (halo all-gathers for the DIA shifts, psums for dots) are inserted by
    GSPMD from the shardings.  The distribution is exact, so iteration
    counts do not depend on the device count."""
    from ..amg.grid import setup_grid, grid_system
    from ..sparse.dia import dia_matvec_op
    from .sharding import shard_preconditioner, shard_dia, _put
    from jax.sharding import PartitionSpec as P
    if mesh is None:
        mesh = device_mesh()
    ndev = mesh.devices.size
    if params is None:
        params = AMGParameters(cycle_type="v",
                               dtype=np.dtype(dtype).name)
    A2, b2, dims2, mask2 = pad_grid_problem(A_host, b, dims, F,
                                            ndev * 2 ** shard_depth)
    # replicate levels deeper than shard_depth
    n_sd = int(np.prod([-(-d // 2 ** shard_depth) for d in dims2])) * F
    # Build the unsharded hierarchy in host memory: built on the default
    # device, it would sit whole on device 0 until resharded and raise
    # that device's peak above the others'.
    with jax.default_device(jax.devices("cpu")[0]):
        prec, slots, nsl = setup_grid(A2, dims2, F=F, mask=mask2,
                                      params=params, dtype=dtype,
                                      cheb_degree=cheb_degree)
        Adia = grid_system(A2, slots, dtype=dtype)
        bj = jnp.zeros(nsl, dtype=dtype).at[jnp.asarray(slots)].set(
            jnp.asarray(b2, dtype=dtype))
    prec = shard_preconditioner(prec, mesh, replicate_below=n_sd)
    n_shardable = sum(1 for L in prec.levels if L.A.shape[0] >= n_sd)
    Adia = shard_dia(Adia, mesh)
    bj = _put(bj, mesh, P("p"))
    res = pcg(dia_matvec_op(Adia), bj, M=as_operator(prec), tol=tol,
              maxiter=maxiter)
    x2 = np.asarray(res.x)[np.asarray(slots)]
    res.x = unpad_grid_vector(x2, dims, dims2, F)
    res.dist_info = {"ndev": ndev, "nflat": nsl,
                     "levels": len(prec.levels),
                     "sharded_levels": n_shardable}
    return res, mesh
