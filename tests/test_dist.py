"""Distributed-path tests on the virtual 8-device CPU mesh
(SURVEY.md §4: 'test multi-node without a cluster')."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuamg.fem import (tagged_unit_square, stiffness_matrix, load_vector,
                        apply_bc_monolithic, mms)
from tpuamg.dist import device_mesh
from tpuamg.dist.solve import distributed_solve, distributed_pcg_step
from tpuamg.config import AMGParameters


@pytest.fixture(scope="module")
def system():
    m = tagged_unit_square(20)
    A = stiffness_matrix(m)
    b = load_vector(m, lambda x: np.ones(len(x)))
    bd = m.boundary_vertices((1, 2, 3, 4))
    return apply_bc_monolithic(A, b, bd, np.zeros(len(bd)))


def test_eight_devices_present():
    assert len(jax.devices()) >= 8


def test_distributed_solve_matches_serial(system):
    A, b = system
    params = AMGParameters(aggregation_type="hem", cycle_type="v",
                           dtype="float64")
    res, mesh = distributed_solve(A, b, params=params, tol=1e-10,
                                  maxiter=200, dtype=jnp.float64)
    assert mesh.devices.size >= 8
    assert res.converged
    x = np.asarray(res.x)
    rel = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert rel < 1e-8


def test_distributed_pcg_step_runs(system):
    A, b = system
    step, state = distributed_pcg_step(A, b, dtype=jnp.float64)
    out = step(*state)
    jax.block_until_ready(out)
    x, r, z, p, rz = out
    assert np.isfinite(float(rz))
    # one step must reduce the residual of Ax=b from x=0
    assert np.linalg.norm(np.asarray(r)[:A.shape[0]]) < \
        np.linalg.norm(b)


def test_distributed_grid_hierarchy():
    """The structured (DIA/grid) hierarchy shards over the device mesh and
    solves SPMD with XLA-inserted collectives."""
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    from tpuamg.amg.grid import setup_grid, grid_system
    from tpuamg.amg import as_operator
    from tpuamg.dist import device_mesh, shard_preconditioner, shard_vector
    from tpuamg.dist.sharding import shard_dia
    from tpuamg.sparse.dia import dia_matvec_op
    from tpuamg.krylov import pcg
    from tpuamg.config import AMGParameters

    p = Params(2.0, 3.0, 1e6)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh2d = get_mesh(16, 2)
    A, b, sizes, _ = get_system(mesh2d, data, p)
    prm = AMGParameters(cycle_type="v", dtype="float64")
    prec, slots, nsl = setup_grid(A, (17, 17), F=2, params=prm,
                                  dtype=jnp.float64)
    dmesh = device_mesh()
    prec_s = shard_preconditioner(prec, dmesh, replicate_below=64)
    Adia = shard_dia(grid_system(A, slots, dtype=jnp.float64), dmesh)
    bs = jnp.zeros(nsl).at[jnp.asarray(slots)].set(jnp.asarray(b))
    res = pcg(dia_matvec_op(Adia), bs, M=as_operator(prec_s),
              tol=1e-8, maxiter=60)
    assert res.converged and res.niters < 30
    x = np.asarray(res.x)[slots]
    rel = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert rel < 1e-6


def test_distributed_metric_bidomain():
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    p = Params(2.0, 3.0, 1e6)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh2d = get_mesh(12, 2)
    A, b, sizes, _ = get_system(mesh2d, data, p)
    idofs = np.arange(sizes[0], sum(sizes))
    params = AMGParameters(aggregation_type="hem", cycle_type="v",
                           schwarz_levels=1, dtype="float64")
    res, _ = distributed_solve(A, b, params=params, idofs=idofs,
                               tol=1e-8, maxiter=100, dtype=jnp.float64)
    assert res.converged and res.niters < 40


def test_distributed_grid_solve_pads_and_shards():
    """Grid-dim padding to mesh divisibility: fine levels must be truly
    row-sharded (not replicated fallbacks), and the padded solve must
    match the serial grid-path solution."""
    from jax.sharding import PartitionSpec as P
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    from tpuamg.dist.solve import (pad_grid_problem, distributed_grid_solve,
                                   unpad_grid_vector)
    from tpuamg.dist.sharding import shard_preconditioner, device_mesh
    from tpuamg.amg.grid import setup_grid

    p = Params(2.0, 3.0, 1e4)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh2d = get_mesh(16, 2)     # dims (17, 17): NOT divisible by 8
    A, b, sizes, _ = get_system(mesh2d, data, p)
    dmesh = device_mesh()
    ndev = dmesh.devices.size
    shard_depth = 1
    A2, b2, dims2, mask2 = pad_grid_problem(A, b, (17, 17), 2,
                                            ndev * 2 ** shard_depth)
    assert dims2[0] % (ndev * 2 ** shard_depth) == 0
    # padded system keeps the original equations intact
    nv, nv2 = 17 * 17, dims2[0] * 17
    x_probe = np.random.default_rng(0).standard_normal(A.shape[0])
    x2_probe = np.zeros(A2.shape[0])
    for f in range(2):
        x2_probe[f * nv2:f * nv2 + nv] = x_probe[f * nv:(f + 1) * nv]
    y2 = A2.matvec(x2_probe)
    np.testing.assert_allclose(unpad_grid_vector(y2, (17, 17), dims2, 2),
                               A.matvec(x_probe), rtol=1e-12, atol=1e-12)

    prm = AMGParameters(cycle_type="v", dtype="float64")
    n_sd = int(np.prod([-(-d // 2 ** shard_depth) for d in dims2])) * 2
    prec, slots, nsl = setup_grid(A2, dims2, F=2, mask=mask2, params=prm,
                                  dtype=jnp.float64)
    prec_s = shard_preconditioner(prec, dmesh, replicate_below=n_sd)
    # the divisible fine level must be genuinely row-sharded
    fine = prec_s.levels[0]
    specs = {tuple(s.spec) for s in
             [fine.A.data.sharding, fine.mask.sharding]}
    assert (None, "p") in specs or ("p",) in specs, specs

    res, _ = distributed_grid_solve(A, b, (17, 17), F=2, mesh=dmesh,
                                    params=prm, tol=1e-8, maxiter=60,
                                    dtype=jnp.float64,
                                    shard_depth=shard_depth)
    assert res.converged and res.niters < 30
    from tpuamg.problems.solve import solve_system
    rep = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                       maxiter=60, grid=((17, 17), 2))
    rel = np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b)
    assert rel < 1e-6
    np.testing.assert_allclose(res.x, rep.x, atol=1e-5)


def test_agglomerated_coarse_sharding():
    """Three-tier residency over a ("po","pi") mesh: fine level sharded
    over all 8 devices, mid levels agglomerated onto the po groups,
    coarse replicated — and the solve still matches the serial one."""
    from jax.sharding import PartitionSpec as P
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    from tpuamg.dist.sharding import (device_mesh2d,
                                      shard_preconditioner_agglomerated,
                                      shard_dia, _put)
    from tpuamg.dist.solve import pad_grid_problem, unpad_grid_vector
    from tpuamg.amg.grid import setup_grid, grid_system
    from tpuamg.sparse.dia import dia_matvec_op
    from tpuamg.krylov import pcg
    from tpuamg.amg import as_operator

    p = Params(2.0, 3.0, 1e4)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh2d = get_mesh(16, 2)
    A, b, sizes, _ = get_system(mesh2d, data, p)
    dmesh = device_mesh2d(outer=2, inner=4)
    A2, b2, dims2, mask2 = pad_grid_problem(A, b, (17, 17), 2, 8 * 2)
    prm = AMGParameters(cycle_type="v", dtype="float64", coarse_dof=32)
    prec, slots, nsl = setup_grid(A2, dims2, F=2, mask=mask2, params=prm,
                                  dtype=jnp.float64)
    sizes_lvl = [L.A.shape[0] for L in prec.levels]
    assert len(sizes_lvl) >= 3, sizes_lvl
    # thresholds chosen so all 3 tiers occur: level 0 fully sharded,
    # middle level(s) agglomerated onto po groups, last level replicated
    prec_s = shard_preconditioner_agglomerated(
        prec, dmesh, agglomerate_below=sizes_lvl[0],
        replicate_below=sizes_lvl[-1] + 1)
    specs = [tuple(L.A.data.sharding.spec) for L in prec_s.levels]
    assert specs[0] in ((None, ("po", "pi")),), specs[0]
    assert any(s == (None, "po") for s in specs[1:]), specs
    assert specs[-1] == (), specs[-1]

    Adia = grid_system(A2, slots, dtype=jnp.float64)
    Adia = shard_dia(Adia, dmesh, row_sharded=False)  # replicate outer op
    bj = jnp.zeros(nsl).at[jnp.asarray(slots)].set(jnp.asarray(b2))
    res = pcg(dia_matvec_op(Adia), bj, M=as_operator(prec_s), tol=1e-8,
              maxiter=60)
    assert res.converged
    x = unpad_grid_vector(np.asarray(res.x)[np.asarray(slots)],
                          (17, 17), dims2, 2)
    rel = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert rel < 1e-6, rel


@pytest.fixture(scope="module")
def bidomain16():
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    from tpuamg.problems.solve import solve_system
    p = Params(2.0, 3.0, 1e6)
    data = mms.setup_bidomain_mms(p, dim=2)
    A, b, sizes, _ = get_system(get_mesh(16, 2), data, p)
    prm = AMGParameters(cycle_type="v", dtype="float64")
    serial = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                          maxiter=100, dtype=jnp.float64,
                          grid=((17, 17), 2))
    return A, b, prm, serial


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_distributed_grid_matches_serial_iterations(bidomain16, ndev):
    """The sharded grid path is exact: on 1, 2 and 4 devices it takes the
    serial grid path's iteration count and returns its solution (ghost
    padding differs with the device count and must not matter)."""
    from tpuamg.dist.solve import distributed_grid_solve
    A, b, prm, serial = bidomain16
    mesh = device_mesh(devices=jax.devices()[:ndev])
    res, _ = distributed_grid_solve(A, b, (17, 17), F=2, mesh=mesh,
                                    params=prm, tol=1e-8, maxiter=100,
                                    dtype=jnp.float64)
    assert res.dist_info["ndev"] == ndev
    assert res.converged and res.niters == serial.niters
    diff = np.linalg.norm(res.x - serial.x) / np.linalg.norm(serial.x)
    assert diff < 1e-9, diff
