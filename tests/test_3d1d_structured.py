"""3D-1D structured path: exact DIA+footprint-block operator split and
gamma-robust composite-B smoothing (round-1 backlog item: 'curve-coupling
footprint blocks do not fit the pair smoother')."""
import numpy as np
import jax.numpy as jnp
import pytest

from tpuamg.fem import unit_cube_mesh
from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
from tpuamg.problems.solve import solve_system
from tpuamg.config import AMGParameters
from tpuamg.sparse import HostCSR
from tpuamg.amg.structured import (_neighbor_blocks,
                                   split_footprint_operator, StructuredOp)
from tpuamg.sparse.dia import DIA


def _system(gamma, n=6, n_main=16, n_branches=2):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=n_main, n_branches=n_branches)
    A, b, sizes = get_system(mesh3d, curve, k3=3.0,
                             k1=7.0 * np.pi * 0.04,
                             gamma=gamma * 2 * np.pi * 0.2,
                             coupling_radius=0.2)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    return A, b, sizes, coords


def test_split_operator_is_exact():
    A, b, sizes, _ = _system(1e4)
    n3, n1 = sizes
    seeds = np.arange(n3, n3 + n1)
    blocks = _neighbor_blocks(A, seeds)
    A_dia, ids, mats, spill = split_footprint_operator(A, blocks)
    assert spill is None     # uncapped: exact two-part split
    D = DIA.from_host(A_dia, dtype=jnp.float64)
    op = StructuredOp(D, jnp.asarray(ids), jnp.asarray(mats), nnz=A.nnz)
    # the DIA part must be dramatically narrower than the full matrix
    rr, cc, _ = A.to_coo()
    full_ndiags = len(np.unique(cc - rr))
    assert len(D.offsets) < 0.5 * full_ndiags, \
        (len(D.offsets), full_ndiags)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-10)
    r = np.asarray(op.residual(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(r, b - A.matvec(x), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("gamma", [1e0, 1e4, 1e8])
def test_3d1d_structured_gamma_robust(gamma):
    A, b, sizes, coords = _system(gamma)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                       maxiter=150, structured_coords=coords,
                       idofs=idofs)
    assert rep.converged, (gamma, rep.niters)
    assert rep.niters <= 40, (gamma, rep.niters)
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < 1e-7, (gamma, rel)


def test_3d1d_hybrid_algebraic_tail():
    """Structured fine levels + algebraic metric-AMG coarse tail
    (setup_structured algebraic_below): gamma-flat coarse spaces at
    structured-path speed.  Must converge at the hard sweep end and not
    be worse than the pure window hierarchy."""
    gamma = 1e8
    A, b, sizes, coords = _system(gamma)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                       maxiter=150, structured_coords=coords,
                       idofs=idofs,
                       algebraic_below=A.shape[0] // 2)
    assert rep.converged, rep.niters
    assert rep.niters <= 40, rep.niters
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < 1e-7, rel


def test_hem_banded_ordering():
    """banded-HEM hybrid (HEM pairing inside Morton macro-windows):
    converges at extreme gamma like global HEM, with DIA bands bounded
    toward the Morton layout's (amg/structured.hem_tree_slots window)."""
    from tpuamg.amg.structured import setup_structured
    A, b, sizes, coords = _system(1e8)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)

    def width(order):
        prec, _, _ = setup_structured(A, coords, prm, dtype=jnp.float64,
                                      idofs=idofs,
                                      order=order)
        D = getattr(prec.levels[0].A, "dia", prec.levels[0].A)
        return len(D.offsets)

    w_hem, w_banded = width("hem"), width("hem_banded:8")
    assert w_banded < w_hem, (w_banded, w_hem)

    rep = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                       maxiter=150, structured_coords=coords,
                       idofs=idofs,
                       structured_order="hem_banded:8")
    assert rep.converged, rep.niters


def test_rank1_schur_footprint_moderate_gamma():
    """Rank-1 Schur footprint smoother (O(m) storage per block,
    smoothers/schwarz.Rank1SchurSmoother): converges at moderate gamma;
    exact-inverse LocalSchwarz remains the high-gamma path (the class
    docstring records the measured limits)."""
    A, b, sizes, coords = _system(1e4)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                       maxiter=100, structured_coords=coords,
                       idofs=idofs)
    from tpuamg.amg.structured import setup_structured, structured_system
    from tpuamg.sparse.dia import dia_matvec_op
    from tpuamg.amg import as_operator
    from tpuamg.krylov import pcg
    import jax.numpy as _jnp
    prec, slots, nsl = setup_structured(A, coords, prm,
                                        dtype=_jnp.float64,
                                        idofs=idofs, fp_solver="rank1")
    Aop = dia_matvec_op(structured_system(A, slots, nsl,
                                          dtype=_jnp.float64,
                                          idofs=idofs))
    bj = _jnp.zeros(nsl, _jnp.float64).at[_jnp.asarray(slots)].set(
        _jnp.asarray(b))
    r = pcg(Aop, bj, M=as_operator(prec), tol=1e-8, maxiter=100)
    assert r.converged and r.niters <= 2.5 * max(rep.niters, 10), (
        r.niters, rep.niters)


def test_split_operator_spill_cap_exact():
    """DIA band cap: rare offsets spill to the COO part, matvec exact."""
    A, b, sizes, _ = _system(1e4)
    n3, n1 = sizes
    seeds = np.arange(n3, n3 + n1)
    blocks = _neighbor_blocks(A, seeds)
    A_dia, ids, mats, spill = split_footprint_operator(A, blocks,
                                                       max_offsets=8)
    assert spill is not None
    D = DIA.from_host(A_dia, dtype=jnp.float64)
    assert len(D.offsets) <= 9   # 8 + forced main diagonal
    op = StructuredOp(D, jnp.asarray(ids), jnp.asarray(mats), nnz=A.nnz,
                      spill=(jnp.asarray(spill[0]), jnp.asarray(spill[1]),
                             jnp.asarray(spill[2])))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0])
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-10)
    r = np.asarray(op.residual(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(r, b - A.matvec(x), rtol=1e-12, atol=1e-10)


def test_tiled_order_convergence():
    """lattice_tiled_slots path: narrow DIA + converging solve."""
    from tpuamg.amg.structured import lattice_tiled_slots
    from tpuamg.problems.solve import solve_system
    from tpuamg.config import AMGParameters
    A, b, sizes, coords = _system(1e6)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    slots0, nsl = lattice_tiled_slots(coords, idofs, A.shape[0])
    assert len(np.unique(slots0)) == A.shape[0]
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm,
                       tol=1e-8, maxiter=100, idofs=idofs,
                       structured_coords=coords,
                       structured_order="tiled")
    assert rep.converged and rep.niters <= 40, rep.niters


def test_3d1d_hybrid_gamma_tail_flat():
    """Hybrid tail bounds the extreme-gamma growth: measured n=10 sweep
    11/10/20/22/23/22 (flat from 1e4 on) vs 11/9/20/26/29/28 purely
    structured (docs/PERF_NOTES.md round-2 cont.).  Guard the ratio at
    the 1e10 end on the small fixture."""
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)
    iters = {}
    for gamma in (1e0, 1e10):
        A, b, sizes, coords = _system(gamma)
        n3, n1 = sizes
        idofs = np.arange(n3, n3 + n1)
        rep = solve_system(A, b, "metric_mono", sizes, params=prm,
                           tol=1e-8, maxiter=150,
                           structured_coords=coords, idofs=idofs,
                           algebraic_below=700)
        assert rep.converged, (gamma, rep.niters)
        iters[gamma] = rep.niters
    assert iters[1e10] <= 30, iters
    assert iters[1e10] <= 2.5 * iters[1e0], iters


def test_host_tail_split_parity():
    """Host-side f64 tail (amg.structured.HostTailHybrid driven by
    krylov.pcg_split) is numerically the SAME operator as the unified
    device hybrid for cycle='v', maxit=1 — the split moves the tail's
    gather/scatter ops from the device to the host."""
    gamma = 1e8
    A, b, sizes, coords = _system(gamma)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2)
    kw = dict(params=prm, tol=1e-8, maxiter=150,
              structured_coords=coords, idofs=idofs,
              algebraic_below=700)
    r0 = solve_system(A, b, "metric_mono", sizes, **kw)
    r1 = solve_system(A, b, "metric_mono", sizes, host_tail=True, **kw)
    assert r1.converged, (r1.niters, r1.r_norm)
    # identical math, separately compiled programs: allow 1 iter of
    # reassociation jitter
    assert abs(r1.niters - r0.niters) <= 1, (r1.niters, r0.niters)
    np.testing.assert_allclose(r1.x, r0.x, rtol=1e-6, atol=1e-9)


def test_host_tail_full_tail_coarse_scaling_parity():
    """coarse_scaling=True with the tail covering ALL dofs (no device
    window levels): the split
    hybrid must match the unified preconditioner, which never scales
    its own top-level output (hierarchy._cycle scales only between
    levels).  Guards the len(fine.levels)==0 skip in
    HostTailHybrid.tail_apply."""
    gamma = 1e6
    A, b, sizes, coords = _system(gamma)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=2, coarse_scaling=True)
    kw = dict(params=prm, tol=1e-8, maxiter=150,
              structured_coords=coords, idofs=idofs,
              algebraic_below=10 ** 9)   # tail owns every dof
    r0 = solve_system(A, b, "metric_mono", sizes, **kw)
    r1 = solve_system(A, b, "metric_mono", sizes, host_tail=True, **kw)
    assert r1.converged, (r1.niters, r1.r_norm)
    assert abs(r1.niters - r0.niters) <= 1, (r1.niters, r0.niters)
    np.testing.assert_allclose(r1.x, r0.x, rtol=1e-6, atol=1e-9)


def test_host_tail_mixed_precision_production_config():
    """The production run_solver_3d1d configuration (f32 storage + f64
    Krylov vectors + factored outer operator + refine) with the host
    tail: true residual to tolerance."""
    import jax.numpy as jnp
    from tpuamg.problems.emi_3d1d import get_system as _gs
    from tpuamg.fem import unit_cube_mesh
    mesh3d = unit_cube_mesh(6)
    curve = synthetic_neuron_curve(n_main=16, n_branches=2)
    g = 1e8 * 2 * np.pi * 0.2
    A, b, sizes, (Pi, Mq) = _gs(mesh3d, curve, k3=3.0,
                                k1=7.0 * np.pi * 0.04, gamma=g,
                                coupling_radius=0.2,
                                return_coupling=True)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float32",
                        schwarz_levels=2)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm,
                       tol=1e-6, maxiter=100, idofs=idofs,
                       dtype=jnp.float32, krylov_dtype=jnp.float64,
                       refine=3, inner_tol=2e-5,
                       coupling=(g, Pi, Mq),
                       structured_coords=coords,
                       algebraic_below=700, host_tail=True)
    assert rep.converged, (rep.niters, rep.r_norm)
    assert rep.r_norm < 1e-6, rep.r_norm


def test_mixed_precision_split_outer_true_residual():
    """f32-STORED entrywise operators are catastrophically wrong at
    large gamma: for iterates near the gamma-null space (R x ~ 0 —
    where CG converges) the rounded +-gamma entries leave ~40% RELATIVE
    matvec error, and the inner PCG converges cleanly to the WRONG
    system (preconditioned residual 1e-8, true residual 0.4 — round-3
    find, docs/PERF_NOTES.md).  The factored outer operator
    (solve._split_metric_operator: AD + gamma R^T Mq R with f64-stored
    R) + f64 Krylov vectors restores true convergence with f32 bulk
    storage.  Guard the TRUE residual."""
    import jax.numpy as jnp
    from tpuamg.problems.emi_3d1d import get_system as _gs
    from tpuamg.fem import unit_cube_mesh
    mesh3d = unit_cube_mesh(6)
    curve = synthetic_neuron_curve(n_main=16, n_branches=2)
    A, b, sizes, (Pi, Mq) = _gs(mesh3d, curve, k3=3.0,
                                k1=7.0 * np.pi * 0.04,
                                gamma=1e8 * 2 * np.pi * 0.2,
                                coupling_radius=0.2,
                                return_coupling=True)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float32",
                        schwarz_levels=2)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm,
                       tol=1e-6, maxiter=100, idofs=idofs,
                       dtype=jnp.float32, krylov_dtype=jnp.float64,
                       refine=3, inner_tol=2e-5,
                       coupling=(1e8 * 2 * np.pi * 0.2, Pi, Mq),
                       structured_coords=coords,
                       algebraic_below=700)
    assert rep.converged, (rep.niters, rep.r_norm)
    # r_norm is the TRUE f64 relative residual from the refine loop
    assert rep.r_norm < 1e-6, rep.r_norm


def test_keep_idofs_slot_layout():
    """keep_idofs stride blocks: every interface dof sits at the start
    of an ALIGNED idof_stride block of the tiled slot space, so it
    stays alone in its s=2/s=4 window through L window levels (the
    metricAMG idofs contract applied to the window hierarchy)."""
    from tpuamg.amg.structured import lattice_tiled_slots
    A, b, sizes, coords = _system(1e4)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    for L, stride in ((1, 2), (2, 8), (3, 32)):
        slots0, nsl = lattice_tiled_slots(coords, idofs, A.shape[0],
                                          idof_stride=stride)
        assert len(np.unique(slots0)) == A.shape[0]
        si = slots0[idofs]
        assert np.all(si % stride == 0), (L, si[:4])
        # no two dofs (bulk or interface) share an idof block
        others = np.setdiff1d(slots0, si)
        blk = np.concatenate([si // stride, others // stride])
        assert len(np.unique(si // stride)) == n1
        assert not np.intersect1d(si // stride, others // stride).size


@pytest.mark.parametrize("keep", [1, 2])
def test_keep_idofs_gamma_converges(keep):
    """gamma-robust window coarse space: plain window levels above the
    tail STALL at gamma=1e8 at production curve density (round-4
    measurement, docs/PERF_NOTES.md); keeping interface dofs injected
    through the window levels converges (measured n=16 production dump:
    full-tail 17, keep1 49, keep2 102 iters vs 200+ no-convergence
    unkept).  Guard the mechanism on the small fixture."""
    gamma = 1e8
    A, b, sizes, coords = _system(gamma)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    prm = AMGParameters(cycle_type="v", dtype="float64",
                        schwarz_levels=1, schwarz_cluster=True)
    rep = solve_system(A, b, "metric_mono", sizes, params=prm, tol=1e-8,
                       maxiter=150, structured_coords=coords,
                       idofs=idofs,
                       structured_order="auto",
                       algebraic_below=A.shape[0] // 4,
                       keep_idofs=keep)
    assert rep.converged, (keep, rep.niters)
    assert rep.niters <= 60, (keep, rep.niters)
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < 1e-7, (keep, rel)


def test_keep_idofs_requires_tiled_order():
    A, b, sizes, coords = _system(1e2)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    with pytest.raises(ValueError, match="keep_idofs"):
        solve_system(A, b, "metric_mono", sizes, tol=1e-8, maxiter=10,
                     params=AMGParameters(cycle_type="v",
                                          dtype="float64"),
                     structured_coords=coords, idofs=idofs,
                     structured_order="morton",
                     keep_idofs=1)
