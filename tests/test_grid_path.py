"""Structured-grid (DIA, gather-free) path tests — correctness vs the
algebraic path and gamma/h robustness."""
import numpy as np
import pytest
import jax.numpy as jnp

from tpuamg.fem import mms, tagged_unit_square, stiffness_matrix, \
    load_vector, apply_bc_monolithic
from tpuamg.problems.bidomain import Params, get_mesh, get_system
from tpuamg.problems.solve import solve_system
from tpuamg.sparse import HostCSR
from tpuamg.sparse.dia import DIA, dia_matvec_op
from tpuamg.config import AMGParameters


def test_dia_roundtrip_and_matvec():
    rng = np.random.default_rng(0)
    import scipy.sparse as sp
    a = sp.random(40, 40, density=0.1, random_state=rng, format="csr")
    a = a + sp.eye(40)
    H = HostCSR(a.indptr, a.indices, a.data, a.shape)
    D = DIA.from_host(H, dtype=jnp.float64)
    np.testing.assert_allclose(D.to_host().toarray(), a.toarray())
    x = rng.standard_normal(40)
    np.testing.assert_allclose(np.asarray(D.matvec(jnp.asarray(x))),
                               a @ x, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(D.diagonal()), a.diagonal())


@pytest.mark.parametrize("gamma", [1e0, 1e6, 1e10])
def test_grid_bidomain_gamma_robust(gamma):
    p = Params(2.0, 3.0, gamma)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh = get_mesh(16, 2)
    A, b, sizes, _ = get_system(mesh, data, p)
    prm = AMGParameters(cycle_type="w", dtype="float64")
    rep = solve_system(A, b, "metric_mono", sizes, params=prm,
                       tol=1e-8, maxiter=60, grid=((17, 17), 2))
    assert rep.converged and rep.niters <= 20, (gamma, rep.niters)
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < 1e-7


def test_grid_matches_algebraic_solution():
    p = Params(2.0, 3.0, 1e4)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh = get_mesh(12, 2)
    A, b, sizes, _ = get_system(mesh, data, p)
    idofs = np.arange(sizes[0], sum(sizes))
    rep_a = solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                         tol=1e-10, maxiter=100)
    rep_g = solve_system(A, b, "metric_mono", sizes, tol=1e-10,
                         maxiter=100, grid=((13, 13), 2))
    np.testing.assert_allclose(rep_g.x, rep_a.x, atol=1e-7)


def test_grid_bidomain_3d():
    p = Params(2.0, 3.0, 1e6)
    data = mms.setup_bidomain_mms(p, dim=3)
    mesh = get_mesh(4, 3)
    A, b, sizes, _ = get_system(mesh, data, p)
    rep = solve_system(A, b, "metric_mono", sizes, tol=1e-8, maxiter=60,
                       grid=((5, 5, 5), 2))
    assert rep.converged and rep.niters < 30
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < 1e-7


def test_grid_poisson_single_field():
    m = tagged_unit_square(16)
    A = stiffness_matrix(m)
    b = load_vector(m, lambda x: np.ones(len(x)))
    bd = m.boundary_vertices((1, 2, 3, 4))
    A, b = apply_bc_monolithic(A, b, bd, np.zeros(len(bd)))
    rep = solve_system(A, b, "metric_mono", (len(b),), tol=1e-9,
                       maxiter=100, grid=((17, 17), 1))
    assert rep.converged
    rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
    assert rel < 1e-7


def test_structured_morton_path():
    """The general (pair+Morton) gather-free path also solves bidomain."""
    from tpuamg.amg.structured import setup_structured, structured_system
    from tpuamg.amg import as_operator
    from tpuamg.krylov import pcg
    import jax.numpy as jnp
    p = Params(2.0, 3.0, 1e6)
    data = mms.setup_bidomain_mms(p, dim=2)
    mesh = get_mesh(12, 2)
    A, b, sizes, _ = get_system(mesh, data, p)
    coords = np.concatenate([mesh.vertices, mesh.vertices], axis=0)
    prm = AMGParameters(cycle_type="v", dtype="float64")
    prec, slots, nsl = setup_structured(A, coords, prm, dtype=jnp.float64)
    Adia = structured_system(A, slots, nsl, dtype=jnp.float64)
    bs = jnp.zeros(nsl).at[jnp.asarray(slots)].set(jnp.asarray(b))
    res = pcg(dia_matvec_op(Adia), bs, M=as_operator(prec), tol=1e-8,
              maxiter=100)
    assert res.converged
    x = np.asarray(res.x)[slots]
    rel = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert rel < 1e-6


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-8),
                                       (jnp.float32, 1e-5)])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_grid_pcg_against_ell_path(cycle, dtype, tol):
    """Grid-path PCG (V and W cycles, f32 and f64) reaches the same
    solution as the algebraic ELL path within a small multiple of its
    iteration count (measured at n=16: grid 5-9, ELL 2-4)."""
    from dataclasses import replace
    from tpuamg.config import PRESETS
    p = Params(2.0, 3.0, 1e6)
    data = mms.setup_bidomain_mms(p, dim=2)
    A, b, sizes, _ = get_system(get_mesh(16, 2), data, p)
    idofs = np.arange(sizes[0], sum(sizes))
    prm = replace(PRESETS["metric_schwarz"], cycle_type=cycle)
    g = solve_system(A, b, "metric_mono", sizes, params=prm, tol=tol,
                     maxiter=100, dtype=dtype, grid=((17, 17), 2))
    e = solve_system(A, b, "metric_mono", sizes, idofs=idofs, params=prm,
                     tol=tol, maxiter=100, dtype=dtype)
    assert g.converged and e.converged
    assert g.niters <= 2 * e.niters + 2, (g.niters, e.niters)
    bound = 1e-12 if dtype == jnp.float64 else 1e-6
    for rep in (g, e):
        rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
        assert rel < bound, rel
    # the gamma=1e6 system's condition number turns a 1e-7 f32 residual
    # into a ~3e-4 relative error in x
    agree = 1e-8 if dtype == jnp.float64 else 1e-3
    assert np.linalg.norm(g.x - e.x) / np.linalg.norm(e.x) < agree
