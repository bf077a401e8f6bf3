"""run_solver_3d1d routing: one route, the algebraic ELL path in float64,
whatever the dump holds (coords and the metric factorization are ignored),
from either dump layout."""
import numpy as np
import pytest
import jax.numpy as jnp

from tpuamg.io_utils import dump_system, read_solution
from tpuamg.problems import run_solver_3d1d

DAT = "tpuamg/problems/input_metric.dat"


@pytest.fixture(scope="module")
def system3d1d():
    from tpuamg.fem import unit_cube_mesh
    from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
    mesh3d = unit_cube_mesh(4)
    curve = synthetic_neuron_curve(n_main=8, n_branches=1)
    gamma = 1e8
    A, b, sizes, coupling = get_system(mesh3d, curve, gamma=gamma,
                                       coupling_radius=0.2,
                                       return_coupling=True)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    return A, b, sizes, coupling, coords, gamma


def _dump(tmp_path, system, compact):
    A, b, sizes, coupling, coords, gamma = system
    d = str(tmp_path / f"dump_{compact}")
    dump_system(A, b, sizes, d, coords=coords, coupling=coupling,
                gamma=gamma, compact=compact)
    return d


@pytest.mark.parametrize("compact", [False, True])
def test_single_route_algebraic_float64(tmp_path, monkeypatch, system3d1d,
                                        compact):
    from tpuamg.problems.solve import SolveReport
    calls = []

    def spy(A, b, precond, sizes, **kw):
        calls.append((A, b, precond, sizes, kw))
        return SolveReport(x=np.zeros(len(b)), niters=0, converged=True,
                           cond=1.0, r_norm=0.0, t_setup=0.0, t_solve=0.0,
                           residuals=np.zeros(1))

    monkeypatch.setattr(run_solver_3d1d, "solve_system", spy)
    d = _dump(tmp_path, system3d1d, compact)
    run_solver_3d1d.main(["-infile", DAT, "-indir", d,
                          "-outdir", str(tmp_path / "out")])
    (A, b, precond, sizes, kw), = calls
    A0, b0, sizes0 = system3d1d[:3]
    assert precond == "metric_hazmath"
    assert tuple(sizes) == tuple(sizes0)
    np.testing.assert_array_equal(A.toarray(), A0.toarray())
    assert kw["dtype"] == jnp.float64
    assert kw["params"].schwarz_cluster
    assert kw["tol"] == 1e-6 and kw["method"] == "cg"
    # no structured / grid / host-tail / refinement route is taken
    for key in ("grid", "structured_coords", "coupling", "host_tail",
                "refine", "krylov_dtype", "chunk"):
        assert key not in kw, key
    np.testing.assert_array_equal(kw["idofs"],
                                  np.arange(sizes0[0], sum(sizes0)))


def test_both_layouts_solve_identically(tmp_path, system3d1d):
    A, b = system3d1d[:2]
    xs = []
    for compact in (False, True):
        d = _dump(tmp_path, system3d1d, compact)
        out = str(tmp_path / f"out_{compact}")
        rep = run_solver_3d1d.main(["-infile", DAT, "-indir", d,
                                    "-outdir", out])
        assert rep.converged
        rel = np.linalg.norm(b - A.matvec(rep.x)) / np.linalg.norm(b)
        assert rel <= 1e-6, rel
        xs.append(read_solution(out))
    np.testing.assert_array_equal(xs[0], xs[1])


def test_missing_input_is_reported(tmp_path):
    with pytest.raises(FileNotFoundError):
        run_solver_3d1d.main(["-infile", DAT, "-indir",
                              str(tmp_path / "absent"),
                              "-outdir", str(tmp_path / "out")])
