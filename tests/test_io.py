"""IO-layer tests: dump/load round trip, .dat parsing, tables, VTU."""
import os

import numpy as np
import pytest

from tpuamg.sparse import HostCSR
from tpuamg.io_utils import (dump_system, load_system, write_solution,
                             read_solution, parse_dat_file,
                             dat_to_amg_parameters, tabulate_simple,
                             ResultWriter, print_red)


@pytest.mark.parametrize("compact", [False, True])
def test_dump_load_roundtrip(tmp_path, compact):
    rng = np.random.default_rng(1)
    n = 30
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    A = HostCSR.from_dense(d)
    b = rng.standard_normal(n)
    dump_system(A, b, (18, 12), str(tmp_path), compact=compact)
    A2, b2, idofs, idofs3d = load_system(str(tmp_path))
    np.testing.assert_allclose(A2.toarray(), A.toarray())
    np.testing.assert_allclose(b2, b)
    assert idofs.tolist() == list(range(18, 30))
    assert idofs3d.tolist() == list(range(18))
    expect = {"A.npz", "vectors.npz"} if compact else \
        {"A.npy", "b.npy", "idofs.npy", "idofs3d.npy"}
    assert set(os.listdir(tmp_path)) == expect


def test_compact_and_reference_layouts_load_identically(tmp_path):
    """Both layouts yield the identical HostCSR (same planes, same
    dtypes), and the compact A stores int32 column indices."""
    from tpuamg.io_utils import load_coupling
    rng = np.random.default_rng(2)
    n3, n1 = 40, 8
    n = n3 + n1
    d = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    A = HostCSR.from_dense(d + d.T + n * np.eye(n))
    Pi = HostCSR.from_dense(rng.random((n1, n3)) * (rng.random((n1, n3))
                                                    < 0.3))
    Mq = HostCSR.from_dense(np.diag(rng.random(n1) + 1.0))
    coords = rng.random((n, 3))
    b = rng.standard_normal(n)
    out = {}
    for compact in (False, True):
        folder = str(tmp_path / str(compact))
        dump_system(A, b, (n3, n1), folder, coords=coords,
                    coupling=(Pi, Mq), gamma=1e8, compact=compact)
        out[compact] = (load_system(folder, with_coords=True),
                        load_coupling(folder))
    (sys_r, cpl_r), (sys_c, cpl_c) = out[False], out[True]
    for X, Y in ((sys_r[0], sys_c[0]), (cpl_r[1], cpl_c[1]),
                 (cpl_r[2], cpl_c[2])):
        assert X.shape == Y.shape
        for f in ("indptr", "indices", "data"):
            u, v = getattr(X, f), getattr(Y, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f
    for u, v in zip(sys_r[1:], sys_c[1:]):
        assert np.array_equal(u, v)
    assert cpl_r[0] == cpl_c[0] == 1e8
    with np.load(str(tmp_path / "True" / "A.npz")) as z:
        assert z["indices"].dtype == np.int32


def test_solution_roundtrip(tmp_path):
    x = np.linspace(-1, 1, 17)
    write_solution(str(tmp_path), x)
    np.testing.assert_allclose(read_solution(str(tmp_path)), x)


def test_dat_parser():
    amg, sol = dat_to_amg_parameters("tpuamg/problems/input_metric.dat")
    assert amg.amg_type == "ua"    # MUA: the robust xd-1D default
    assert amg.cycle_type == "v"
    assert amg.aggregation_type == "hem"
    assert amg.schwarz_levels == 1
    assert amg.schwarz_maxlvl == 2
    assert amg.schwarz_mmsize == 500
    assert amg.schwarz_type == "symmetric"
    assert sol.method == "cg"
    assert sol.tolerance == 1e-6
    assert sol.maxiter == 1000


REFERENCE_DAT = os.path.join(os.path.dirname(__file__), "data",
                             "reference_input_metric.dat")


def test_reference_dat_file_parses():
    """Our parser must read a file in the reference's own layout."""
    raw = parse_dat_file(REFERENCE_DAT)
    assert raw["linear_itsolver_type"] == 1
    assert raw["AMG_type"] == "SA"
    amg, sol = dat_to_amg_parameters(REFERENCE_DAT)
    assert amg.amg_type == "sa" and sol.tolerance == 1e-6
    assert amg.aggregation_type == "hec" and sol.method == "cg"


def test_tabulate_and_writer(tmp_path, capsys):
    t = tabulate_simple([(1, 2.5), (10, 0.125)], ["a", "b"])
    assert "a" in t and "0.125" in t
    w = ResultWriter(str(tmp_path / "r.txt"), ["x", "y"])
    w.write_row((1, 2))
    w.write_row((3, 4))
    lines = (tmp_path / "r.txt").read_text().strip().splitlines()
    assert lines == ["x y", "1 2", "3 4"]
    assert print_red("hello") is not None


def test_vtu_writer(tmp_path):
    from tpuamg.fem import unit_square_mesh
    from tpuamg.io_utils.vtk import write_vtu, write_pvd
    m = unit_square_mesh(3)
    p = write_vtu(str(tmp_path / "u.vtu"), m, np.ones(m.num_vertices))
    txt = open(p).read()
    assert "UnstructuredGrid" in txt and "connectivity" in txt
    pvd = write_pvd(str(tmp_path / "u.pvd"), ["u.vtu"])
    assert "Collection" in open(pvd).read()


def test_coupling_dump_roundtrip(tmp_path):
    """Pi/Mq metric-factor dump extension: A == AD + gamma R^T Mq R."""
    import numpy as np
    from tpuamg.fem import unit_cube_mesh
    from tpuamg.problems.emi_3d1d import (synthetic_neuron_curve,
                                          get_system)
    from tpuamg.io_utils import dump_system, load_system, load_coupling
    mesh3d = unit_cube_mesh(5)
    curve = synthetic_neuron_curve(n_main=8, n_branches=1)
    gamma = 1e4
    A, b, sizes, (Pi, Mq) = get_system(mesh3d, curve, gamma=gamma,
                                       coupling_radius=0.2,
                                       return_coupling=True)
    d = str(tmp_path / "d")
    dump_system(A, b, sizes, d, coupling=(Pi, Mq), gamma=gamma)
    A2, b2, idofs, idofs3d = load_system(d)
    g2, Pi2, Mq2 = load_coupling(d)
    assert g2 == gamma
    n3, n1 = sizes
    # rebuild gamma * R^T Mq R from the loaded factors and check that
    # A - (that) has no dependence on gamma in the coupling block
    R = np.zeros((n1, n3 + n1))
    R[:, :n3] = -Pi2.toarray()
    R[:, n3:] = np.eye(n1)
    M = R.T @ Mq2.toarray() @ R
    AD = A2.toarray() - g2 * M
    # AD must be block diagonal (no 3d-1d coupling left)
    assert np.abs(AD[:n3, n3:]).max() < 1e-8 * np.abs(A2.toarray()).max()
