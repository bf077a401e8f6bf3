"""Native C++ tail executor (native/tailkit.cpp) parity vs the jax tail.

The production host tail (amg.structured.HostTailHybrid) runs the entire
metric-AMG V-cycle; the native executor must be the SAME preconditioner
up to f64 summation-order noise, for every smoother configuration the
.dat metric config can produce."""
import numpy as np
import jax.numpy as jnp
import pytest

from tpuamg.fem import unit_cube_mesh
from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
from tpuamg.amg import setup_amg
from tpuamg.config import AMGParameters
from tpuamg.native.tail import build_native_tail


def _system(gamma=1e8, n=5, n_main=12, n_branches=2):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=n_main, n_branches=n_branches)
    A, b, sizes = get_system(mesh3d, curve, k3=3.0,
                             k1=7.0 * np.pi * 0.04,
                             gamma=gamma * 2 * np.pi * 0.2,
                             coupling_radius=0.2)
    n3, n1 = sizes
    idofs = np.arange(n3, n3 + n1)
    return A, b, idofs


def _parity(prec, rtol=1e-7, seeds=(0, 1)):
    # rtol: f64 summation-order differences (CSR row sums vs padded-ELL
    # reductions, ragged vs padded block matvecs) amplified by the
    # gamma-conditioning of the metric rows — NOT a semantic gap; a
    # wrong sweep order or block would show O(1) error.
    nat = build_native_tail(prec)
    assert nat is not None, "native tail should cover this configuration"
    n = prec.levels[0].A.shape[0] if prec.levels else \
        prec.coarse_inv.shape[0]
    for s in seeds:
        rng = np.random.default_rng(s)
        r = rng.standard_normal(n)
        ec_jax = np.asarray(prec.matvec(jnp.asarray(r)))
        ec_nat = nat.apply(r)
        scale = np.linalg.norm(ec_jax)
        assert np.linalg.norm(ec_nat - ec_jax) <= rtol * scale, \
            (s, np.linalg.norm(ec_nat - ec_jax) / scale)


# the .dat metric-tail configuration: HEM aggregation, interface Schwarz
# on level 0, GS complement/levels, V-cycle, dense coarse
DAT = AMGParameters(amg_type="ua", cycle_type="v", maxit=1,
                    smoother="gs", aggregation_type="hem",
                    strong_coupled=0.0, max_aggregation=20,
                    coarse_dof=60, schwarz_levels=1, schwarz_mmsize=500,
                    schwarz_maxlvl=2, coarse_scaling=False,
                    dtype="float64", gs_max_colors=6)


@pytest.mark.parametrize("gamma", [1e0, 1e8])
def test_metric_tail_parity(gamma):
    A, _, idofs = _system(gamma)
    prec = setup_amg(A, DAT, idofs=idofs)
    _parity(prec)


def test_metric_tail_parity_clustered():
    from dataclasses import replace
    A, _, idofs = _system(1e8)
    prec = setup_amg(A, replace(DAT, schwarz_cluster=True), idofs=idofs)
    _parity(prec)


def test_gs_tail_parity():
    """Plain multicolor-GS levels (no Schwarz) + coarse_scaling."""
    from dataclasses import replace
    A, _, _ = _system(1e2)
    prec = setup_amg(A, replace(DAT, schwarz_levels=0,
                                coarse_scaling=True))
    _parity(prec)


def test_sgs_cheb_jacobi_parity():
    from dataclasses import replace
    A, _, _ = _system(1e0)
    for sm in ("sgs", "chebyshev", "jacobi", "l1_jacobi", "sor"):
        prec = setup_amg(A, replace(DAT, schwarz_levels=0, smoother=sm,
                                    relaxation=1.3))
        _parity(prec)


def test_cheb_complement_parity():
    """Interface Schwarz + masked-Chebyshev complement (the host tail's
    gather-light configuration, smoother='chebyshev' + idofs)."""
    from dataclasses import replace
    A, _, idofs = _system(1e6)
    prec = setup_amg(A, replace(DAT, smoother="chebyshev"), idofs=idofs)
    _parity(prec)


def test_unsupported_returns_none():
    from dataclasses import replace
    A, _, _ = _system(1e0)
    prec = setup_amg(A, replace(DAT, schwarz_levels=0, cycle_type="w"))
    assert build_native_tail(prec) is None


def test_hybrid_uses_native_and_matches_fallback():
    """HostTailHybrid.tail_apply: native path == jax fallback path."""
    from tpuamg.amg.structured import setup_structured
    from dataclasses import replace
    A, _, idofs = _system(1e8)
    mesh3d = unit_cube_mesh(5)
    curve = synthetic_neuron_curve(n_main=12, n_branches=2)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    prm = replace(DAT, schwarz_cluster=True)
    prec, slots, nsl = setup_structured(
        A, coords, prm, dtype=jnp.float64, idofs=idofs, 
        algebraic_below=10 ** 9, host_tail=True)
    assert prec.native is not None
    rng = np.random.default_rng(3)
    rc = rng.standard_normal(prec.nc)
    ec_native = prec.tail_apply(rc)
    prec.native = None
    ec_jax = prec.tail_apply(rc)
    np.testing.assert_allclose(ec_native, ec_jax, rtol=1e-8,
                               atol=1e-9 * np.linalg.norm(ec_jax))
