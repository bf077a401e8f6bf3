"""3D-1D gamma-robustness experiments: which hierarchy makes iterations
O(1) in gamma?  Compares algebraic variants (UA vs SA, V vs AMLI) and the
structured hierarchy with algebraic tails at several thresholds.

  JAX_PLATFORMS=cpu \
      python scripts/exp_3d1d_tail.py [n] [which...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import resource
resource.setrlimit(resource.RLIMIT_STACK,
                   (resource.RLIM_INFINITY, resource.RLIM_INFINITY))

import numpy as np
import jax
jax.config.update("jax_enable_x64", True)

from tpuamg.fem import unit_cube_mesh
from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
from tpuamg.problems.solve import solve_system
from tpuamg.config import AMGParameters

GAMMAS = [1e0, 1e2, 1e4, 1e6, 1e8, 1e10]


def system(gamma, n, coupling=False):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=16, n_branches=2)
    out = get_system(mesh3d, curve, k3=3.0, k1=7.0 * np.pi * 0.04,
                     gamma=gamma * 2 * np.pi * 0.2,
                     coupling_radius=0.2, return_coupling=coupling)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    if coupling:
        A, b, sizes, (Pi, Mq) = out
        return A, b, sizes, coords, (gamma * 2 * np.pi * 0.2, Pi, Mq)
    A, b, sizes = out
    return A, b, sizes, coords


def run(tag, n, with_coupling=False, **kw):
    iters, conds = [], []
    t0 = time.time()
    for g in GAMMAS:
        if with_coupling:
            A, b, sizes, coords, coup = system(g, n, coupling=True)
            kw["coupling"] = coup
        else:
            A, b, sizes, coords = system(g, n)
        n3, n1 = sizes
        idofs = np.arange(n3, n3 + n1)
        rep = solve_system(A, b, "metric_mono", sizes, tol=1e-8,
                           maxiter=200, idofs=idofs, **kw)
        iters.append(rep.niters if rep.converged else -rep.niters)
        conds.append(round(rep.cond, 1))
    print(f"{tag:28s} iters={iters} cond={conds}"
          f"  ({time.time()-t0:.0f}s)", flush=True)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    which = set(sys.argv[2:]) or {"ua_v", "sa_v", "ua_amli", "sa_amli",
                                  "hyb"}
    base = dict(cycle_type="v", dtype="float64", schwarz_levels=2)
    if "ua_v" in which:
        run("alg ua v", n, params=AMGParameters(**base))
    if any(w.startswith("dat_") for w in which):
        # the input_metric.dat config (HEM aggregation, V cycle,
        # Schwarz_levels=1 maxlvl=2 mmsize=500, strong_coupled=0) with
        # the complement smoother swapped GS <-> masked Chebyshev
        from tpuamg.io_utils import dat_to_amg_parameters
        datp, _cfg = dat_to_amg_parameters(
            "tpuamg/problems/input_metric.dat")
        from dataclasses import replace as _rep
        if "dat_gs" in which:
            run("dat gs (reference cfg)", n, params=datp)
        if "dat_cheb" in which:
            run("dat cheb", n,
                params=_rep(datp, smoother="chebyshev"))
        for mc in (4, 6, 8):
            if f"dat_gs{mc}" in which:
                run(f"dat gs maxcolors={mc}", n,
                    params=_rep(datp, gs_max_colors=mc))
    if "cheb" in which:
        # multicolor GS costs ~2 gather+scatter ops per COLOR per
        # sweep; Chebyshev is
        # gather-only (1 SpMV per residual).  Does gamma-flatness
        # survive the swap on the metric path?
        run("alg ua w cheb", n, params=AMGParameters(
            **{**base, "cycle_type": "w", "smoother": "chebyshev"}))
    if "l1j" in which:
        run("alg ua w l1jac", n, params=AMGParameters(
            **{**base, "cycle_type": "w", "smoother": "l1_jacobi"}))
    if "sgs_w" in which:
        run("alg ua w sgs", n, params=AMGParameters(
            **{**base, "cycle_type": "w"}))
    if "hyb_cheb" in which:
        A, b, sizes, coords = system(1.0, n)
        run("struct+alg<60000 cheb", n, params=AMGParameters(
            **{**base, "cycle_type": "w", "smoother": "chebyshev"}),
            structured_coords=coords,
            algebraic_below=60000)
    if "hyb_sgs" in which:
        A, b, sizes, coords = system(1.0, n)
        run("struct+alg<60000 sgs", n, params=AMGParameters(
            **{**base, "cycle_type": "w"}),
            structured_coords=coords,
            algebraic_below=60000)
    if "sa_v" in which:
        run("alg sa v", n, params=AMGParameters(amg_type="sa", **base))
    if "ua_amli" in which:
        run("alg ua amli3", n, params=AMGParameters(
            **{**base, "cycle_type": "amli"}))
    if "sa_amli" in which:
        run("alg sa amli3", n, params=AMGParameters(
            amg_type="sa", **{**base, "cycle_type": "amli"}))
    if "hyb" in which:
        for ab in (300, 700):
            A, b, sizes, coords = system(1.0, n)
            run(f"struct+alg_ua<{ab}", n, params=AMGParameters(**base),
                structured_coords=coords,
                algebraic_below=ab)
    if "exact_fp" in which:
        A, b, sizes, coords = system(1.0, n)
        run("struct fp=exact", n, params=AMGParameters(**base),
            structured_coords=coords)
    if "deflate" in which:
        A, b, sizes, coords = system(1.0, n)
        run("struct fp=deflate", n, with_coupling=True,
            params=AMGParameters(**base),
            structured_coords=coords, fp_solver="deflate")
    if "rank1g" in which:
        A, b, sizes, coords = system(1.0, n)
        run("struct fp=rank1g", n, with_coupling=True,
            params=AMGParameters(**base),
            structured_coords=coords, fp_solver="rank1g")


if __name__ == "__main__":
    main()
