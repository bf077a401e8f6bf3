"""Compare structured slot orderings on the 3D-1D system: PCG iterations
across a gamma sweep + DIA band counts per level.

  JAX_PLATFORMS=cpu \
    python scripts/sweep_3d1d_orders.py [n] [orders...]
"""
import sys
import numpy as np

import jax
jax.config.update("jax_enable_x64", True)

from tpuamg.fem import unit_cube_mesh
from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
from tpuamg.problems.solve import solve_system
from tpuamg.config import AMGParameters


def system(gamma, n):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=16, n_branches=2)
    A, b, sizes = get_system(mesh3d, curve, k3=3.0, k1=7.0 * np.pi * 0.04,
                             gamma=gamma * 2 * np.pi * 0.2,
                             coupling_radius=0.2)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    return A, b, sizes, coords


def dia_widths(A, coords, order, idofs, prm):
    from tpuamg.amg.structured import setup_structured
    prec, _, _ = setup_structured(A, coords, prm, dtype=np.float64,
                                  idofs=idofs, order=order)
    out = []
    for L in prec.levels:
        D = getattr(L.A, "dia", L.A)
        out.append(len(getattr(D, "offsets", [])))
    return out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    orders = sys.argv[2:] or ["morton", "hem", "hem_banded:32",
                              "hem_banded:64", "hem_banded:128"]
    gammas = [1e0, 1e2, 1e4, 1e6, 1e8, 1e10]
    prm = AMGParameters(cycle_type="v", dtype="float64", schwarz_levels=2)
    for order in orders:
        iters = []
        for g in gammas:
            A, b, sizes, coords = system(g, n)
            n3, n1 = sizes
            idofs = np.arange(n3, n3 + n1)
            rep = solve_system(A, b, "metric_mono", sizes, params=prm,
                               tol=1e-8, maxiter=200,
                               structured_coords=coords, idofs=idofs,
                               structured_order=order)
            iters.append(rep.niters if rep.converged else -rep.niters)
        A, b, sizes, coords = system(1e6, n)
        idofs = np.arange(sizes[0], sizes[0] + sizes[1])
        w = dia_widths(A, coords, order, idofs, prm)
        print(f"{order:18s} iters={iters} dia_widths={w}", flush=True)


if __name__ == "__main__":
    main()
