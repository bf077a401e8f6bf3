"""3D-1D h-robustness experiment.

The committed sweeps show iteration growth with refinement (12 -> 11-17
-> 20-28 over mesh_n=8/16/32, ~1.65x per refinement) on the algebraic
metric path.  Suspects, by analogy with the bidomain 'hazmath'
h-degradation fixed in round 3 (scripts/exp_std_amg.py): the
piecewise-constant UA coarse space under a plain V-cycle.  This sweeps
cycle/scaling variants over mesh_n x gamma to isolate the cause:

  JAX_PLATFORMS=cpu \
      python scripts/exp_3d1d_hrobust.py [variant ...]

Variants: dat (the input_metric.dat config: V, coarse_scaling OFF),
cs (V + coarse_scaling ON), amli2 (NL-AMLI(2) + coarse_scaling),
w (W-cycle), maxlvl3 (dat + Schwarz_maxlvl=3).
"""
import sys
import time
from dataclasses import replace

import numpy as np

sys.path.insert(0, ".")

VARIANTS = {
    "dat":     dict(),
    "cs":      dict(coarse_scaling=True),
    "amli2":   dict(cycle_type="nl_amli", amli_degree=2,
                    coarse_scaling=True),
    "w":       dict(cycle_type="w"),
    "maxlvl3": dict(schwarz_maxlvl=3),
    # footprint-truncation suspects: the .dat caps Schwarz blocks at
    # mmsize=500 while the curve footprint grows ~(r/h)^2 per
    # refinement (~103 direct members at n=32, ~10x that at maxlvl=2)
    "mm":      dict(schwarz_mmsize=100000),
    "ml1":     dict(schwarz_maxlvl=1),
    "mm_amli2": dict(schwarz_mmsize=100000, cycle_type="nl_amli",
                     amli_degree=2, coarse_scaling=True),
    # merged overlapping footprint blocks (schwarz_cluster): the
    # overlap-depth cure — see smoothers.schwarz_setup.
    "clu":     dict(schwarz_cluster=True),
    "clu_mm":  dict(schwarz_cluster=True, schwarz_mmsize=2000),
    # round-5 gamma=1 h-growth suspects (6->11->18 UNCURED by cs /
    # nl_amli / clustering / mmsize, PERF_NOTES round 4): at gamma=1
    # the system is nearly decoupled Poisson, where piecewise-constant
    # UA under a V-cycle is KNOWN non-optimal — W-cycle and smoothed
    # aggregation are the textbook cures the prior sweeps never tried
    # at this gamma.
    "w_clu":   dict(cycle_type="w", schwarz_cluster=True),
    "sa_clu":  dict(amg_type="sa", schwarz_cluster=True),
    "sa_amli": dict(amg_type="sa", cycle_type="nl_amli", amli_degree=2,
                    schwarz_cluster=True),
}

MESH_NS = [8, 16, 32]
GAMMAS = [1.0, 1e8]


def system(mesh_n, gamma):
    from tpuamg.fem import unit_cube_mesh
    from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
    # scale the synthetic neuron with the bulk like exp_3d1d_scale.py
    n_main = 40 * mesh_n // 8
    mesh3d = unit_cube_mesh(mesh_n)
    curve = synthetic_neuron_curve(n_main=n_main, n_branches=8, nseg=4)
    radius = 0.2
    A, b, sizes = get_system(mesh3d, curve, k3=3.0,
                             k1=7.0 * np.pi * radius ** 2,
                             gamma=gamma * 2 * np.pi * radius,
                             coupling_radius=radius)
    return A, b, sizes


def run_cell(name, mesh_n, gamma):
    import jax
    jax.config.update("jax_enable_x64", True)
    import tpuamg
    tpuamg.enable_compilation_cache()
    from tpuamg.problems.solve import solve_system
    from tpuamg.io_utils import dat_to_amg_parameters

    base, solver_cfg = dat_to_amg_parameters(
        "tpuamg/problems/input_metric.dat")
    A, b, sizes = system(mesh_n, gamma)
    n3 = sizes[0]
    idofs = np.arange(n3, A.shape[0])
    prm = replace(base, **VARIANTS[name])
    t0 = time.time()
    rep = solve_system(A, b, "metric_hazmath", sizes,
                       idofs=idofs, params=prm,
                       tol=solver_cfg.tolerance,
                       maxiter=solver_cfg.maxiter,
                       stop_type=solver_cfg.stop_type)
    print("CELL", name, mesh_n, A.shape[0], f"{gamma:.0e}",
          rep.niters, f"{rep.cond:.1f}",
          "T" if rep.converged else "F",
          f"{time.time()-t0:.0f}s", flush=True)


def main(variants):
    # each cell in a FRESH interpreter: one process over the full grid
    # accumulates XLA/LLVM compile state and segfaults (the same
    # failure mode scripts/run_tests.sh batches around)
    import subprocess
    for mesh_n in MESH_NS:
        for gamma in GAMMAS:
            for name in variants:
                res = subprocess.run(
                    [sys.executable, __file__, "--cell", name,
                     str(mesh_n), str(gamma)],
                    capture_output=True, text=True, timeout=3600)
                for ln in res.stdout.splitlines():
                    if ln.startswith("CELL"):
                        print(ln[5:], flush=True)
                if res.returncode != 0:
                    print(f"{name} {mesh_n} {gamma}: rc={res.returncode}",
                          res.stderr[-300:], flush=True)
    print("\nvariant mesh_n ndof gamma niters cond conv wall")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cell"]:
        run_cell(sys.argv[2], int(sys.argv[3]), float(sys.argv[4]))
    else:
        main(sys.argv[1:] or ["dat", "cs", "amli2"])
