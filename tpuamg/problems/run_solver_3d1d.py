"""Offline xd-1D solver CLI.

Rebuild of /root/reference/src/run_solver_3d1d.py +
``haznics.fenics_metric_solver_xd_1d`` (the all-native pipeline the shim
wraps, SURVEY.md §3.4): parse a HAZmath-style ``.dat`` config, load the
dumped system (the reference's COO ``A.npy`` layout or the compact
``A.npz`` form, io_utils.dump), solve with metric-AMG-preconditioned
Krylov on the algebraic ELL path in float64 as one jitted XLA program, and
write ``solution.txt`` (length-prefixed).

Usage:
    python -m tpuamg.problems.run_solver_3d1d -infile INPUT.dat \
        -indir DATA_DIR -outdir OUT_DIR
"""
from __future__ import annotations

import argparse
import os

from ..io_utils import (print_red, load_system, write_solution,
                        dat_to_amg_parameters)
from .solve import solve_system


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-infile", type=str,
                        default="./tpuamg/problems/input_metric.dat",
                        help="Solver input file")
    parser.add_argument("-indir", type=str, default="./data/emi_3d1d/",
                        help="Directory with the dumped system")
    parser.add_argument("-outdir", type=str, default="./results/emi_3d1d/",
                        help="Directory to output solution")
    args, _ = parser.parse_known_args(argv)

    print_red("Path to solver input file: " + args.infile)
    print_red("Path to matrices directory: " + args.indir)
    print_red("Path to output directory: " + args.outdir)

    if not os.path.exists(args.infile):
        raise FileNotFoundError(args.infile)
    if not os.path.isdir(args.indir):
        raise FileNotFoundError(args.indir)
    os.makedirs(args.outdir, exist_ok=True)

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    import tpuamg
    tpuamg.enable_compilation_cache()

    amg_params, solver_cfg = dat_to_amg_parameters(args.infile)
    A, b, idofs, idofs3d = load_system(args.indir)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    from dataclasses import replace
    # Clustered footprint Schwarz: at production curve densities the
    # reference's seed-per-interface-dof blocks overlap ~40 deep and
    # nearly coincide — 10k x ~400^2 dense inverses (hours of setup)
    # that ALSO smooth worse (stale-residual sweeps over the same
    # gamma-chain).  Merging overlapping blocks
    # (smoothers.schwarz_setup.merge_overlapping_blocks) gives ~16x
    # fewer blocks, seconds of setup, and converges where the per-seed
    # layout h-degrades (24 iterations at n=16 production density,
    # gamma=1e8).
    amg_params = replace(amg_params, schwarz_cluster=True)
    rep = solve_system(A, b, "metric_hazmath", sizes, idofs=idofs,
                       params=amg_params, tol=solver_cfg.tolerance,
                       maxiter=solver_cfg.maxiter,
                       method=solver_cfg.method,
                       stop_type=solver_cfg.stop_type,
                       dtype=jnp.float64)
    print_red(f"niters={rep.niters} converged={rep.converged} "
              f"setup={rep.t_setup:.2f}s solve={rep.t_solve:.2f}s")
    path = write_solution(args.outdir, rep.x)
    print_red(f"Solution written to {path}")
    return rep


if __name__ == "__main__":
    main()
