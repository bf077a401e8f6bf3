"""keep_idofs probe: is the gamma=1e8 window-level stall (round 4,
docs/PERF_NOTES.md) a coarse-space property that the metricAMG idofs
contract fixes?

Round-4 measurement: window levels above the algebraic tail STALL at
gamma=1e8 at production curve density (n=16 dump, radius 0.05, curve
finer than bulk) even in full f64 — so run_solver_3d1d defaults to the
FULL host tail.  Hypothesis: the stall is the window aggregation
coarsening the interface dofs u1 together with the bulk, which destroys
the gamma-kernel (Pi u3 = u1) in the window coarse spaces.
keep_idofs=L (amg/structured) passes every interface dof through L
window levels by INJECTION instead.

  JAX_PLATFORMS=cpu \
      python scripts/exp_keep_idofs.py [variant ...]
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

import tpuamg
tpuamg.enable_compilation_cache()

from dataclasses import replace
from tpuamg.io_utils import (load_system, load_coupling,
                             dat_to_amg_parameters)
from tpuamg.problems.solve import solve_system

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAT = os.path.join(ROOT, "tpuamg", "problems", "input_metric.dat")

VARIANTS = {
    # (algebraic_below, keep_idofs, param overrides)
    "full_tail": (10**9, 0, {}),   # the production default — baseline
    "win_nokeep": (3000, 0, {}),   # round-4 stall repro (window levels)
    "win_keep1": (3000, 1, {}),
    "win_keep2": (3000, 2, {}),
    # stronger smoothing on the window levels: does it close the
    # ~2x-iters-per-level gap at gamma=1e8?
    "win_keep1_s2": (3000, 1, dict(presmooth_iter=2, postsmooth_iter=2,
                                   schwarz_maxlvl=3)),
    "win_keep2_s2": (3000, 2, dict(presmooth_iter=2, postsmooth_iter=2,
                                   schwarz_maxlvl=3, schwarz_levels=2)),
    # no Schwarz on the window levels at all (pure DIA + block-Cheb —
    # the cheapest possible device levels): interface smoothing lives
    # entirely in the tail, which the kept idofs reach by injection
    "win_keep1_nos": (3000, 1, dict(schwarz_levels=0)),
    "win_keep2_nos": (3000, 2, dict(schwarz_levels=0)),
}


def run(gdir, gamma, which):
    amg_params, cfg = dat_to_amg_parameters(DAT)
    amg_params = replace(amg_params, schwarz_cluster=True)
    A, b, idofs, idofs3d, coords = load_system(gdir, with_coords=True)
    coupling = load_coupling(gdir)
    sizes = (len(idofs3d), len(b) - len(idofs3d))
    for name in which:
        ab, keep, over = VARIANTS[name]
        prm = replace(amg_params, **over) if over else amg_params
        t0 = time.time()
        rep = solve_system(
            A, b, "metric_hazmath", sizes, idofs=idofs,
            params=prm, tol=cfg.tolerance, maxiter=200,
            method=cfg.method, stop_type=cfg.stop_type,
            structured_coords=coords, coupling=coupling,
            algebraic_below=ab, keep_idofs=keep,
            # host_tail as in production: the unified program inlines
            # the whole algebraic tail into one jitted PCG — a
            # minutes-long LLVM compile that can segfault (CLAUDE.md
            # hazard 9); the split driver keeps the tail a separate
            # small CPU program
            host_tail=True,
            structured_order="auto")
        print(f"g={gamma:<12} {name:12s} iters="
              f"{rep.niters if rep.converged else -rep.niters:4d} "
              f"cond={rep.cond:8.1f} rel={rep.r_norm:.1e} "
              f"setup={rep.t_setup:.0f}s wall={time.time()-t0:.0f}s",
              flush=True)


def main():
    which = sys.argv[1:] or list(VARIANTS)
    for g in ("100000000", "1"):
        d = os.path.join(ROOT, "results", "scale_3d1d",
                         f"data_n16_g{g}")
        if not os.path.isdir(d):
            print(f"missing dump {d}", flush=True)
            continue
        run(d, g, which)


if __name__ == "__main__":
    main()
