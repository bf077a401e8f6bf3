"""Standard-AMG ('hazmath' preset) h-robustness at gamma=1
(measured 18->46 iters, cond 4.5->33.5 over 5
refinements — HAZmath's UA W-cycle + SGS is essentially h-robust).

Suspects: max_w_work=64 degrading deep levels to V (config.py:47), and
VMB aggregate quality.  Compare variants at increasing nrefs.

  JAX_PLATFORMS=cpu \
      python scripts/exp_std_amg.py [nrefs] [variant...]
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
from tpuamg.fem import mms, tagged_unit_square
from tpuamg.problems.bidomain import Params, get_system
from tpuamg.problems.solve import solve_system
from tpuamg.config import PRESETS


def run(tag, nrefs, gamma=1.0, **kw):
    params = Params(2.0, 3.0, gamma)
    data = mms.setup_bidomain_mms(params, dim=2)
    iters, conds = [], []
    n = 16
    t0 = time.time()
    for _ in range(nrefs):
        n *= 2
        mesh = tagged_unit_square(n)
        A, b, sizes, _ = get_system(mesh, data, params)
        rep = solve_system(A, b, "hazmath", sizes, tol=1e-8,
                           maxiter=500, **kw)
        iters.append(rep.niters if rep.converged else -rep.niters)
        conds.append(round(rep.cond, 1))
    print(f"{tag:36s} iters={iters} cond={conds}"
          f"  ({time.time()-t0:.0f}s)", flush=True)


def main():
    nrefs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    which = set(sys.argv[2:]) or {"base", "w1024", "amli", "cd1000"}
    std = PRESETS["standard"]
    if "base" in which:       # the committed (degrading) config
        run("w cap64 (committed)", nrefs, params=std)
    if "w1024" in which:      # full W recursion
        run("w cap1024", nrefs, params=replace(std, max_w_work=1024))
    if "cd1000" in which:     # shallower hierarchy + larger dense coarse
        run("w cap64 coarse1000", nrefs,
            params=replace(std, coarse_dof=1000))
    if "amli" in which:
        run("amli3 cap1024", nrefs,
            params=replace(std, cycle_type="amli", max_w_work=1024))
    if "agg" in which:        # smaller aggregates (better UA quality)
        run("w cap1024 maxagg8", nrefs,
            params=replace(std, max_w_work=1024, max_aggregation=8))
    if "agg20" in which:
        run("w maxagg20", nrefs,
            params=replace(std, max_aggregation=20))
    if "amli2" in which:
        run("amli2 cap1024", nrefs,
            params=replace(std, cycle_type="amli", amli_degree=2,
                           max_w_work=1024))
    if "sa_w" in which:       # smoothed aggregation + W
        run("sa w", nrefs, params=replace(std, amg_type="sa"))
    if "smooth2" in which:    # heavier smoothing
        run("w 2+2 smooth", nrefs,
            params=replace(std, presmooth_iter=2, postsmooth_iter=2))
    if "kcycle" in which:     # AGMG-style K-cycle (nonlinear AMLI deg2)
        # cap64: visits 2^l — full K-recursion to level 6, V below
        # (cap 1024 traces blow LLVM compile memory at nrefs 5)
        run("nl_amli2 cap64", nrefs,
            params=replace(std, cycle_type="nl_amli", amli_degree=2))
    if "amli3c64" in which:
        run("amli3 cap64", nrefs,
            params=replace(std, cycle_type="amli"))
    if "amli2agg" in which:
        run("amli2 maxagg8", nrefs,
            params=replace(std, cycle_type="amli", amli_degree=2,
                           max_w_work=1024, max_aggregation=8))


if __name__ == "__main__":
    main()
