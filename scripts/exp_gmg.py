"""GMG h-robustness experiments.

The committed bidomain_2d_firedrake tables grow 9->33 iters over 5
refinements (F-cycle + Chebyshev on the window-UA grid hierarchy).  The
reference's full-MG + PatchPC + Richardson(1/3) is h-robust
(/root/reference/src/bidomain_2d_firedrake.py:106-125).  Piecewise-
constant (UA) window transfers are NOT h-robust under V/F cycles —
compare cycle/smoother variants to find the h-robust config.

  JAX_PLATFORMS=cpu \
      python scripts/exp_gmg.py [nrefs] [gamma] [variant...]
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
from tpuamg.problems.bidomain import Params
from tpuamg.problems.bidomain_2d_gmg import get_system_strip
from tpuamg.problems.solve import solve_system
from tpuamg.config import PRESETS


def run(tag, nrefs, gamma, **kw):
    params = Params(2.0, 3.0, gamma)
    data = mms.setup_bidomain_strip_mms(params, width=0.125)
    iters, conds = [], []
    n = 8
    t0 = time.time()
    for _ in range(nrefs):
        n *= 2
        mesh = tagged_unit_square(n)
        A, b, sizes = get_system_strip(mesh, data, params, 0.125)
        rep = solve_system(A, b, "metric_mono", sizes, tol=1e-10,
                           maxiter=200, grid=((n + 1, n + 1), 2), **kw)
        iters.append(rep.niters if rep.converged else -rep.niters)
        conds.append(round(rep.cond, 1))
    print(f"{tag:34s} iters={iters} cond={conds}"
          f"  ({time.time()-t0:.0f}s)", flush=True)


def main():
    nrefs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    gamma = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    which = set(sys.argv[3:]) or {"fmg_v", "w", "fmg_w", "amli"}
    base = PRESETS["metric_mono_default"]
    if "fmg_v" in which:      # the committed (non-h-robust) config
        run("fmg (V inner)", nrefs, gamma,
            params=replace(base, cycle_type="fmg"))
    if "v" in which:
        run("v", nrefs, gamma, params=replace(base, cycle_type="v"))
    if "w" in which:
        run("w", nrefs, gamma,
            params=replace(base, cycle_type="w", max_w_work=1024))
    if "fmg_w" in which:
        run("fmg (W inner)", nrefs, gamma,
            params=replace(base, cycle_type="fmg_w", max_w_work=1024))
    if "amli" in which:
        run("amli deg3", nrefs, gamma,
            params=replace(base, cycle_type="amli", max_w_work=1024))
    if "amli2" in which:
        run("amli deg2", nrefs, gamma,
            params=replace(base, cycle_type="amli", amli_degree=2,
                           max_w_work=1024))
    if "nl_amli" in which:
        run("nl_amli deg3", nrefs, gamma,
            params=replace(base, cycle_type="nl_amli", max_w_work=1024))


if __name__ == "__main__":
    main()
