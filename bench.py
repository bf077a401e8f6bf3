"""On-card run of the bidomain 2D grid path through solve_system.

Bidomain 2D (n cells per side, 2*(n+1)^2 dofs), gamma=1e6, the
metric_mono preconditioner on the gather-free grid path, float64 PCG to
the reference's 1e-8 tolerance.  Prints one JSON line with the iteration
count, the true relative residual (recomputed on the host in float64),
assembly / setup / first-solve (compile included) / warm-solve seconds,
and the device: platform, device_kind, device count and the card's name
and power limit.  Exits non-zero when JAX finds no GPU.

    python bench.py [--n 512] [--gamma 1e6]
"""
import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--gamma", type=float, default=1e6)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tpuamg
    from tpuamg.gpu import require_gpu, card_lines, device_summary
    devices = require_gpu()
    tpuamg.enable_compilation_cache()
    from tpuamg.config import PRESETS
    from tpuamg.fem import mms
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    from tpuamg.problems.solve import solve_system

    n = args.n
    t0 = time.time()
    params = Params(2.0, 3.0, args.gamma)
    data = mms.setup_bidomain_mms(params, dim=2)
    A, b, sizes, _ = get_system(get_mesh(n, 2), data, params)
    t_asm = time.time() - t0
    t0 = time.time()
    first = solve_system(A, b, "metric_mono", sizes,
                         params=PRESETS["metric_schwarz"], tol=1e-8,
                         maxiter=500, dtype=jnp.float64,
                         grid=((n + 1, n + 1), 2))
    t_first = time.time() - t0 - first.t_setup
    warm = solve_system(A, b, "metric_mono", sizes,
                        params=PRESETS["metric_schwarz"], tol=1e-8,
                        maxiter=500, dtype=jnp.float64,
                        grid=((n + 1, n + 1), 2))
    rel = float(np.linalg.norm(b - A.matvec(warm.x)) / np.linalg.norm(b))
    print(json.dumps({
        "workload": f"bidomain2d_n{n}_gamma{args.gamma:g}_grid_f64",
        "ndofs": int(sum(sizes)), "nnz": int(A.nnz),
        "niters": int(warm.niters), "converged": bool(warm.converged),
        "true_rel_residual": rel,
        "t_assembly_s": t_asm, "t_setup_s": warm.t_setup,
        "t_first_solve_s": t_first, "t_solve_s": warm.t_solve,
        "device": device_summary(devices), "cards": card_lines()}))


if __name__ == "__main__":
    main()
