"""Time the native C++ tail executor vs the jax-CPU tail at production
scale (the n=64 3D-1D dump, 383k dofs).

Run CPU-only:
  JAX_PLATFORMS=cpu \
      python scripts/bench_native_tail.py [-indir data/prod3d1d_g1] [-jax]
"""
import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-indir", default="data/prod3d1d_g1")
    ap.add_argument("-jax", action="store_true",
                    help="also time the jax-CPU fallback (slow: one "
                    "apply is ~30 s + a multi-minute first compile)")
    ap.add_argument("-reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tpuamg
    tpuamg.enable_compilation_cache()
    from dataclasses import replace
    from tpuamg.io_utils import load_system, dat_to_amg_parameters
    from tpuamg.amg.structured import setup_structured

    amg_params, _ = dat_to_amg_parameters(
        "tpuamg/problems/input_metric.dat")
    amg_params = replace(amg_params, schwarz_cluster=True,
                         gs_max_colors=6, dtype="float64")
    A, b, idofs, idofs3d, coords = load_system(args.indir,
                                               with_coords=True)
    print(f"n={A.shape[0]} nnz={A.nnz} n1={len(idofs)}", flush=True)
    t0 = time.time()
    prec, slots, nsl = setup_structured(
        A, coords, amg_params, dtype=jnp.float64, idofs=idofs,
        algebraic_below=10 ** 9, host_tail=True,
        order="auto")
    print(f"setup {time.time() - t0:.1f}s  native={prec.native is not None}",
          flush=True)
    lvl_sizes = [L.A.shape[0] for L in prec.tail.levels]
    print(f"tail levels: {lvl_sizes} + coarse "
          f"{np.asarray(prec.tail.coarse_inv).shape[0]}", flush=True)

    rng = np.random.default_rng(0)
    rc = rng.standard_normal(prec.nc)

    ec_nat = None
    if prec.native is not None:
        ec_nat = prec.native.apply(rc)          # warm
        t0 = time.time()
        for _ in range(args.reps):
            prec.native.apply(rc)
        t_nat = (time.time() - t0) / args.reps
        print(f"native tail apply: {t_nat * 1e3:.1f} ms", flush=True)

    if args.jax:
        nat = prec.native
        prec.native = None
        t0 = time.time()
        ec_jax = prec.tail_apply(rc)            # compile + first apply
        print(f"jax first apply (incl compile): {time.time() - t0:.1f}s",
              flush=True)
        t0 = time.time()
        ec_jax = prec.tail_apply(rc)
        t_jax = time.time() - t0
        print(f"jax tail apply: {t_jax:.2f} s", flush=True)
        prec.native = nat
        if ec_nat is not None:
            rel = np.linalg.norm(ec_nat - ec_jax) / np.linalg.norm(ec_jax)
            print(f"native-vs-jax rel diff: {rel:.3e}", flush=True)
            print(f"speedup: {t_jax / t_nat:.1f}x", flush=True)


if __name__ == "__main__":
    main()
