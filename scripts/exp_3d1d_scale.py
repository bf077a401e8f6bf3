"""Production-scale 3D-1D demo: synthetic neuron at reference scale
(~275k bulk + ~10k curve dofs, /root/reference/src/emi_3d1d.py runs the
real neuron mesh at this order) through the dump -> offline-solve
pipeline.

Phase "dump" (CPU): assemble + dump the system for each gamma.
Phase "solve" (default JAX device): run_solver_3d1d per gamma, one child
process at a time (each holds the device while it runs; this parent never
imports JAX), and write iters/setup/solve to
results/scale_3d1d/summary_n<mesh_n>.txt.

  JAX_PLATFORMS=cpu \
      python scripts/exp_3d1d_scale.py dump [mesh_n] [gamma...]
  python scripts/exp_3d1d_scale.py solve [mesh_n] [gamma...]
"""
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMMAS = ["1", "100000000"]
MESH_N = 64
CURVE = ["-n_main", "2400", "-n_branches", "48", "-nseg", "4"]
ANSI = re.compile(r"\x1b\[[0-9;]*m")


def outdir(mesh_n, g):
    # the n=64 production dumps are COMMITTED at data/prod3d1d_g{g}
    # (275k bulk + 10k curve dofs — git-tracked so the flagship solve
    # is reproducible without the 10-minute assembly)
    committed = os.path.join(ROOT, "data", f"prod3d1d_g{g}")
    if mesh_n == MESH_N and os.path.exists(
            os.path.join(committed, "A.npz")):
        return committed
    return os.path.join(ROOT, "results", "scale_3d1d",
                        f"data_n{mesh_n}_g{g}")


def dump(mesh_n, gammas):
    for g in gammas:
        d = outdir(mesh_n, g)
        if os.path.exists(os.path.join(d, "A.npy")) \
                or os.path.exists(os.path.join(d, "A.npz")):
            print(f"dump g={g}: exists", flush=True)
            continue
        t0 = time.time()
        subprocess.run(
            [sys.executable, "-m", "tpuamg.problems.emi_3d1d",
             "-gamma", g, "-radius", "0.05", "-dump", "1",
             "-outdir", d, "-mesh_n", str(mesh_n)] + CURVE,
            cwd=ROOT, check=True)
        print(f"dump g={g}: {time.time()-t0:.0f}s", flush=True)


def solve(mesh_n, gammas):
    rows = []
    for g in gammas:
        d = outdir(mesh_n, g)
        r = os.path.join(ROOT, "results", "scale_3d1d",
                         f"res_n{mesh_n}_g{g}")
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "tpuamg.problems.run_solver_3d1d",
             "-infile", "tpuamg/problems/input_metric.dat",
             "-indir", d, "-outdir", r],
            cwd=ROOT, capture_output=True, text=True)
        txt = ANSI.sub("", res.stdout + res.stderr)
        os.makedirs(r, exist_ok=True)
        with open(os.path.join(r, "run.log"), "w") as f:
            f.write(txt + f"\nEXIT={res.returncode}\n")
        print(txt[-2000:], flush=True)
        m = re.search(r"niters=(\d+) converged=(\w+) "
                      r"setup=([\d.]+)s solve=([\d.]+)s", txt)
        if m:
            rows.append((g,) + m.groups() + (f"{time.time()-t0:.0f}",))
    if rows:
        path = os.path.join(ROOT, "results", "scale_3d1d",
                            f"summary_n{mesh_n}.txt")
        with open(path, "w") as f:
            f.write(f"# production-scale 3D-1D (mesh_n={mesh_n} bulk + "
                    f"synthetic neuron {' '.join(CURVE)}), offline "
                    "solve via run_solver_3d1d (input_metric.dat, tol "
                    "1e-6)\n")
            f.write("gamma niters converged setup_s solve_s wall_s\n")
            for row in rows:
                f.write(" ".join(row) + "\n")
        print("wrote", path, flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "dump"
    mesh_n = int(sys.argv[2]) if len(sys.argv) > 2 else MESH_N
    gammas = sys.argv[3:] or GAMMAS
    if mode == "dump":
        dump(mesh_n, gammas)
    else:
        solve(mesh_n, gammas)
