"""Full reference regression surface: run every sweep grid of
/root/reference/run_*.sh at reference refinement depths and collect the
iteration/cond/error tables into docs/sample_results/.

Grids (BASELINE.md "Sweep grid"):
  bidomain_2d   4 preconds x 6 gamma, nrefs 5   (run_bidomain_2d.sh:5-13)
  bidomain_3d   2 preconds x 6 gamma, nrefs 4   (run_bidomain_3d.sh:5-13)
  emi_2d        metric x 6 gamma, nrefs 5       (run_emi_2d.sh:5-12)
  emi_3d        metric x 6 gamma, nrefs 5       (run_emi_3d.sh:5-12)
  emi_3d1d      4 radii x 6 gamma (dump->solve) (run_emi_3d1d.sh:4-17)
  firedrake-GMG mg x 6 gamma, nrefs 5           (run_bidomain_2d_firedrake.sh)

Each cell is a fresh CPU interpreter (JAX_PLATFORMS=cpu, unlimited
stack — CLAUDE.md, the stack-limit hazard); the parent never imports
JAX, so no worker opens an accelerator.  Cells
are resumable: a cell whose result table already has all rows is skipped.
metric-family cells run with -timing_runs 2 so timeKSP excludes XLA
compile (the reference's HAZmath timings are pure compute); 500-iteration
standard-AMG cells skip the warm re-run (compile is <5% there).

Usage:
    python scripts/regress_sweep.py [--workers 2] [--only SWEEP ...]
    python scripts/regress_sweep.py --collect   # just rebuild docs tables
"""
from __future__ import annotations

import argparse
import os
import re
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMMAS = ["1", "100", "10000", "1000000", "100000000", "10000000000"]
RADII = ["0.0", "0.2", "1.0", "5.0"]
LOGDIR = os.path.join(ROOT, "results", "regress_logs")
DOCS = os.path.join(ROOT, "docs", "sample_results")


def _tag(precond, gamma):
    return (f"precond{precond}_kappa12_kappa23_gamma{float(gamma)}"
            f"_pdegree1")


def build_cells(only=None):
    """Ordered cell list; each: dict(name, argv, done_file, min_rows)."""
    cells = []

    def add(sweep, name, module, flags, done, min_rows):
        cells.append(dict(sweep=sweep, name=name, module=module,
                          flags=flags, done=done, min_rows=min_rows))

    # 1. the flagship metric table first, then the 3d-1d centerpiece,
    #    then the comparison preconds, then the rest.
    for g in GAMMAS:
        add("bidomain_2d", f"bidomain_2d/metric_mono/g{g}",
            "tpuamg.problems.bidomain_2d",
            ["-nrefs", "5", "-gamma", g, "-precond", "metric_mono",
             "-timing_runs", "2"],
            f"results/bidomain_2d/iters_{_tag('metric_mono', g)}.txt", 6)
    for r in RADII:
        for g in GAMMAS:
            add("emi_3d1d", f"emi_3d1d/r{r}/g{g}", None,
                [r, g], f"results/emi_3d1d_sweep/r{r}_g{g}.out", 1)
    for p in ("hazmath", "hazmath_Schwarz", "hazmath_HEM"):
        for g in GAMMAS:
            add("bidomain_2d", f"bidomain_2d/{p}/g{g}",
                "tpuamg.problems.bidomain_2d",
                ["-nrefs", "5", "-gamma", g, "-precond", p],
                f"results/bidomain_2d/iters_{_tag(p, g)}.txt", 6)
    for g in GAMMAS:
        add("emi_2d", f"emi_2d/metric/g{g}", "tpuamg.problems.emi_2d",
            ["-nrefs", "5", "-gamma", g, "-precond", "metric",
             "-timing_runs", "2"],
            f"results/emi_2d/iters_{_tag('metric', g)}.txt", 6)
    for g in GAMMAS:
        add("emi_3d", f"emi_3d/metric/g{g}", "tpuamg.problems.emi_3d",
            ["-nrefs", "5", "-gamma", g, "-precond", "metric",
             "-timing_runs", "2"],
            f"results/emi_3d/iters_{_tag('metric', g)}.txt", 6)
    for p in ("hazmath", "hazmath_HEM"):
        for g in GAMMAS:
            add("bidomain_3d", f"bidomain_3d/{p}/g{g}",
                "tpuamg.problems.bidomain_3d",
                ["-nrefs", "4", "-gamma", g, "-precond", p],
                f"results/bidomain_3d/iters_{_tag(p, g)}.txt", 5)
    for g in GAMMAS:
        tag = f"mgmg_kappa12_kappa23_gamma{float(g)}_width0.125"
        add("bidomain_2d_gmg", f"gmg/mg/g{g}",
            "tpuamg.problems.bidomain_2d_gmg",
            ["-nrefs", "5", "-gamma", g, "-mg_type", "mg"],
            f"results/bidomain_2d_firedrake/iters_{tag}.txt", 6)
        # GMG cells previously stalled above 8k dofs; cap them so a slow
        # cell cannot starve the rest of the grid (partial tables still
        # collect into docs)
        cells[-1]["timeout"] = 3000
    if only:
        cells = [c for c in cells if c["sweep"] in only]
    return cells


def cell_done(cell):
    # a cell already collected into docs/sample_results counts as done
    # (results/ is gitignored and may be cleaned between sessions)
    if cell["module"] is None:        # emi_3d1d: row in the docs table
        radius, gamma = cell["flags"]
        doc = os.path.join(DOCS, "emi_3d1d_sweep.txt")
        if os.path.exists(doc):
            for ln in open(doc):
                cols = ln.split()
                if cols[:2] == [radius, gamma]:
                    return True
    paths = [os.path.join(ROOT, cell["done"])]
    if cell["module"] is not None and cell["done"].startswith("results/"):
        paths.append(os.path.join(DOCS,
                                  cell["done"].split("results/", 1)[1]))
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            lines = [ln for ln in f if ln.strip()]
        if cell["module"] is None:
            if any("niters=" in ln for ln in lines):
                return True
        elif len(lines) >= cell["min_rows"]:
            return True
    return False


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _unlimit():
    try:
        resource.setrlimit(resource.RLIMIT_STACK,
                           (resource.RLIM_INFINITY,
                            resource.RLIM_INFINITY))
    except Exception:
        pass


def run_cell(cell, mesh_n=16, timeout=7200):
    os.makedirs(LOGDIR, exist_ok=True)
    log = os.path.join(LOGDIR, cell["name"].replace("/", "_") + ".log")
    timeout = min(timeout, cell.get("timeout", timeout))
    t0 = time.time()
    if cell["module"] is None:
        rc = _run_3d1d_cell(cell, mesh_n, timeout, log)
    else:
        cmd = [sys.executable, "-m", cell["module"]] + cell["flags"]
        with open(log, "w") as out:
            try:
                rc = subprocess.run(cmd, cwd=ROOT, env=_env(),
                                    stdout=out, stderr=subprocess.STDOUT,
                                    preexec_fn=_unlimit,
                                    timeout=timeout).returncode
            except subprocess.TimeoutExpired:
                rc = -99
    dt = time.time() - t0
    status = "ok" if rc == 0 and cell_done(cell) else f"FAIL(rc={rc})"
    print(f"[{time.strftime('%H:%M:%S')}] {cell['name']:40s} "
          f"{status:12s} {dt:8.1f}s", flush=True)
    return rc


def _run_3d1d_cell(cell, mesh_n, timeout, log):
    """dump -> offline solve; record the solver stdout as the cell result
    (the reference's output.txt, run_emi_3d1d.sh:11)."""
    radius, gamma = cell["flags"]
    outdir = os.path.join(ROOT, "results", "emi_3d1d_sweep",
                          f"data_r{radius}_g{gamma}")
    resdir = os.path.join(ROOT, "results", "emi_3d1d_sweep",
                          f"res_r{radius}_g{gamma}")
    donef = os.path.join(ROOT, cell["done"])
    os.makedirs(os.path.dirname(donef), exist_ok=True)
    with open(log, "w") as out:
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "tpuamg.problems.emi_3d1d",
                 "-gamma", gamma, "-radius", radius, "-dump", "1",
                 "-outdir", outdir, "-mesh_n", str(mesh_n)],
                cwd=ROOT, env=_env(), stdout=out,
                stderr=subprocess.STDOUT, preexec_fn=_unlimit,
                timeout=timeout).returncode
            if rc != 0:
                return rc
            res = subprocess.run(
                [sys.executable, "-m", "tpuamg.problems.run_solver_3d1d",
                 "-infile", "tpuamg/problems/input_metric.dat",
                 "-indir", outdir, "-outdir", resdir],
                cwd=ROOT, env=_env(), capture_output=True, text=True,
                preexec_fn=_unlimit, timeout=timeout)
            out.write(res.stdout + res.stderr)
            if res.returncode == 0:
                with open(donef, "w") as f:
                    f.write(res.stdout)
            shutil.rmtree(outdir, ignore_errors=True)  # ~100MB per cell
            return res.returncode
        except subprocess.TimeoutExpired:
            return -99


ANSI = re.compile(r"\x1b\[[0-9;]*m")


def _data_rows(path):
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for ln in f if ln.strip())


def collect():
    """Copy/condense result tables into docs/sample_results/.

    A fresh results/ table never REPLACES a docs table that has more
    data rows: interrupted/timeout cells leave partial tables in
    results/, and blindly copying them over complete committed tables
    silently drops the large-n rows."""
    for sweep in ("bidomain_2d", "bidomain_3d", "emi_2d", "emi_3d",
                  "bidomain_2d_firedrake"):
        src = os.path.join(ROOT, "results", sweep)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(DOCS, sweep)
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(src)):
            if f.startswith(("iters_", "error_")) and f.endswith(".txt"):
                sp, dp = os.path.join(src, f), os.path.join(dst, f)
                if _data_rows(sp) >= _data_rows(dp):
                    shutil.copy(sp, dp)
                else:
                    print(f"collect: keeping {dp} "
                          f"({_data_rows(dp)} rows > fresh "
                          f"{_data_rows(sp)})", flush=True)
    # emi_3d1d summary table: seed from the existing docs copy (the
    # durable done-marker cell_done consults), overwrite per-cell rows
    # only where a fresh .out result exists — results/ is cleaned
    # between sessions, so a partial rerun must not drop skipped cells.
    doc = os.path.join(DOCS, "emi_3d1d_sweep.txt")
    rows = {}
    if os.path.exists(doc):
        for ln in open(doc):
            cols = ln.split()
            if len(cols) == 6 and not ln.startswith("#") \
                    and cols[0] != "radius":
                rows[(cols[0], cols[1])] = tuple(cols)
    outd = os.path.join(ROOT, "results", "emi_3d1d_sweep")
    fresh = 0
    if os.path.isdir(outd):
        for r in RADII:
            for g in GAMMAS:
                p = os.path.join(outd, f"r{r}_g{g}.out")
                if not os.path.exists(p):
                    continue
                txt = ANSI.sub("", open(p).read())
                m = re.search(r"niters=(\d+) converged=(\w+) "
                              r"setup=([\d.]+)s solve=([\d.]+)s", txt)
                if m:
                    rows[(r, g)] = (r, g) + m.groups()
                    fresh += 1
    if rows and (fresh or not os.path.exists(doc)):
        os.makedirs(DOCS, exist_ok=True)
        with open(doc, "w") as f:
            f.write("# offline xd-1d solver (input_metric.dat, tol "
                    "1e-6): radius x gamma grid\n")
            f.write("radius gamma niters converged setup_s solve_s\n")
            for r in RADII:
                for g in GAMMAS:
                    if (r, g) in rows:
                        f.write(" ".join(str(v)
                                         for v in rows[(r, g)]) + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--mesh_n", type=int, default=16,
                    help="emi_3d1d bulk resolution (reference uses the "
                    "real neuron mesh; 16 is the synthetic default)")
    ap.add_argument("--timeout", type=int, default=7200)
    ap.add_argument("--collect", action="store_true")
    args = ap.parse_args()
    if args.collect:
        collect()
        print("collected into", DOCS)
        return
    cells = build_cells(args.only)
    todo = [c for c in cells if not cell_done(c)]
    print(f"{len(cells)} cells, {len(todo)} to run", flush=True)
    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        futs = [ex.submit(run_cell, c, args.mesh_n, args.timeout)
                for c in todo]
        for f in futs:
            f.result()
    collect()
    print("done; tables in", DOCS)


if __name__ == "__main__":
    main()
