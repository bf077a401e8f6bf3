"""Smoke test of the metric-AMG solve path on one NVIDIA GPU.

Drives the main path once, through the entry points a user calls, at the
reference's top sizes, and checks every result against the repository's
own references.  Everything runs in one process, so one process holds
the card.

Phases (default run, one card):
  0. device: card name and power limit, JAX version, XLA_FLAGS, the
     compile-cache directory, and whether the native host library built;
  1. bidomain 2D, n=512 (526,338 dofs), gamma=1e6, metric_mono, grid path,
     float64, through ``solve_system`` as the bidomain CLI calls it:
     converged, true relative residual <= 1e-8 (recomputed in float64 on
     the host), H1 errors within 1e-3 relative of the committed CPU table,
     iterations within 1 of a CPU float64 run of the same call;
  2. the committed 3D-1D production dumps (284,625 dofs) through
     ``run_solver_3d1d.main``: true relative residual <= 1e-6 (the .dat
     tolerance), recomputed in float64 on the host against the loaded A;
     gamma=1e8 by default, gamma=1 too with ``--gamma1``;
  3. kernel checks at n=512 and n=1024: the XLA DIA matvec and residual
     against a float64 scipy reference (float64 to 1e-12, float32 to 1e-5
     relative), one float32 coarse solve and one Schwarz block apply
     against float64 numpy to 1e-5 relative (TF32 would miss that by two
     orders), and the DIA rate beside a 1 GiB copy.

``--four-cards`` runs only the distributed grid path (bidomain n=1024 on
four cards) and its one-card comparison: same iteration count, solutions
agree to 1e-9, peak bytes per device.

Every check is printed as it is made; a failed check, or no GPU, ends the
run with a non-zero exit and no result line.  The last line of a passing
run is ``{"ok": true, "device": {"platform", "kind", "count"}}``.

    python chip_smoke.py [--gamma1] [--four-cards]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GRID_N = 512
GAMMA = 1e6
KERNEL_GRIDS = (512, 1024)
FOUR_CARD_N = 1024
COPY_BYTES = 1 << 30
# Iterations of the phase-1 call (grid path, float64) under
# JAX_PLATFORMS=cpu on the host CPU.
CPU_GRID_ITERS = 15
# Iterations of run_solver_3d1d on each committed dump, float64 on the
# host CPU (printed beside the card's count; not a check).
CPU_3D1D_ITERS = {"1e+08": 35, "1": 27}
DAT = os.path.join(ROOT, "tpuamg", "problems", "input_metric.dat")
ERROR_TABLE = os.path.join(
    ROOT, "docs", "sample_results", "bidomain_2d",
    "error_precondmetric_mono_kappa12_kappa23_gamma1000000.0_pdegree1.txt")


def check(ok, what):
    """Print one check; a failed one ends the run with exit code 1."""
    print(f"  check {what}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise SystemExit(1)


class CompileClock:
    """Wall seconds JAX spends tracing, lowering and compiling (persistent
    cache retrievals included): the union of the time spans of its
    compile events, which nest (a cache read sits inside a backend
    compile, a jit traced inside another's trace), so spans are merged
    rather than summed."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.spans = []
        jax.monitoring.register_event_time_span_listener(self._on)

    def _on(self, event, start, end, **_):
        if event in self.EVENTS:
            self.spans.append((start, end))

    def mark(self):
        return time.time()

    def since(self, mark):
        return union_length([(max(s, mark), e) for s, e in self.spans])


def peak_bytes(device):
    return device.memory_stats()["peak_bytes_in_use"]


def rel_residual(A, b, x):
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b - A.matvec(np.asarray(x, np.float64)))
                 / np.linalg.norm(b))


def assemble_bidomain(n, gamma):
    from tpuamg.fem import mms
    from tpuamg.problems.bidomain import Params, get_mesh, get_system
    params = Params(2.0, 3.0, gamma)
    data = mms.setup_bidomain_mms(params, dim=2)
    mesh = get_mesh(n, 2)
    A, b, sizes, _ = get_system(mesh, data, params)
    return mesh, data, A, b, sizes


def solve_bidomain_grid(A, b, sizes, n):
    """The bidomain CLI's grid-path call (problems/bidomain_2d.run with
    -precond metric_mono -backend grid), solved twice: the second solve
    is warm."""
    import jax.numpy as jnp
    from tpuamg.config import PRESETS
    from tpuamg.problems.solve import solve_system
    idofs = np.arange(sizes[0], sum(sizes))
    return solve_system(A, b, "metric_mono", sizes, idofs=idofs,
                        params=PRESETS["metric_schwarz"], tol=1e-8,
                        maxiter=500, dtype=jnp.float64,
                        grid=((n + 1, n + 1), 2), timing_runs=2)


class FirstChunk:
    """Within the block, records the arguments of the first PCG chunk
    program call (krylov.cg._pcg_scan_chunk), so that the compiled
    program can be inspected afterwards: lowering and compiling it again
    with the same arguments hits JAX's in-memory caches."""

    def __enter__(self):
        import tpuamg.krylov.cg as cg
        self._cg, self._program, self.args = cg, cg._pcg_scan_chunk, None

        def record(*args):
            if self.args is None:
                self.args = args
            return self._program(*args)
        cg._pcg_scan_chunk = record
        return self

    def __exit__(self, *exc):
        self._cg._pcg_scan_chunk = self._program
        return False

    def memory_analysis(self):
        return self._program.lower(*self.args).compile().memory_analysis()


def cpu_table_errors(ndofs):
    rows = np.loadtxt(ERROR_TABLE, skiprows=1)
    row = rows[rows[:, 0] == ndofs][0]
    return row[2], row[4]


def phase_device(devices):
    import jax
    import tpuamg
    from tpuamg.gpu import card_lines
    from tpuamg.native import get_lib
    print("== phase 0: device", flush=True)
    for line in card_lines():
        print(line, flush=True)
    print(f"  jax {jax.__version__}  platform={devices[0].platform} "
          f"kind={devices[0].device_kind} count={len(devices)}")
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {tpuamg.enable_compilation_cache()}")
    check(get_lib() is not None, "native host library built and loaded")


def phase_bidomain(device, clock):
    from tpuamg.problems.bidomain import compute_errors
    print(f"== phase 1: bidomain 2D n={GRID_N} gamma={GAMMA:g} "
          "metric_mono, grid path, float64", flush=True)
    t0 = time.time()
    mesh, data, A, b, sizes = assemble_bidomain(GRID_N, GAMMA)
    print(f"  assembly {time.time() - t0:.3f}s: {sum(sizes)} dofs, "
          f"{A.nnz} nnz")
    mark = clock.mark()
    with FirstChunk() as chunk:
        rep = solve_bidomain_grid(A, b, sizes, GRID_N)
    print(f"  iters={rep.niters} converged={rep.converged} "
          f"cond={rep.cond:.4g} setup={rep.t_setup:.3f}s "
          f"compile={clock.since(mark):.3f}s warm solve={rep.t_solve:.4f}s")
    check(rep.converged, "converged")
    rel = rel_residual(A, b, rep.x)
    print(f"  true relative residual {rel:.3e}")
    check(rel <= 1e-8, "true relative residual <= 1e-8")
    e1, e2 = compute_errors(mesh, data, rep.x, sizes)
    r1, r2 = cpu_table_errors(sum(sizes))
    print(f"  H1 errors u1={e1:.10g} u2={e2:.10g} (CPU table {r1:.10g} "
          f"{r2:.10g})")
    check(abs(e1 - r1) <= 1e-3 * r1 and abs(e2 - r2) <= 1e-3 * r2,
          "H1 errors within 1e-3 relative of the CPU table")
    check(abs(rep.niters - CPU_GRID_ITERS) <= 1,
          f"iterations within 1 of the CPU float64 count {CPU_GRID_ITERS}")
    busy, nk, share, _ = device_profile(chunk._program, chunk.args, 1,
                                        "pcg_chunk")
    steps = chunk.args[-1]
    print(f"  one PCG chunk ({steps} steps, traced): device busy "
          f"{busy * 1e3:.3f} ms, {nk / steps:.0f} kernels and "
          f"{busy / steps * 1e6:.1f} us busy per step, idle share "
          f"{1.0 - share:.3f} of the device-event window")
    ma = chunk.memory_analysis()
    print(f"  PCG chunk program memory: "
          f"arguments={ma.argument_size_in_bytes} "
          f"outputs={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
          f"code={ma.generated_code_size_in_bytes} bytes; "
          f"peak_bytes_in_use={peak_bytes(device)}")
    # the outer operator: the Partial-wrapped DIA of sparse.dia_matvec_op
    return chunk.args[0].args[0].offsets


def phase_3d1d(tag, device, clock):
    from tpuamg.io_utils import load_system
    from tpuamg.problems import run_solver_3d1d
    gamma = float(tag)
    name = f"prod3d1d_g{int(gamma)}"
    indir = os.path.join(ROOT, "data", name)
    print(f"== phase 2: 3D-1D production dump {name}, run_solver_3d1d",
          flush=True)
    mark = clock.mark()
    t0 = time.time()
    rep = run_solver_3d1d.main(
        ["-infile", DAT, "-indir", indir,
         "-outdir", os.path.join(ROOT, "results", "chip_smoke", name)])
    # run_solver_3d1d solves once, so its solve time includes the PCG
    # program's compile; the clock spans the whole phase, setup included
    print(f"  iters={rep.niters} (CPU float64: {CPU_3D1D_ITERS[tag]}) "
          f"converged={rep.converged} setup={rep.t_setup:.3f}s "
          f"solve (compile included)={rep.t_solve:.3f}s "
          f"compile in the phase={clock.since(mark):.3f}s "
          f"wall={time.time() - t0:.3f}s; "
          f"peak_bytes_in_use={peak_bytes(device)}")
    A, b, _, _ = load_system(indir)
    rel = rel_residual(A, b, rep.x)
    print(f"  true relative residual {rel:.3e}")
    check(rep.converged, "converged")
    check(rel <= 1e-6, "true relative residual <= 1e-6")


def stencil_offsets(offsets, n_from, n_to):
    """The interleaved 2-field P1 grid offsets 2*(di*(n+1)+dj)+df of an
    (n_from) operator, rewritten for an (n_to) grid."""
    out = []
    for o in offsets:
        hits = [(di, dj, df) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                for df in (-1, 0, 1)
                if 2 * (di * (n_from + 1) + dj) + df == o]
        di, dj, df = hits[0]
        out.append(2 * (di * (n_to + 1) + dj) + df)
    return sorted(out)


def dia_case(offsets, nrows, dtype, seed):
    """Random planes at the given offsets, rounded to `dtype`, and the
    float64 scipy operator of exactly the stored values."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from tpuamg.sparse.dia import DIA
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), nrows))
    rows = np.arange(nrows)
    for d, o in enumerate(offsets):
        data[d, (rows + o < 0) | (rows + o >= nrows)] = 0.0
    data = data.astype(dtype).astype(np.float64)
    r = np.concatenate([rows] * len(offsets))
    c = np.concatenate([rows + o for o in offsets])
    keep = (c >= 0) & (c < nrows)
    ref = sp.csr_matrix((data.reshape(-1)[keep], (r[keep], c[keep])),
                        shape=(nrows, nrows))
    D = DIA(offsets, jnp.asarray(data, dtype=dtype), (nrows, nrows),
            nnz=int(keep.sum()))
    return D, ref


def union_length(spans):
    """Total length covered by a list of (start, end) intervals."""
    total, reach = 0, None
    for start, end in sorted(spans):
        if reach is not None:
            start = max(start, reach)
        if end > start:
            total += end - start
            reach = end
    return total


def device_profile(fn, args, calls, tag):
    """Device time of `calls` calls of the compiled fn, from a
    jax.profiler trace: (busy seconds per call, kernels per call,
    busy / window of the device events, kernel names)."""
    import glob
    import shutil
    import jax
    from jax.profiler import ProfileData
    jax.block_until_ready(fn(*args))
    logdir = os.path.join(ROOT, "results", "chip_smoke", "traces", tag)
    shutil.rmtree(logdir, ignore_errors=True)
    jax.profiler.start_trace(logdir)
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    spans, names = [], set()
    for plane in ProfileData.from_file(path).planes:
        if plane.name.startswith("/device:GPU"):
            # the stream lines hold the kernels and copies; other lines
            # (XLA ops or modules, where present) repeat them
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    names.add(ev.name)
    if not spans:
        return 0.0, 0.0, 0.0, names
    busy = union_length(spans) * 1e-9
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) * 1e-9
    return busy / calls, len(spans) / calls, busy / window, names


def phase_kernels(offsets512):
    """offsets512: the phase-1 outer operator's offsets (GRID_N grid)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from tpuamg.amg.hierarchy import MGPreconditioner
    from tpuamg.smoothers.schwarz import SchwarzSmoother
    from tpuamg.sparse import ELL, HostCSR
    print("== phase 3: kernel checks (device times from profiler traces)",
          flush=True)
    calls = 20
    x = jnp.ones(COPY_BYTES // 4, dtype=jnp.float32)
    t, _, _, _ = device_profile(jax.jit(lambda v: v + 1.0), (x,), calls,
                                "copy")
    check(t > 0, "the trace holds device events")
    copy_rate = 2 * x.nbytes / t
    print(f"  copy of {COPY_BYTES} B (read + write): {t * 1e6:.1f} us, "
          f"{copy_rate:.4g} B/s")
    del x
    for n in KERNEL_GRIDS:
        offs = stencil_offsets(offsets512, GRID_N, n)
        nrows = 2 * (n + 1) ** 2
        for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
            D, ref = dia_case(offs, nrows, dtype, seed=n)
            rng = np.random.default_rng(1)
            x64 = rng.standard_normal(nrows).astype(dtype).astype(np.float64)
            b64 = rng.standard_normal(nrows).astype(dtype).astype(np.float64)
            xd, bd = jnp.asarray(x64, dtype), jnp.asarray(b64, dtype)
            mv = jax.jit(lambda A, v: A.matvec(v))
            rs = jax.jit(lambda A, v, w: A.residual(v, w))
            y = np.asarray(mv(D, xd), np.float64)
            want = ref @ x64
            err = np.linalg.norm(y - want) / np.linalg.norm(want)
            check(err <= tol, f"DIA matvec n={n} {np.dtype(dtype).name} "
                  f"rel err {err:.2e} <= {tol:g}")
            y = np.asarray(rs(D, xd, bd), np.float64)
            want = b64 - ref @ x64
            err = np.linalg.norm(y - want) / np.linalg.norm(want)
            check(err <= tol, f"DIA residual n={n} "
                  f"{np.dtype(dtype).name} rel err {err:.2e} <= {tol:g}")
            item = np.dtype(dtype).itemsize
            name = np.dtype(dtype).name
            for what, fn, args, nvec in (("matvec", mv, (D, xd), 2),
                                         ("residual", rs, (D, xd, bd), 3)):
                t, nk, _, kernels = device_profile(
                    fn, args, calls, f"dia_{what}_{n}_{name}")
                nbytes = (len(offs) + nvec) * nrows * item
                print(f"  DIA {what} n={n} {name} ({nrows} rows, "
                      f"{len(offs)} diagonals): {t * 1e6:.2f} us, "
                      f"{nbytes / t:.4g} B/s = "
                      f"{nbytes / t / copy_rate:.3f} of the copy rate; "
                      f"{nk:g} kernel(s) per call {sorted(kernels)}")
    rng = np.random.default_rng(2)
    nc = 4096
    M = rng.standard_normal((nc, nc)) / np.sqrt(nc) + 4.0 * np.eye(nc)
    inv32 = np.linalg.inv(M).astype(np.float32)
    r32 = rng.standard_normal(nc).astype(np.float32)
    prec = MGPreconditioner((), jnp.asarray(inv32), cycle="v")
    got = np.asarray(jax.jit(lambda P, v: P._coarse_solve(v))(
        prec, jnp.asarray(r32)), np.float64)
    want = inv32.astype(np.float64) @ r32.astype(np.float64)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    check(err <= 1e-5, f"float32 coarse solve ({nc} dofs) rel err "
          f"{err:.2e} <= 1e-5")
    nb, m = 2048, 64
    n = nb * m
    ids = np.arange(n, dtype=np.int32).reshape(nb, m)
    blocks = (rng.standard_normal((nb, m, m)) / np.sqrt(m)).astype(
        np.float32)
    off = np.full(n - 1, -1.0)
    Asp = sp.diags([off, np.full(n, 4.0), off], [-1, 0, 1], format="csr")
    Ah = HostCSR(Asp.indptr, Asp.indices, Asp.data, Asp.shape)
    ell = ELL.from_host(Ah, dtype=jnp.float32)
    sm = SchwarzSmoother([jnp.asarray(ids)], [jnp.asarray(blocks)])
    x32 = rng.standard_normal(n).astype(np.float32)
    b32 = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(jax.jit(lambda S, A, v, w: S._color_update(A, v, w, 0))(
        sm, ell, jnp.asarray(x32), jnp.asarray(b32)), np.float64)
    x64, b64 = x32.astype(np.float64), b32.astype(np.float64)
    r = b64 - Asp @ x64
    want = x64 + np.einsum("bij,bj->bi", blocks.astype(np.float64),
                           r[ids]).reshape(-1)
    err = np.linalg.norm(got - want) / np.linalg.norm(want - x64)
    check(err <= 1e-5, f"float32 Schwarz block apply ({nb} blocks of {m}) "
          f"rel err {err:.2e} <= 1e-5")


def phase_four_cards(devices):
    import jax.numpy as jnp
    from tpuamg.dist import device_mesh
    from tpuamg.dist.solve import distributed_grid_solve
    n = FOUR_CARD_N
    print(f"== four cards: bidomain 2D n={n} gamma={GAMMA:g} float64, "
          "distributed grid path", flush=True)
    check(len(devices) >= 4, "at least 4 devices")
    t0 = time.time()
    _, _, A, b, sizes = assemble_bidomain(n, GAMMA)
    print(f"  assembly {time.time() - t0:.3f}s: {sum(sizes)} dofs")
    xs, iters = {}, {}
    for ndev in (4, 1):
        mesh = device_mesh(devices=devices[:ndev])
        t0 = time.time()
        res, _ = distributed_grid_solve(A, b, (n + 1, n + 1), F=2,
                                        mesh=mesh, tol=1e-8, maxiter=500,
                                        dtype=jnp.float64)
        rel = rel_residual(A, b, res.x)
        print(f"  {ndev} device(s): iters={res.niters} "
              f"converged={res.converged} wall={time.time() - t0:.3f}s "
              f"true relative residual {rel:.3e} {res.dist_info}")
        print("  peak bytes per device: " + ", ".join(
            f"{d.id}:{peak_bytes(d)}" for d in devices[:4]))
        check(res.converged and rel <= 1e-8, f"{ndev}-device solve")
        xs[ndev], iters[ndev] = np.asarray(res.x), res.niters
    check(iters[4] == iters[1], "identical iteration counts")
    diff = np.linalg.norm(xs[4] - xs[1]) / np.linalg.norm(xs[1])
    print(f"  relative difference of the solutions {diff:.3e}")
    check(diff <= 1e-9, "solutions agree to 1e-9")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gamma1", action="store_true",
                    help="also solve the gamma=1 3D-1D dump")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed path on four cards "
                    "and its one-card comparison")
    args = ap.parse_args(argv)
    t_start = time.time()
    import jax
    jax.config.update("jax_enable_x64", True)
    from tpuamg.gpu import require_gpu, device_summary
    devices = require_gpu()
    clock = CompileClock()
    phase_device(devices)
    if args.four_cards:
        phase_four_cards(devices)
    else:
        offsets = phase_bidomain(devices[0], clock)
        for tag in ("1e+08", "1") if args.gamma1 else ("1e+08",):
            phase_3d1d(tag, devices[0], clock)
        phase_kernels(offsets)
    print(f"total wall {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": device_summary(devices)}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
