"""Preconditioner factories + monolithic solve orchestration.

Rebuilds the used surface of /root/reference/src/utils.py:9-127:
- ``get_block_diag_precond``  (exact per-block solves, 'diag' mode)
- ``get_hazmath_amg_precond`` ('hazmath', 'hazmath_Schwarz': UA-AMG on the
  monolithic operator, VMB aggregation)
- ``get_hazmath_metric_precond[_mono]`` ('metric', 'metric_mono',
  'hazmath_HEM': metric AMG with HEM aggregation + interface Schwarz,
  metricAMG(A, W, idofs, parameters) semantics, utils.py:86-88)
- ``solve_haznics`` ('metric_hazmath': the all-native solve —
  here: the fully-jitted PCG+cycle XLA program, utils.py:95-127)

All preconditioner applications and the PCG loop are one compiled XLA
program; setup runs on host (SURVEY.md §3.1 split).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR, ELL, matvec_op
from ..amg import setup_amg, as_operator
from ..config import AMGParameters, PRESETS
from ..krylov import pcg, minres, gmres


@dataclass
class SolveReport:
    x: np.ndarray
    niters: int
    converged: bool
    cond: float
    r_norm: float
    t_setup: float
    t_solve: float
    residuals: np.ndarray
    # refine=k only: Krylov iterations of each refinement pass.  niters
    # is their SUM — compare per-PASS counts, not niters, against
    # single-solve tables (a refine=4 run at ~15 iters/pass reports 60).
    pass_iters: tuple = ()


def _dense_apply(M, r):
    return jnp.matmul(M, r, precision=jax.lax.Precision.HIGHEST)


def _dense_inv_op(A: HostCSR, dtype):
    inv = jnp.asarray(np.linalg.inv(A.toarray()), dtype=dtype)
    return jax.tree_util.Partial(_dense_apply, inv)


def block_diag_precond(blocks, dtype=jnp.float64, size_limit=30000):
    """Exact block-diagonal preconditioner (LU role of utils.py:9-12).

    Small blocks invert densely (the UMFPACK stand-in); larger blocks fall
    back to a tightly-converged AMG-preconditioned inner solve expressed as
    a few V-cycles (still a fixed linear operator, so outer CG stays
    valid)."""
    ops = []
    offs = [0]
    for B in blocks:
        nb = B.shape[0]
        offs.append(offs[-1] + nb)
        if nb <= size_limit:
            ops.append(_dense_inv_op(B, dtype))
        else:
            prm = AMGParameters(aggregation_type="vmb", cycle_type="v",
                                maxit=3,
                                dtype=np.dtype(dtype).name)
            ops.append(as_operator(setup_amg(B, prm)))

    def _apply(ops_, r):
        return jnp.concatenate(
            [ops_[i](r[offs[i]:offs[i + 1]]) for i in range(len(ops_))])

    return jax.tree_util.Partial(_apply, tuple(ops))


def make_preconditioner(precond: str, A: HostCSR, sizes, idofs=None,
                        params: AMGParameters = None, blocks=None,
                        dtype=jnp.float64):
    """Map the reference's -precond choices to AMG setups
    (/root/reference/src/bidomain_2d.py:155-160, 190-203)."""
    if precond == "diag":
        assert blocks is not None
        return block_diag_precond(blocks, dtype=dtype)
    from dataclasses import replace
    if params is None:
        # 'metric'/'metric_mono' with no explicit parameters fall back to
        # the metricAMG defaults of utils.py:60-82 (Schwarz_maxlvl=2); the
        # bidomain driver overrides these with parameters_metric_schwarz
        # (bidomain_2d.py:201) by passing params explicitly.
        params = {
            "hazmath": PRESETS["standard"],
            "hazmath_Schwarz": PRESETS["standard_schwarz"],
            # hazmath_HEM passes parameters_metric (Schwarz_levels: 0 in
            # the dict, /root/reference/src/amg_parameters.py:47-65) BUT
            # hands interface_dofs to metricAMG, whose contract is "the
            # interface_dofs has the Schwarz and the rest the GS
            # smoother" (/root/reference/src/utils.py:84) regardless of
            # the dict's Schwarz_levels — without the interface Schwarz
            # the gamma-coupled pairs are unsmoothable and the preset
            # degrades 33->61 iters / cond 2e5 at gamma=1e10 (measured,
            # scripts notes round 4); with it, gamma-flat like
            # metric_mono.
            "hazmath_HEM": PRESETS["metric_schwarz"],
            "metric": PRESETS["metric_mono_default"],
            "metric_mono": PRESETS["metric_mono_default"],
            "metric_hazmath": PRESETS["metric_mono_default"],
        }[precond]
    wanted = np.dtype(dtype).name
    if params.dtype != wanted:
        params = replace(params, dtype=wanted)
    # Plain 'hazmath' uses no interface information (utils.py:15-42);
    # the Schwarz/metric family consumes idofs (utils.py:84-88).
    if precond == "hazmath":
        idofs = None
    prec = setup_amg(A, params, idofs=idofs)
    return as_operator(prec)


def _split_metric_matvec(data, x):
    AD, Rell, Mqell, RTell, g = data
    u = Rell.matvec(x)
    return AD.matvec(x) + g * RTell.matvec(Mqell.matvec(u))


def _split_metric_operator(A, coupling, sizes, slots, nsl, dtype):
    """Outer operator in FACTORED metric form:
    A x = AD x + gamma * R^T Mq (R x),  R = [-Pi, I].

    Entrywise storage of A at large gamma is catastrophically
    cancelling: the metric rows' matvec result is ~1e5x smaller than
    the individual gamma-scaled products, so f32-stored entries give
    O(40%) RELATIVE result error at gamma=1e8 (measured; the inner PCG
    then converges cleanly to the WRONG system: preconditioned residual
    1e-8 while the true residual is O(1)).  In factored form every
    factor is O(1)-conditioned — the cancellation R x = x1 - Pi x3
    happens between f64 Krylov-vector entries, exactly — so f32 factor
    storage is a genuine ~1e-7 perturbation.  AD = A - gamma R^T Mq R
    (block-diag Laplacians) is gamma-free and narrow: the split also
    REPLACES the footprint machinery on the outer operator (the wide
    curve couplings live in R, one skinny gather per apply)."""
    from ..sparse import bmat, ELL
    from ..amg.structured import structured_system
    g, Pi, Mq = coupling
    n3, n1 = sizes
    R = bmat([[Pi.scale(-1.0), HostCSR.eye(n1)]])
    AD = A.add(R.T.matmat(Mq.matmat(R)), beta=-g)
    # prune the cancelled coupling entries (exact zeros up to f64
    # roundoff) so they don't widen the DIA offset set
    r_, c_, v_ = AD.to_coo()
    keep = np.abs(v_) > 1e-10 * np.abs(v_).max()
    AD = HostCSR.from_coo(r_[keep], c_[keep], v_[keep], AD.shape)
    ADop = structured_system(AD, slots, nsl, dtype=dtype)
    ro, co, vo = R.to_coo()
    Rs = HostCSR.from_coo(ro, np.asarray(slots)[co], vo, (n1, nsl))
    mel = ELL.from_host(Mq, dtype=dtype)
    # R and R^T are stored f64 REGARDLESS of `dtype`: for iterates x
    # near the gamma-null space (R x ~ 0 — exactly where CG converges),
    # f32-rounded R entries produce a FAKE residual R~x ~ 1e-7|x| that
    # gamma amplifies to ~10% of A x (measured: TRUE residual stalls at
    # 0.4 with f32 R, converges to 4e-8 with f64 R; a random-vector
    # parity check cannot see this).  R is skinny (nnz ~ 50 per curve
    # dof), so f64 costs nothing.  Mq/AD stay in `dtype`: they only
    # scale the ALREADY-ACCURATE R x, a true relative perturbation.
    return jax.tree_util.Partial(
        _split_metric_matvec,
        (ADop, ELL.from_host(Rs, dtype=jnp.float64), mel,
         ELL.from_host(Rs.T, dtype=jnp.float64), g))


def _deflated_apply(data, r):
    Mop, Rell, RTell, Cinv = data
    rr = Rell.matvec(r)
    y = jnp.matmul(Cinv, rr, precision=jax.lax.Precision.HIGHEST)
    return Mop(r) + RTell.matvec(y)


def _deflated_operator(Mop, A, coupling, sizes, slots, nsl, dtype):
    """gamma-subspace deflation: B r = M r + R^T (R A R^T)^{-1} R r with
    R = [-Pi, I] from the dumped metric factorization (A = AD +
    gamma R^T Mq R, emi_3d1d block layout [x3; x1]).

    MEASURED NON-ROBUST (docs/PERF_NOTES.md round-2 cont.): the exact
    range(R^T) correction does NOT flatten the structured path's gamma
    tail (n=10 sweep 14/11/23/30/32/31 vs 11/9/20/26/29/28 without) —
    the growth lives in the coarse space, not this subspace.  Kept as a
    documented experiment (scripts/exp_deflation.py); prefer
    ``algebraic_below`` (the gamma-robust algebraic metric tail).
    Cost: one dense (n1, n1) inverse at setup (device LU), two sparse
    matvecs + one dense matvec per apply; B is an SPD sum (CG-safe)."""
    from ..sparse import ELL, bmat, HostCSR
    _, Pi, _ = coupling
    n3, n1 = sizes
    R = bmat([[Pi.scale(-1.0), HostCSR.eye(n1)]])        # (n1, n)
    C = R.matmat(A.matmat(R.T))                          # (n1, n1)
    rr_, cc_, vv_ = C.to_coo()
    idt = jnp.float32 if np.dtype(dtype).itemsize <= 4 else jnp.float64
    Cd = jnp.zeros((n1, n1), dtype=idt).at[
        jnp.asarray(rr_), jnp.asarray(cc_)].set(jnp.asarray(vv_, idt))
    Cinv = jnp.linalg.inv(Cd).astype(dtype)
    # R in slot coordinates (columns permuted by the slot map)
    ro, co, vo = R.to_coo()
    Rs = HostCSR.from_coo(ro, np.asarray(slots)[co], vo, (n1, nsl))
    Rell = ELL.from_host(Rs, dtype=dtype)
    RTell = ELL.from_host(Rs.T, dtype=dtype)
    return jax.tree_util.Partial(_deflated_apply,
                                 (Mop, Rell, RTell, Cinv))


def solve_system(A: HostCSR, b, precond: str, sizes, idofs=None,
                 params: AMGParameters = None, blocks=None,
                 tol=1e-8, maxiter=500, method="cg", stop_type=2,
                 dtype=jnp.float64, callback=None,
                 grid=None, structured_coords=None, structured_order=None,
                 algebraic_below=0, fp_solver="exact", coupling=None,
                 refine=0, inner_tol=1e-6,
                 timing_runs=1, chunk=None,
                 krylov_dtype=None, host_tail=False,
                 keep_idofs=0) -> SolveReport:
    """grid: optional (dims, F) — use the gather-free structured-grid
    hierarchy (tpuamg.amg.grid) for the structured-mesh problems.
    structured_coords: optional (n, d) dof coordinates — use the general
    gather-free pair+Morton hierarchy (tpuamg.amg.structured) for non-grid
    topologies (split meshes, interfaces).
    structured_order: "morton" (default; geometric windows, narrow DIA)
    or "hem" (multilevel heavy-edge-matching windows: fewer iterations
    at extreme gamma, wider DIA bands — see amg/structured.hem_tree_slots).
    algebraic_below: real-dof threshold below which the structured
    hierarchy switches to the algebraic metric-AMG tail (gamma-flat
    coarse spaces; gathers are cheap at coarse sizes) — see
    amg/structured.setup_structured.
    keep_idofs: L > 0 keeps interface dofs uncoarsened (injected)
    through at most L structured window levels — the gamma-robust
    window coarse space (metricAMG idofs contract; see
    amg/structured.setup_structured(keep_idofs=...)).  Requires the
    tiled slot order.
    Default: the general algebraic ELL path.

    timing_runs: with 2+, after the first (compiling) solve completes,
    the solve re-runs warm and ``t_solve`` reports the LAST run — the
    reference's timeKSP is pure compute (HAZmath C has no JIT), so the
    regression tables exclude XLA compile this way (the iteration counts
    and solution come from the first run; reruns are identical programs).

    refine: mixed-precision iterative refinement (reaches the reference's
    1e-8/1e-10 tolerances — reference src/bidomain_2d.py:205,
    emi_2d.py:211 — when the device Krylov runs in f32, which bottoms out
    ~1e-6 relative).  refine=k allows up to k correction
    solves: the defect r = b - A@x is computed on host in float64, each
    correction solves A d = r on device in `dtype` to `inner_tol`
    (relative), and x accumulates in float64.  `tol` is then the final
    *true-residual* target.  refine=0 (default) = single solve, `tol` is
    the device Krylov's preconditioned-residual target.

    chunk: PCG iterations per device launch (krylov.pcg chunk); the
    host checks convergence between launches.  None = the pcg default
    (32).

    krylov_dtype: dtype of the Krylov VECTORS (default = `dtype`).
    Mixed mode krylov_dtype=f64 + dtype=f32 keeps hierarchy/operator
    storage in f32 while every recurrence
    runs in f64 via promotion — f32 CG arithmetic on the metric
    systems stalls at ~1e-2 relative (gamma-cancellation noise in the
    dots/updates), while an f32-STORED operator is only a ~1e-7
    relative perturbation of A that iterative refinement absorbs
    (measured: the n=8 gamma=1e8 tail hybrid converges 7-9 iters in
    this mode vs stalling unconverged pure-f32)."""
    slots = None
    hybrid = None      # HostTailHybrid (structured path, host_tail)
    if structured_coords is not None and grid is None \
            and precond not in ("diag",):
        from dataclasses import replace
        from ..amg.structured import setup_structured, structured_system
        from ..sparse.dia import dia_matvec_op
        prm = params or PRESETS["metric_schwarz"]
        wanted = np.dtype(dtype).name
        if prm.dtype != wanted:
            prm = replace(prm, dtype=wanted)
        t0 = time.time()
        gamma_data = None
        deflate = coupling is not None and fp_solver == "deflate"
        if coupling is not None and fp_solver == "rank1g":
            # coupling = (gamma, Pi, Mq): the dumped metric factorization
            # (io_utils.load_coupling) -> gamma-exact O(m) smoother data
            from ..smoothers.schwarz import rank1_gamma_data
            gamma_data = rank1_gamma_data(A, *coupling, sizes=sizes)
        # host_tail: run the algebraic tail as a CPU-side f64 step of a
        # split V-cycle (amg.structured.HostTailHybrid + krylov.
        # pcg_split) instead of on-device; only meaningful with
        # algebraic_below and method='cg'.
        # deflate wraps the unified preconditioner operator, which the
        # split host-tail driver has no hook for — keep the unified
        # path so the requested deflation actually happens; same for
        # non-cg methods, with a warning.
        use_host_tail = bool(host_tail and algebraic_below
                             and method == "cg" and not deflate)
        if host_tail and algebraic_below and method != "cg":
            import warnings
            warnings.warn(
                "host_tail=True requires method='cg'; falling back to "
                "the unified on-device tail",
                stacklevel=2)
        prec, slots, nsl = setup_structured(A, structured_coords, prm,
                                            dtype=dtype, idofs=idofs,
                                            order=structured_order
                                            or "morton",
                                            fp_solver="exact" if deflate
                                            else fp_solver,
                                            gamma_data=gamma_data,
                                            algebraic_below=algebraic_below,
                                            host_tail=use_host_tail,
                                            keep_idofs=keep_idofs)
        if coupling is not None:
            Aop = _split_metric_operator(A, coupling, sizes, slots, nsl,
                                         dtype)
            # the factored operator keeps R/R^T in f64 (its accuracy
            # rationale REQUIRES f64 Krylov vectors), so its matvec
            # promotes to f64 — f32 vectors would flip the scan-carry
            # dtype mid-trace.  Default the vectors to f64 here.
            if krylov_dtype is None:
                krylov_dtype = jnp.float64
        else:
            Aop = dia_matvec_op(structured_system(
                A, slots, nsl, dtype=dtype, idofs=idofs))
        kdt = krylov_dtype or dtype
        vec_dtype = kdt
        bj = jnp.zeros(nsl, dtype=kdt).at[jnp.asarray(slots)].set(
            jnp.asarray(b, dtype=kdt))
        from ..amg.structured import HostTailHybrid
        if isinstance(prec, HostTailHybrid):
            hybrid, M = prec, None
        else:
            hybrid = None
            M = as_operator(prec)
            if deflate:
                M = _deflated_operator(M, A, coupling, sizes, slots, nsl,
                                       dtype)
        t_setup = time.time() - t0
    elif grid is not None and precond not in ("diag",):
        from dataclasses import replace
        from ..amg.grid import setup_grid, grid_system
        from ..sparse.dia import dia_matvec_op
        dims, F = grid
        prm = params or PRESETS["metric_schwarz"]
        wanted = np.dtype(dtype).name
        if prm.dtype != wanted:
            prm = replace(prm, dtype=wanted)
        t0 = time.time()
        prec, slots, nsl = setup_grid(A, dims, F=F, params=prm, dtype=dtype)
        t_setup = time.time() - t0
        Aop = dia_matvec_op(grid_system(A, slots, dtype=dtype))
        M = as_operator(prec)
        vec_dtype = krylov_dtype or dtype
        bj = jnp.zeros(nsl, dtype=vec_dtype).at[jnp.asarray(slots)].set(
            jnp.asarray(b, dtype=vec_dtype))
    else:
        t0 = time.time()
        M = make_preconditioner(precond, A, sizes, idofs=idofs,
                                params=params, blocks=blocks, dtype=dtype)
        t_setup = time.time() - t0
        Aop = matvec_op(ELL.from_host(A, dtype=dtype))
        vec_dtype = krylov_dtype or dtype
        bj = jnp.asarray(b, dtype=vec_dtype)
    t0 = time.time()

    def _run(bdev, ktol, miter):
        if method == "cg" and hybrid is not None:
            from ..krylov import pcg_split
            r = pcg_split(Aop, bdev, hybrid.fine, hybrid.tail_apply,
                          tol=ktol, maxiter=miter, callback=callback,
                          stop_type=stop_type)
        elif method == "cg":
            r = pcg(Aop, bdev, M=M, tol=ktol, maxiter=miter,
                    callback=callback, stop_type=stop_type,
                    **({"chunk": chunk} if chunk else {}))
        elif method == "minres":
            r = minres(Aop, bdev, M=M, tol=ktol, maxiter=miter)
        else:
            r = gmres(Aop, bdev, M=M, tol=ktol, maxiter=miter)
        xs = np.asarray(r.x, dtype=np.float64)
        if slots is not None:
            xs = xs[slots]
        return xs, r

    if refine:
        # f64 defect correction around the device-precision inner solve.
        # The jitted Krylov program is reused across corrections (same
        # shapes -> one compile).
        b64 = np.asarray(b, dtype=np.float64)
        bnorm = np.linalg.norm(b64) or 1.0
        x = np.zeros_like(b64)
        total_iters, cond = 0, float("nan")
        hist = []
        pass_iters = []
        import os
        for step in range(refine):
            r64 = b64 - A.matvec(x)
            rel = np.linalg.norm(r64) / bnorm
            hist.append(rel)
            if os.environ.get("TPUAMG_VERBOSE"):
                print(f"[refine] step={step} true_rel={rel:.3e}",
                      flush=True)
            if rel < tol:
                break
            # same vector dtype the initial solve used — a second dtype
            # here would re-trace the Krylov program (minutes of XLA
            # compile)
            kdt_r = vec_dtype
            if slots is not None:
                rdev = jnp.zeros(nsl, dtype=kdt_r).at[
                    jnp.asarray(slots)].set(
                        jnp.asarray(r64, dtype=kdt_r))
            else:
                rdev = jnp.asarray(r64, dtype=kdt_r)
            d, res = _run(rdev, inner_tol, maxiter)
            if step == 0 and method == "cg":
                cond = res.cond
            total_iters += res.niters
            pass_iters.append(int(res.niters))
            x = x + d
        rel = np.linalg.norm(b64 - A.matvec(x)) / bnorm
        hist.append(rel)
        t_solve = time.time() - t0
        return SolveReport(
            x=x, niters=total_iters, converged=bool(rel < tol), cond=cond,
            r_norm=float(rel), t_setup=t_setup, t_solve=t_solve,
            residuals=np.asarray(hist), pass_iters=tuple(pass_iters))

    x, res = _run(bj, tol, maxiter)
    cond = res.cond if method == "cg" else float("nan")
    t_solve = time.time() - t0
    for _ in range(int(timing_runs) - 1):
        t0 = time.time()
        _run(bj, tol, maxiter)
        t_solve = time.time() - t0
    return SolveReport(
        x=x, niters=res.niters, converged=res.converged, cond=cond,
        r_norm=float(res.residuals[-1]), t_setup=t_setup, t_solve=t_solve,
        residuals=res.residuals)
