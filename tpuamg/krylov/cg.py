"""Preconditioned Conjugate Gradient, fully jittable, with the diagnostics
surface of cbc.block's ConjGrad (SURVEY.md §2b "cbc.block"):

- residual history (B-inner-product norms sqrt(r·z), as cbc.block records)
  plus true l2 recurrence-residual history,
- Lanczos coefficients (alpha/beta) -> tridiagonal eigenvalue estimates
  -> condition number of the preconditioned operator
  (/root/reference/src/bidomain_2d.py:213-216),
- relative-tolerance stopping `sqrt(rz) < tol * sqrt(rz0)`,
- arbitrary linear-operator preconditioners.

The iterations run in fixed-length jitted chunks (`lax.scan`) with one
host convergence check per chunk, so the solve stays on the device between
checks, mirroring the reference's "everything in C" fast path
(reference src/utils.py:119) rather than its Python-per-iteration
slow path.  The preconditioner is traced into one program only: the
initial z = M r0 is the first (dummy) step of the first chunk.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class CGResult:
    x: object
    niters: int
    converged: bool
    residuals: np.ndarray        # sqrt(r·z) history, length niters+1
    true_residuals: np.ndarray   # ||r||_2 recurrence history
    alphas: np.ndarray
    betas: np.ndarray

    def eigenvalue_estimates(self):
        """Eigenvalue estimates of B·A from the CG Lanczos tridiagonal
        (the cbc.block `eigenvalue_estimates` contract)."""
        k = len(self.alphas)
        if k == 0:
            return np.array([1.0])
        a = np.asarray(self.alphas, dtype=np.float64)
        b = np.asarray(self.betas, dtype=np.float64)
        diag = 1.0 / a
        diag[1:] += b[:-1] / a[:-1]
        off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
        return np.linalg.eigvalsh(
            np.diag(diag) + np.diag(off, 1) + np.diag(off, -1))

    @property
    def cond(self):
        ev = self.eigenvalue_estimates()
        lo = ev.min()
        return float(ev.max() / lo) if lo > 0 else float("inf")


def _identity(r):
    return r


_TINY = 1e-300


@jax.jit
def _residual(A, b, x0):
    return b - A(x0)


@partial(jax.jit, static_argnames=("chunk",))
def _pcg_scan_chunk(A, M, x, r, z, p, rz, chunk):
    """`chunk` PCG iterations as ONE fixed-trip-count scan.

    Convergence is checked on the host between chunks, so the loop has
    no data-dependent condition.  Per-iteration scalars leave via scan's
    stacked outputs, and breakdown safety is safe-divides instead of
    masking (overshooting a converged state is a no-op: alpha -> 0).
    Whether a device-side `while_loop` is faster on the GPU is an open
    measurement.

    Started from (x0, r0, z=0, p=0, rz=1), the first step is the PCG
    initialisation, exactly: alpha*p and A(p) are zero, so x and r keep
    their values, z = M r0, rz = r0.z, and p = z + rz*0 = z.  The
    preconditioner is thus compiled once, inside this program.
    """
    tiny = jnp.asarray(_TINY if r.dtype == jnp.float64 else 1e-30, r.dtype)

    def step(s, _):
        x, r, z, p, rz = s
        Ap = A(p)
        pAp = jnp.vdot(p, Ap).real
        alpha = rz / (pAp + tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z).real
        beta = rz_new / (rz + tiny)
        p = z + beta * p
        out = jnp.stack([alpha, beta, jnp.sqrt(jnp.abs(rz_new)),
                         jnp.linalg.norm(r), jnp.linalg.norm(x)])
        return (x, r, z, p, rz_new), out

    state, outs = jax.lax.scan(step, (x, r, z, p, rz), None, length=chunk)
    return state, outs


@jax.jit
def _split_init_down(A, fine, b, x0):
    r = b - A(x0)
    carry, rc = fine.cycle_down(r)
    return r, carry, rc


@jax.jit
def _split_init_up(fine, carry, ec, r):
    z = fine.cycle_up(carry, ec).astype(r.dtype)
    rz = jnp.vdot(r, z).real
    return z, rz, jnp.linalg.norm(r)


@jax.jit
def _split_down(A, fine, x, r, p, rz):
    tiny = jnp.asarray(_TINY if r.dtype == jnp.float64 else 1e-30,
                       r.dtype)
    Ap = A(p)
    pAp = jnp.vdot(p, Ap).real
    alpha = rz / (pAp + tiny)
    x = x + alpha * p
    r = r - alpha * Ap
    carry, rc = fine.cycle_down(r)
    return x, r, carry, rc, alpha


@jax.jit
def _split_up(fine, carry, ec, x, r, p, rz, alpha):
    tiny = jnp.asarray(_TINY if r.dtype == jnp.float64 else 1e-30,
                       r.dtype)
    z = fine.cycle_up(carry, ec).astype(r.dtype)
    rz_new = jnp.vdot(r, z).real
    beta = rz_new / (rz + tiny)
    p = z + beta * p
    out = jnp.stack([alpha.astype(r.dtype), beta,
                     jnp.sqrt(jnp.abs(rz_new)),
                     jnp.linalg.norm(r), jnp.linalg.norm(x)])
    return z, p, rz_new, out


def pcg_split(A, b, fine, tail_apply, x0=None, tol=1e-8, maxiter=500,
              callback=None, stop_type=2, ec_dtype=None):
    """PCG whose preconditioner is a split V-cycle with a HOST step:
    per iteration, device launch 1 runs the outer matvec + x/r updates
    + the fine (structured) levels' pre-smooth/restrict chain down to
    the coarse boundary, the host applies the f64 algebraic tail to
    the (small) boundary residual, and device launch 2 prolongs back
    up, post-smooths, and completes the CG recurrence.

    Trades the on-device tail cycle for two small transfers + a host
    cycle (amg.structured.HostTailHybrid).  Numerically identical to
    pcg(chunk=1) over the unified hybrid for cycle='v', maxit=1.

    fine: MGPreconditioner pytree (device levels only).
    tail_apply: host callable rc(np) -> ec(np) in f64.
    ec_dtype: upload dtype of the tail correction (default: the
    boundary residual's dtype — the unified cycle casts it there
    anyway, so a narrow upload loses nothing)."""
    Afn = A.matvec if hasattr(A, "matvec") else A
    if not isinstance(Afn, jax.tree_util.Partial):
        Afn = jax.tree_util.Partial(Afn)
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    maxiter = int(maxiter)
    r, carry, rc = _split_init_down(Afn, fine, b, x0)
    rc_np = np.asarray(rc)
    if ec_dtype is None:
        ec_dtype = rc_np.dtype
    ec = jnp.asarray(tail_apply(rc_np), dtype=ec_dtype)
    z, rz, rnorm0 = _split_init_up(fine, carry, ec, r)
    p = z
    x = x0
    rz0 = float(rz)
    res0 = float(np.sqrt(max(rz0, 0.0)))
    res_hist = [res0]
    true_hist = [float(rnorm0)]
    norm_b = float(jnp.linalg.norm(b)) if stop_type == 1 else 0.0
    alphas, betas = [], []
    k = 0
    if stop_type == 1:
        converged = float(rnorm0) <= tol * norm_b or norm_b == 0.0
    else:
        converged = res0 == 0.0
    import os
    verbose = bool(os.environ.get("TPUAMG_VERBOSE"))
    while not converged and k < maxiter:
        x, r, carry, rc, alpha = _split_down(Afn, fine, x, r, p, rz)
        ec = jnp.asarray(tail_apply(np.asarray(rc)), dtype=ec_dtype)
        z, p, rz, out = _split_up(fine, carry, ec, x, r, p, rz, alpha)
        o = np.asarray(out)     # alpha beta res true xnorm
        if verbose and k % 5 == 0:
            print(f"[pcg_split] it={k} res={o[2]:.3e} true={o[3]:.3e}",
                  flush=True)
        if not np.isfinite(o[2]):
            break               # breakdown: stop, report as-is
        alphas.append(o[0])
        betas.append(o[1])
        res_hist.append(o[2])
        true_hist.append(o[3])
        k += 1
        if stop_type == 1:
            converged = o[3] <= tol * norm_b
        elif stop_type == 3:
            converged = o[3] <= tol * max(o[4], _TINY)
        else:
            converged = o[2] <= tol * res0
    true = np.asarray(true_hist)
    if callback is not None:
        for i in range(1, k + 1):
            callback(i, None, true[i])
    return CGResult(x=x, niters=k, converged=bool(converged),
                    residuals=np.asarray(res_hist), true_residuals=true,
                    alphas=np.asarray(alphas), betas=np.asarray(betas))


def pcg(A, b, M=None, x0=None, tol=1e-8, maxiter=500, callback=None,
        chunk=32, stop_type=2):
    """Solve A x = b with PCG; returns CGResult.

    A, M: callables (matvec) or objects with .matvec.

    stop_type selects the convergence test, mirroring HAZmath's
    ``linear_stop_type`` (/root/reference/src/input_metric.dat:54):
      1 = ||r||_2 / ||b||_2        (STOP_REL_RES)
      2 = ||r||_B / ||r0||_B       (STOP_REL_PRECRES; preconditioned norm —
          equals HAZmath's sqrt(r'Br)/sqrt(b'Bb) for x0=0, and matches the
          reference's cbc.block ConjGrad use,
          /root/reference/src/bidomain_2d.py:205) — the default
      3 = ||r||_2 / ||x||_2        (STOP_MOD_REL_RES)

    Runs in fixed-size jitted chunks with host-side convergence checks in
    between (see _pcg_scan_chunk).
    """
    Afn = A.matvec if hasattr(A, "matvec") else A
    Mfn = (M.matvec if hasattr(M, "matvec") else M) if M is not None \
        else _identity
    # Operators enter the jitted kernel as pytree-of-data callables so the
    # compile cache keys on *structure*, not Python object identity — never
    # as closure constants (minutes-long compiles; docs/PERF_NOTES.md).
    if not isinstance(Afn, jax.tree_util.Partial):
        Afn = jax.tree_util.Partial(Afn)
    if not isinstance(Mfn, jax.tree_util.Partial):
        Mfn = jax.tree_util.Partial(Mfn)
    b = jnp.asarray(b)
    if x0 is None:
        x, r = jnp.zeros_like(b), b
    else:
        x = jnp.asarray(x0)
        r = _residual(Afn, b, x)
    maxiter = int(maxiter)
    chunk = max(1, min(int(chunk), maxiter))
    zero = jnp.zeros_like(b)
    # the first chunk's first step is the initialisation (z0 = M r0)
    state, outs = _pcg_scan_chunk(Afn, Mfn, x, r, zero, zero,
                                  jnp.ones((), dtype=b.dtype), chunk)
    o = np.asarray(outs)       # (chunk, 5): alpha beta res true xnorm
    res0, rnorm0 = float(o[0, 2]), float(o[0, 3])
    o = o[1:]
    res_hist = [res0]
    true_hist = [rnorm0]
    norm_b = float(jnp.linalg.norm(b)) if stop_type == 1 else 0.0
    alphas, betas = [], []
    k = 0
    if stop_type == 1:
        converged = rnorm0 <= tol * norm_b or norm_b == 0.0
    else:
        converged = res0 == 0.0

    def _crossed(o):
        """Per-iteration convergence indicator for the selected test."""
        if stop_type == 1:
            return o[:, 3] <= tol * norm_b
        if stop_type == 3:
            return o[:, 3] <= tol * np.maximum(o[:, 4], _TINY)
        return o[:, 2] <= tol * res0

    while not converged and k < maxiter:
        if not len(o):
            state, outs = _pcg_scan_chunk(Afn, Mfn, *state, chunk)
            o = np.asarray(outs)
        # find the first in-chunk convergence crossing and truncate there
        cross = _crossed(o)
        hit = np.flatnonzero(cross | ~np.isfinite(o[:, 2]))
        take = int(hit[0]) + 1 if len(hit) else len(o)
        take = min(take, maxiter - k)
        alphas.extend(o[:take, 0].tolist())
        betas.extend(o[:take, 1].tolist())
        res_hist.extend(o[:take, 2].tolist())
        true_hist.extend(o[:take, 3].tolist())
        k += take
        converged = len(hit) > 0 and np.isfinite(o[hit[0], 2]) \
            and bool(cross[hit[0]])
        if len(hit) and not converged:
            break     # breakdown (non-finite residual): stop, report as-is
        o = o[:0]
    x = state[0]
    res = np.asarray(res_hist)
    true = np.asarray(true_hist)
    if callback is not None:
        for i in range(1, k + 1):
            callback(i, None, true[i])
    return CGResult(x=x, niters=k, converged=bool(converged),
                    residuals=res, true_residuals=true,
                    alphas=np.asarray(alphas), betas=np.asarray(betas))
