"""Preconditioned MINRES (jittable), for symmetric indefinite systems.

Covers the reference's Krylov-method selector surface (CG/MINRES/GMRES,
``/root/reference/src/input_metric.dat`` linear_itsolver_type) beyond CG.
Standard Paige–Saunders recurrence with a symmetric-positive preconditioner.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class MinresResult:
    x: object
    niters: int
    converged: bool
    residuals: np.ndarray
    alphas: np.ndarray = None    # Lanczos diagonal (preconditioned op)
    betas: np.ndarray = None     # Lanczos off-diagonal beta_{k+1}

    def eigenvalue_estimates(self):
        """Eigenvalue estimates of M*A from the MINRES Lanczos tridiagonal
        (same diagnostics contract as CGResult — the reference only
        exposes this through CG, /root/reference/src/bidomain_2d.py:215;
        here MINRES reports it too since the alfa/beta recurrence is free)."""
        if self.alphas is None or len(self.alphas) == 0:
            return np.array([1.0])
        a = np.asarray(self.alphas, dtype=np.float64)
        b = np.asarray(self.betas, dtype=np.float64)[:len(a) - 1]
        return np.linalg.eigvalsh(
            np.diag(a) + np.diag(b, 1) + np.diag(b, -1))

    @property
    def cond(self):
        ev = np.abs(self.eigenvalue_estimates())
        lo = ev.min()
        return float(ev.max() / lo) if lo > 0 else float("inf")


@partial(jax.jit, static_argnames=("chunk",))
def _minres_chunk(A, M, state, chunk):
    """`chunk` MINRES iterations as one fixed-trip scan (same design as
    krylov.cg._pcg_scan_chunk: no data-dependent loop conditions, no
    masking, per-step scalars via scan outputs)."""
    def body_fn(s, _):
        (x, r1, r2, y, beta, betaold, dbar, epsln, phibar_, cs, sn,
         w, w2) = s
        tiny = jnp.asarray(1e-300 if r2.dtype == jnp.float64 else 1e-30,
                           r2.dtype)
        beta_safe = jnp.maximum(beta, tiny)
        v = y / beta_safe
        yk = A(v)
        yk = yk - (beta / jnp.maximum(betaold, tiny)) * r1
        alfa = jnp.vdot(v, yk).real
        yk = yk - (alfa / beta_safe) * r2
        r1n, r2n = r2, yk
        yn = M(r2n)
        betaoldn = beta
        betan = jnp.sqrt(jnp.maximum(jnp.vdot(r2n, yn).real, 0))
        # apply previous rotation
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * betan
        dbar_n = -cs * betan
        gamma = jnp.maximum(jnp.sqrt(gbar ** 2 + betan ** 2), tiny)
        cs_n = gbar / gamma
        sn_n = betan / gamma
        phi = cs_n * phibar_
        phibar_n = sn_n * phibar_
        w1 = w2
        w2n = w
        wn = (v - oldeps * w1 - delta * w2n) / gamma
        xn = x + phi * wn
        ns = (xn, r1n, r2n, yn, betan, betaoldn, dbar_n,
              epsln_n, phibar_n, cs_n, sn_n, wn, w2n)
        return ns, jnp.stack([phibar_n, alfa, betan])

    return jax.lax.scan(body_fn, state, None, length=chunk)


def minres(A, b, M=None, x0=None, tol=1e-8, maxiter=500, chunk=32):
    Afn = A.matvec if hasattr(A, "matvec") else A
    Mfn = (M.matvec if hasattr(M, "matvec") else M) if M is not None \
        else (lambda r: r)
    if not isinstance(Afn, jax.tree_util.Partial):
        Afn = jax.tree_util.Partial(Afn)
    if not isinstance(Mfn, jax.tree_util.Partial):
        Mfn = jax.tree_util.Partial(Mfn)
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    dtype = b.dtype
    maxiter = int(maxiter)
    chunk = max(1, min(int(chunk), maxiter))

    r2 = b - Afn(x0)
    # NOTE: the first Lanczos step has no r1 correction; start r1 = 0 so
    # the unconditional (beta/betaold) * r1 term vanishes at k=0.
    r1 = jnp.zeros_like(r2)
    y = Mfn(r2)
    beta = jnp.sqrt(jnp.maximum(jnp.vdot(r2, y).real, 0))
    res0 = float(beta)
    zero = jnp.asarray(0.0, dtype)
    state = (x0, r1, r2, y, beta, jnp.asarray(1.0, dtype), zero, zero,
             beta, jnp.asarray(-1.0, dtype), zero,
             jnp.zeros_like(b), jnp.zeros_like(b))
    res_hist = [res0]
    alphas, betas = [], []
    k = 0
    converged = res0 == 0.0
    while not converged and k < maxiter:
        state, outs = _minres_chunk(Afn, Mfn, state, chunk)
        o = np.asarray(outs)          # (chunk, 3): phibar alfa betan
        ph = o[:, 0]
        hit = np.flatnonzero((ph <= tol * res0) | ~np.isfinite(ph))
        take = int(hit[0]) + 1 if len(hit) else chunk
        take = min(take, maxiter - k)
        res_hist.extend(ph[:take].tolist())
        alphas.extend(o[:take, 1].tolist())
        betas.extend(o[:take, 2].tolist())
        k += take
        converged = len(hit) > 0 and np.isfinite(ph[hit[0]]) \
            and ph[hit[0]] <= tol * res0
        if len(hit) and not converged:
            break
    return MinresResult(x=state[0], niters=k, converged=bool(converged),
                        residuals=np.asarray(res_hist),
                        alphas=np.asarray(alphas),
                        betas=np.asarray(betas))
