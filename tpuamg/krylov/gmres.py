"""Restarted preconditioned GMRES (jittable).

Completes the reference's Krylov selector (CG/MINRES/GMRES,
``/root/reference/src/input_metric.dat`` linear_itsolver_type) for
nonsymmetric operators.  Fixed-size Krylov basis per restart cycle keeps
shapes static under jit; Arnoldi via CGS2 inside ``lax.fori_loop``.

Diagnostics contract matches the CG/MinRes standard in this package:
per-iteration residual history and exact ``niters`` at mid-cycle
convergence.  The device program is one Arnoldi cycle (static shapes);
the (m+1, m) Hessenberg least-squares problems — one per Arnoldi step,
needed for the per-step residual norms — are solved on host where an
m<=30 triangular solve is free.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class GmresResult:
    x: object
    niters: int
    converged: bool
    residuals: np.ndarray    # preconditioned-residual norm per iteration


@partial(jax.jit, static_argnames=("restart",))
def _arnoldi_cycle(A, M, b, x0, restart):
    """One Arnoldi build of size ``restart``: returns (V, H, beta)."""
    dtype = b.dtype
    n = b.shape[0]
    m = restart
    r = M(b - A(x0))
    beta = jnp.linalg.norm(r)
    V = jnp.zeros((m + 1, n), dtype=dtype)
    H = jnp.zeros((m + 1, m), dtype=dtype)
    V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))

    def arnoldi_step(j, carry):
        # Masked classical Gram-Schmidt with reorthogonalization (CGS2):
        # two (m+1, n) @ (n,) products instead of a sequential
        # per-vector MGS loop; CGS2 is as stable as MGS in practice.
        V, H = carry
        w = M(A(V[j]))
        mask = (jnp.arange(m + 1) <= j).astype(dtype)
        h1 = jnp.matmul(V, w, precision=jax.lax.Precision.HIGHEST) * mask
        w = w - jnp.matmul(V.T, h1, precision=jax.lax.Precision.HIGHEST)
        h2 = jnp.matmul(V, w, precision=jax.lax.Precision.HIGHEST) * mask
        w = w - jnp.matmul(V.T, h2, precision=jax.lax.Precision.HIGHEST)
        hnorm = jnp.linalg.norm(w)
        H = H.at[:, j].set(h1 + h2)
        H = H.at[j + 1, j].set(hnorm)
        V = V.at[j + 1].set(w / jnp.where(hnorm > 0, hnorm, 1.0))
        return (V, H)

    V, H = jax.lax.fori_loop(0, m, arnoldi_step, (V, H))
    return V, H, beta


@jax.jit
def _apply_update(V, x0, y_pad):
    """x = x0 + V[:m].T @ y (y zero-padded to m keeps shapes static)."""
    return x0 + jnp.matmul(V[:-1].T, y_pad,
                           precision=jax.lax.Precision.HIGHEST)


def _hessenberg_residuals(H, beta):
    """Host-side per-step GMRES residual norms via Givens rotations.

    Returns (res[1..m], ys) where res[j-1] = min_y ||beta e1 - H[:j+1,:j] y||
    and ys[j-1] is the minimizer — the standard progressive-rotation
    recurrence, O(m^2) total on an m<=30 Hessenberg matrix."""
    H = np.asarray(H, dtype=np.float64)
    m = H.shape[1]
    R = H.copy()
    g = np.zeros(m + 1)
    g[0] = beta
    res = np.empty(m)
    ys = []
    rot = []
    for j in range(m):
        for i, (ci, si) in enumerate(rot):   # prior rotations on column j
            t = ci * R[i, j] + si * R[i + 1, j]
            R[i + 1, j] = -si * R[i, j] + ci * R[i + 1, j]
            R[i, j] = t
        d = np.hypot(R[j, j], R[j + 1, j])
        c, s = (1.0, 0.0) if d == 0 else (R[j, j] / d, R[j + 1, j] / d)
        rot.append((c, s))
        R[j, j] = d
        R[j + 1, j] = 0.0
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        res[j] = abs(g[j + 1])
        y = np.zeros(m)
        if d != 0 and not np.any(np.diag(R[:j + 1, :j + 1]) == 0):
            y[:j + 1] = np.linalg.solve(np.triu(R[:j + 1, :j + 1]),
                                        g[:j + 1])
        ys.append(y)
    return res, ys


def gmres(A, b, M=None, x0=None, tol=1e-8, maxiter=500, restart=30):
    """Left-preconditioned restarted GMRES; tolerance is relative on the
    preconditioned residual.  Returns GmresResult with a per-iteration
    residual history and niters exact at mid-cycle convergence."""
    Afn = A.matvec if hasattr(A, "matvec") else A
    Mfn = (M.matvec if hasattr(M, "matvec") else M) if M is not None \
        else (lambda r: r)
    if not isinstance(Afn, jax.tree_util.Partial):
        Afn = jax.tree_util.Partial(Afn)
    if not isinstance(Mfn, jax.tree_util.Partial):
        Mfn = jax.tree_util.Partial(Mfn)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    r0 = float(jnp.linalg.norm(Mfn(b - Afn(x))))
    residuals = [r0]
    target = tol * max(r0, 1e-300)
    niters = 0
    if r0 <= 0.0:
        return GmresResult(x=x, niters=0, converged=True,
                           residuals=np.asarray(residuals))
    while niters < maxiter:
        m = int(min(restart, maxiter - niters))
        V, H, beta = _arnoldi_cycle(Afn, Mfn, b, x, m)
        res, ys = _hessenberg_residuals(H, float(beta))
        hit = np.flatnonzero(res <= target)
        take = int(hit[0]) + 1 if len(hit) else m
        residuals.extend(res[:take].tolist())
        niters += take
        y_pad = jnp.asarray(ys[take - 1], dtype=b.dtype)
        x = _apply_update(V, x, y_pad)
        if len(hit):
            return GmresResult(x=x, niters=niters, converged=True,
                               residuals=np.asarray(residuals))
    return GmresResult(x=x, niters=niters, converged=False,
                       residuals=np.asarray(residuals))
