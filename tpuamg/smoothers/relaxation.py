"""Pointwise relaxation smoothers (jittable pytrees).

Device stand-ins for HAZmath's smoother menu
(JACOBI/GS/SGS/SOR/SSOR/L1DIAG, ``/root/reference/src/amg_parameters.py:9``,
``input_metric.dat`` smoother key; SURVEY.md §2b "HAZmath smoothers"):

- (weighted/l1-)Jacobi: embarrassingly parallel, one fused SpMV+axpy.
- Multicolor Gauss-Seidel / symmetric GS: *exact* GS up to row ordering —
  the sequential dependence is resolved by graph coloring (host-side greedy
  coloring at setup); each color's update is a batched independent row
  update, so a full sweep is a fixed sequence of partial SpMVs. This is the
  established parallel equivalent of HAZmath's SGS (same smoothing factor
  class, different row order).
- Chebyshev: matrix-power polynomial smoother, one SpMV per step and no
  sequential dependence; eigenvalue bound from host power iteration at
  setup.

Each smoother is a registered pytree with a
``smooth(A, x, b) -> x`` method usable inside jit.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR, ELL, ell_rows, greedy_color


@jax.tree_util.register_pytree_node_class
class JacobiSmoother:
    def __init__(self, invd, omega=1.0):
        self.invd = invd
        self.omega = omega

    def tree_flatten(self):
        return (self.invd, self.omega), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch)

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        for _ in range(iters):
            x = x + self.omega * self.invd * (b - A.matvec(x))
        return x


@jax.tree_util.register_pytree_node_class
class L1JacobiSmoother(JacobiSmoother):
    """Jacobi with the l1 diagonal  d_i = sum_j |a_ij|  — unconditionally
    convergent for SPD A; the reference's L1DIAG option."""


def build_jacobi(A_host: HostCSR, omega=1.0, dtype=jnp.float32):
    d = A_host.diagonal()
    return JacobiSmoother(jnp.asarray(1.0 / d, dtype=dtype), omega)


def build_l1_jacobi(A_host: HostCSR, dtype=jnp.float32):
    r, c, v = A_host.to_coo()
    l1 = np.zeros(A_host.shape[0])
    np.add.at(l1, r, np.abs(v))
    return L1JacobiSmoother(jnp.asarray(1.0 / l1, dtype=dtype), 1.0)


@jax.tree_util.register_pytree_node_class
class MulticolorGS:
    """Multicolor (symmetric) Gauss-Seidel.

    color_rows[c]: ELL slice of A's rows for color c.
    color_ids[c]: row indices of color c.
    color_invd[c]: 1/diag for those rows (includes relaxation weight).
    """

    def __init__(self, color_rows, color_ids, color_invd, omega=1.0,
                 symmetric=True):
        self.color_rows = tuple(color_rows)
        self.color_ids = tuple(color_ids)
        self.color_invd = tuple(color_invd)
        self.omega = omega
        self.symmetric = symmetric

    def tree_flatten(self):
        return ((self.color_rows, self.color_ids, self.color_invd,
                 self.omega), (self.symmetric,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        rows, ids, invd, om = ch
        return cls(rows, ids, invd, om, aux[0])

    def _half_sweep(self, x, b, order):
        for c in order:
            Ac, ids, invd = (self.color_rows[c], self.color_ids[c],
                             self.color_invd[c])
            r = b[ids] - Ac.matvec(x)
            x = x.at[ids].add(self.omega * invd * r)
        return x

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        ncol = len(self.color_rows)
        fwd = tuple(range(ncol))
        if reverse and not self.symmetric:
            fwd = fwd[::-1]   # transpose sweep: keeps the cycle symmetric
        for _ in range(iters):
            x = self._half_sweep(x, b, fwd)
            if self.symmetric:
                x = self._half_sweep(x, b, fwd[::-1])
        return x


def build_multicolor_gs(A_host: HostCSR, omega=1.0, symmetric=True,
                        active=None, max_colors=24, dtype=jnp.float32):
    """active: optional bool mask / index set — only these rows are updated
    (used by the metric smoother to GS the non-interface dofs only,
    /root/reference/src/utils.py:84).

    Rows in the overflow color group (see greedy_color) may share edges;
    they get l1-diagonal damping instead of 1/diag, which keeps the sweep
    convergent for SPD A whatever the group topology."""
    colors = greedy_color(A_host, max_colors=max_colors)
    d = A_host.diagonal()
    overflow = int(colors.max()) == max_colors
    if overflow:
        r, _, v = A_host.to_coo()
        l1 = np.zeros(A_host.shape[0])
        np.add.at(l1, r, np.abs(v))
    ncol = int(colors.max()) + 1
    act = np.ones(A_host.shape[0], dtype=bool)
    if active is not None:
        active = np.asarray(active)
        if active.dtype == bool:
            act = active
        else:
            act[:] = False
            act[active] = True
    rows, ids_l, invd_l = [], [], []
    for c in range(ncol):
        ids = np.flatnonzero((colors == c) & act)
        if len(ids) == 0:
            continue
        rows.append(ELL.from_host(slice_rows(A_host, ids), dtype=dtype))
        ids_l.append(jnp.asarray(ids, dtype=jnp.int32))
        scale = d[ids] if not (overflow and c == max_colors) else l1[ids]
        invd_l.append(jnp.asarray(1.0 / scale, dtype=dtype))
    return MulticolorGS(rows, ids_l, invd_l, omega, symmetric)


def slice_rows(A: HostCSR, ids) -> HostCSR:
    """A[ids, :] as a new HostCSR (vectorized)."""
    rank = np.full(A.shape[0], -1, dtype=np.int64)
    rank[np.asarray(ids)] = np.arange(len(ids))
    r, c, v = A.to_coo()
    m = rank[r] >= 0
    return HostCSR.from_coo(rank[r[m]], c[m], v[m],
                            (len(ids), A.shape[1]), sum_duplicates=False)


@jax.tree_util.register_pytree_node_class
class ChebyshevSmoother:
    """Chebyshev polynomial smoother on D^{-1}A over [lmax/ratio, lmax]."""

    def __init__(self, invd, lmax, lmin, degree=3):
        self.invd = invd
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree

    def tree_flatten(self):
        return ((self.invd, self.lmax, self.lmin), (self.degree,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        invd, lmax, lmin = ch
        return cls(invd, lmax, lmin, aux[0])

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        # standard 3-term Chebyshev iteration (Saad) on D^{-1}A
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma1 = theta / delta
        for _ in range(iters):
            rho = 1.0 / sigma1
            r = self.invd * (b - A.matvec(x))
            d = r / theta
            for _k in range(1, self.degree):
                x = x + d
                r = self.invd * (b - A.matvec(x))
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = rho_new * rho * d + (2.0 * rho_new / delta) * r
                rho = rho_new
            x = x + d
        return x


def cheb_coefs(lmax, lmin, degree, kind=1):
    """Coefficients of the degree-`degree` polynomial smoother recurrence

        d_1 = r_0 / theta;   d_k = a_k d_{k-1} + c_k r_{k-1};  x += d_k

    kind=1: classical first-kind Chebyshev on [lmin, lmax].
    kind=4: fourth-kind Chebyshev (Lottes, 'Optimal polynomial smoothers
    for multigrid', arXiv:2202.08830 family — see PAPERS.md): needs only
    the UPPER spectral bound (lmin ignored), damps the whole [0, lmax]
    band as a smoother should, and typically beats first-kind inside
    multigrid where the smoother must complement coarse correction
    rather than minimize the residual on a band."""
    if kind == 4:
        theta = 0.75 * lmax                       # d_1 = 4/(3 lmax) r_0
        coefs = []
        for k in range(1, degree):
            ak = (2.0 * k - 1.0) / (2.0 * k + 3.0)
            ck = (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lmax)
            coefs.append((float(ak), float(ck)))
        return float(theta), tuple(coefs)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coefs = []
    for _k in range(1, degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coefs.append((float(rho_new * rho), float(2.0 * rho_new / delta)))
        rho = rho_new
    return float(theta), tuple(coefs)


def estimate_lmax_dinv_a(A_host: HostCSR, iters=20, seed=0, invd=None):
    """Power iteration for rho(D^{-1} A) on host (invd: optional
    masked/custom inverse diagonal)."""
    rng = np.random.default_rng(seed)
    if invd is None:
        invd = 1.0 / A_host.diagonal()
    x = rng.standard_normal(A_host.shape[0]) * (invd != 0)
    lam = 1.0
    for _ in range(iters):
        y = A_host.matvec(x) * invd
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def build_chebyshev(A_host: HostCSR, degree=3, ratio=8.0,
                    dtype=jnp.float32, active=None):
    """active: optional bool mask / index set — updates are restricted
    to these rows (zero inverse diagonal elsewhere), which makes the
    sweep EXACTLY Chebyshev on the principal submatrix A[act, act] (the
    masked rows of x never change, so the masked residual is the
    submatrix residual).  The gather-light alternative to multicolor GS
    for the metric smoother's non-interface block: one SpMV per
    residual instead of ~2 gather+scatter ops per color."""
    d = A_host.diagonal()
    invd = 1.0 / d
    if active is not None:
        act = np.asarray(active)
        if act.dtype != bool:
            m = np.zeros(A_host.shape[0], dtype=bool)
            m[act] = True
            act = m
        invd = np.where(act, invd, 0.0)
    lmax = 1.1 * estimate_lmax_dinv_a(A_host, invd=invd)
    return ChebyshevSmoother(jnp.asarray(invd, dtype=dtype),
                             lmax, lmax / ratio, degree)
