"""Method of Manufactured Solutions, derived with JAX autodiff.

The reference derives forcing terms and fluxes symbolically with sympy+ulfy
(reference src/bidomain_2d.py:7-48).  The JAX equivalent:
write the exact solution as a JAX scalar function and obtain fluxes and
forcings by ``jax.grad``/``jax.jacfwd`` — no symbolic layer, exact to
machine precision, and jit-compiled for fast vectorized evaluation during
assembly and error computation.

All evaluators returned here are numpy-in/numpy-out (host assembly side).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _cpu_device():
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def vectorize(f_scalar):
    """(gdim,) -> scalar  ==>  (n, gdim) -> (n,) numpy evaluator.

    Pinned to the CPU backend: MMS evaluation feeds *host-side* assembly
    and error quadrature; shipping millions of quadrature points to an
    accelerator and back would dominate setup time."""
    fv = jax.jit(jax.vmap(f_scalar))

    def call(pts):
        cpu = _cpu_device()
        with jax.default_device(cpu):
            return np.asarray(fv(jnp.asarray(pts, dtype=jnp.float64)))
    return call


def vectorize_vec(f_vec):
    """(gdim,) -> (k,)  ==>  (n, gdim) -> (n, k) numpy evaluator."""
    fv = jax.jit(jax.vmap(f_vec))

    def call(pts):
        cpu = _cpu_device()
        with jax.default_device(cpu):
            return np.asarray(fv(jnp.asarray(pts, dtype=jnp.float64)))
    return call


def grad(u):
    return jax.grad(u)


def div(F):
    """Divergence of a vector field F: (g,) -> (g,)."""
    def d(x):
        return jnp.trace(jax.jacfwd(F)(x))
    return d


def setup_bidomain_strip_mms(params, width=0.125):
    """Exact data for the STRIP-coupled bidomain system of the GMG
    comparison path (/root/reference/src/bidomain_2d_firedrake.py:63-66):
    the gamma-coupling acts only on |x - 0.5| <= width.

    The reference reuses a globally-coupled forcing with the strip
    operator (bidomain_2d_firedrake.py:28 vs :68), which makes its H1
    errors gamma-inconsistent; here the MMS is constructed so the
    coupling term vanishes on the exact solution:  u2 = u1 - psi with
    psi(x) = ((|x-0.5| - width)_+)^3 = 0 inside the strip (C^2 smooth).
    Then f_i = -div(kappa_i grad u_i) with NO coupling forcing, and the
    system is exactly consistent at every gamma (strip edges are
    mesh-aligned for width=0.125 and n a multiple of 8)."""
    k1, k2 = float(params.kappa1), float(params.kappa2)
    w = float(width)

    def u1(x):
        return jnp.cos(jnp.pi * (x[0] + x[1]))

    def psi(x):
        return jnp.maximum(jnp.abs(x[0] - 0.5) - w, 0.0) ** 3

    def u2(x):
        return u1(x) - psi(x)

    def sigma1(x):
        return -k1 * jax.grad(u1)(x)

    def sigma2(x):
        return -k2 * jax.grad(u2)(x)

    def f1(x):
        return div(sigma1)(x)

    def f2(x):
        return div(sigma2)(x)

    return {
        "u1": vectorize(u1), "u2": vectorize(u2),
        "grad_u1": vectorize_vec(jax.grad(u1)),
        "grad_u2": vectorize_vec(jax.grad(u2)),
        "flux1": vectorize_vec(sigma1), "flux2": vectorize_vec(sigma2),
        "f1": vectorize(f1), "f2": vectorize(f2),
    }


def setup_bidomain_mms(params, dim=2):
    """Exact data for the coupled bidomain system
        -div(kappa1 grad u1) + gamma (u1 - u2) = f1
        -div(kappa2 grad u2) + gamma (u2 - u1) = f2
    2D: u1 = cos(pi (x+y)), u2 = sin(pi (x-y))
        (/root/reference/src/bidomain_2d.py:21-22)
    3D: u1 = cos(pi (x+y+2z)), u2 = sin(pi (x-y+z))
        (/root/reference/src/bidomain_3d.py:21-22)
    Returns dict of numpy evaluators: u1, u2, grad_u1, grad_u2, flux1,
    flux2 (sigma_i = -kappa_i grad u_i), f1, f2.
    """
    k1, k2, g = float(params.kappa1), float(params.kappa2), float(params.gamma)

    if dim == 2:
        def u1(x):
            return jnp.cos(jnp.pi * (x[0] + x[1]))

        def u2(x):
            return jnp.sin(jnp.pi * (x[0] - x[1]))
    else:
        def u1(x):
            return jnp.cos(jnp.pi * (x[0] + x[1] + 2 * x[2]))

        def u2(x):
            return jnp.sin(jnp.pi * (x[0] - x[1] + x[2]))

    def sigma1(x):
        return -k1 * jax.grad(u1)(x)

    def sigma2(x):
        return -k2 * jax.grad(u2)(x)

    def f1(x):
        return div(sigma1)(x) + g * (u1(x) - u2(x))

    def f2(x):
        return div(sigma2)(x) + g * (u2(x) - u1(x))

    return {
        "u1": vectorize(u1), "u2": vectorize(u2),
        "grad_u1": vectorize_vec(jax.grad(u1)),
        "grad_u2": vectorize_vec(jax.grad(u2)),
        "flux1": vectorize_vec(sigma1), "flux2": vectorize_vec(sigma2),
        "f1": vectorize(f1), "f2": vectorize(f2),
    }


def setup_emi_mms(params, dim=2):
    """Exact data for the EMI interface-coupled problem
        -div(kappa_i grad u_i) = f_i  in Omega_i,
    coupled through the interface by -sigma.n = gamma (u1 - u2) + g_r.
    2D: u1 = cos(pi(x+y)), u2 = sin(pi(x+y)); interface y = 0.5,
        n1 = (0,-1), n2 = (0,1)  (/root/reference/src/emi_2d.py:20-53).
    3D: u1 = cos(pi(x+y+2z)), u2 = sin(pi(x+y-z)); interface z = 0.5,
        n1 = (0,0,-1), n2 = (0,0,1)  (/root/reference/src/emi_3d.py:20-55).
    NOTE: here sigma_i = +kappa_i grad(u_i) (sign convention of the
    reference EMI scripts).
    """
    k1, k2, g = float(params.kappa1), float(params.kappa2), float(params.gamma)

    if dim == 2:
        def u1(x):
            return jnp.cos(jnp.pi * (x[0] + x[1]))

        def u2(x):
            return jnp.sin(jnp.pi * (x[0] + x[1]))
        n1 = np.array([0.0, -1.0])
        n2 = np.array([0.0, 1.0])
    else:
        def u1(x):
            return jnp.cos(jnp.pi * (x[0] + x[1] + 2 * x[2]))

        def u2(x):
            return jnp.sin(jnp.pi * (x[0] + x[1] - x[2]))
        n1 = np.array([0.0, 0.0, -1.0])
        n2 = np.array([0.0, 0.0, 1.0])

    def sigma1(x):
        return k1 * jax.grad(u1)(x)

    def sigma2(x):
        return k2 * jax.grad(u2)(x)

    def f1(x):
        return -div(sigma1)(x)

    def f2(x):
        return -div(sigma2)(x)

    n1j, n2j = jnp.asarray(n1), jnp.asarray(n2)

    def g_n(x):
        return -jnp.dot(sigma1(x), n1j) - jnp.dot(sigma2(x), n2j)

    def g_r(x):
        return -jnp.dot(sigma1(x), n1j) - g * (u1(x) - u2(x))

    return {
        "u1": vectorize(u1), "u2": vectorize(u2),
        "grad_u1": vectorize_vec(jax.grad(u1)),
        "grad_u2": vectorize_vec(jax.grad(u2)),
        "flux1": vectorize_vec(sigma1), "flux2": vectorize_vec(sigma2),
        "f1": vectorize(f1), "f2": vectorize(f2),
        "g_n": vectorize(g_n), "g_r": vectorize(g_r),
    }
