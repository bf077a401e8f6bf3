"""Experiment: gamma-subspace deflation on the structured 3D-1D path.

The metric term is gamma * R^T Mq R with R = [-Pi, I] (emi_3d1d block
layout: x = [x3, x1]).  As gamma grows, A's dominant eigenspace is
range(R^T); window coarse spaces don't resolve it (iters 9 -> 30 over 10
decades).  Test: add the exact low-rank correction

    B r = Vcycle(r) + R^T (R A R^T)^{-1} R r

(SPD sum), which solves the gamma-heavy subspace exactly at O(n1^2) setup
+ O(n1 * nnz(R)) apply cost.

  JAX_PLATFORMS=cpu python scripts/exp_deflation.py [n]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from tpuamg.fem import unit_cube_mesh
from tpuamg.fem.assembly import mass_matrix
from tpuamg.fem.coupling import average_matrix
from tpuamg.problems.emi_3d1d import synthetic_neuron_curve, get_system
from tpuamg.amg import as_operator
from tpuamg.amg.structured import setup_structured
from tpuamg.sparse import ELL, matvec_op
from tpuamg.krylov import pcg
from tpuamg.config import AMGParameters


def system(gamma, n):
    mesh3d = unit_cube_mesh(n)
    curve = synthetic_neuron_curve(n_main=16, n_branches=2)
    A, b, sizes = get_system(mesh3d, curve, k3=3.0, k1=7.0 * np.pi * 0.04,
                             gamma=gamma * 2 * np.pi * 0.2,
                             coupling_radius=0.2)
    coords = np.concatenate([mesh3d.vertices, curve.vertices])
    Pi = average_matrix(mesh3d, curve, radius=0.2, degree=10)
    return A, b, sizes, coords, Pi


def _apply(nsl, data, r):
    slots, Rd, Cinv, Mop = data
    rs = jnp.zeros(nsl, dtype=r.dtype).at[slots].set(r)
    y = Mop(rs)[slots]
    rr = Rd @ r
    y = y + Rd.T @ (Cinv @ rr)
    return y


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    gammas = [1e0, 1e2, 1e4, 1e6, 1e8, 1e10]
    prm = AMGParameters(cycle_type="v", dtype="float64", schwarz_levels=2)
    for deflate in (False, True):
        iters = []
        for g in gammas:
            A, b, sizes, coords, Pi = system(g, n)
            n3, n1 = sizes
            idofs = np.arange(n3, n3 + n1)
            prec, slots, nsl = setup_structured(
                A, coords, prm, dtype=np.float64,
                idofs=idofs, order="morton")
            Mop = as_operator(prec)
            R = np.zeros((n1, n3 + n1))
            R[:, :n3] = -Pi.toarray()
            R[:, n3:] = np.eye(n1)
            if deflate:
                ARt = np.stack([A.matvec(R[i]) for i in range(n1)],
                               axis=1)                      # (n, n1)
                Cinv = np.linalg.inv(R @ ARt)
            else:
                Cinv = np.zeros((n1, n1))
            from functools import partial
            data = (jnp.asarray(slots), jnp.asarray(R),
                    jnp.asarray(Cinv), Mop)
            M = jax.tree_util.Partial(partial(_apply, nsl), data)
            Aop = matvec_op(ELL.from_host(A, dtype=jnp.float64))
            t0 = time.time()
            res = pcg(Aop, jnp.asarray(b), M=M, tol=1e-8, maxiter=200)
            iters.append(res.niters if res.converged else -res.niters)
        print(f"deflate={deflate}  iters={iters}", flush=True)


if __name__ == "__main__":
    main()
