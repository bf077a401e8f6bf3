"""Bidomain 2D with a geometric-multigrid comparison path.

Rebuild of /root/reference/src/bidomain_2d_firedrake.py: same bidomain PDE
but (a) coupling localized to a vertical strip |x - 0.5| <= width
(bidomain_2d_firedrake.py:63-66), (b) the preconditioner is a *geometric*
full-multigrid hierarchy — here the grid hierarchy of tpuamg.amg.grid,
whose 2x2 window transfers on the structured mesh play the MeshHierarchy +
P1-prolongation role, with nodal-block Chebyshev standing in for the
Richardson+PatchPC vertex-star smoother (bidomain_2d_firedrake.py:106-125).
``-mg_type amg`` runs the algebraic (ELL/HEM) hierarchy instead — the
hypre-BoomerAMG role (bidomain_2d_firedrake.py:101-102).

Run:  python -m tpuamg.problems.bidomain_2d_gmg -nrefs 3 -gamma 1e4 \
        -mg_type mg -width 0.125
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..fem import mms, tagged_unit_square
from ..fem.assembly import (stiffness_matrix, mass_matrix, load_vector,
                            apply_bc_monolithic)
from ..sparse import bmat
from ..io_utils import print_red
from .bidomain import Params, _neumann_rhs, NEUMANN_TAGS, DIRICHLET_TAGS, \
    compute_errors
from .solve import solve_system
from .driver import ExperimentTables


def get_system_strip(mesh, data, params: Params, width):
    """Bidomain blocks with the gamma-coupling mass restricted to the
    strip |x - 0.5| <= width (bidomain_2d_firedrake.py:63-66)."""
    k1, k2, g = params.kappa1, params.kappa2, params.gamma
    n = mesh.num_vertices
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    in_strip = (np.abs(centers[:, 0] - 0.5) <= width).astype(np.float64)

    K1 = stiffness_matrix(mesh, k1)
    K2 = stiffness_matrix(mesh, k2)
    M = mass_matrix(mesh, coeff=in_strip)

    A = bmat([[K1.add(M, beta=g), M.scale(-g)],
              [M.scale(-g), K2.add(M, beta=g)]])
    b0 = load_vector(mesh, data["f1"]) + _neumann_rhs(
        mesh, data["flux1"], NEUMANN_TAGS)
    b1 = load_vector(mesh, data["f2"]) + _neumann_rhs(
        mesh, data["flux2"], NEUMANN_TAGS)
    b = np.concatenate([b0, b1])

    bd = mesh.boundary_vertices(DIRICHLET_TAGS)
    bc_dofs = np.concatenate([bd, n + bd])
    bc_vals = np.concatenate([data["u1"](mesh.vertices[bd]),
                              data["u2"](mesh.vertices[bd])])
    A, b = apply_bc_monolithic(A, b, bc_dofs, bc_vals)
    return A, b, (n, n)


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-nrefs", type=int, default=1)
    parser.add_argument("-kappa1", type=float, default=2)
    parser.add_argument("-kappa2", type=float, default=3)
    parser.add_argument("-gamma", type=float, default=5)
    parser.add_argument("-width", type=float, default=0.125,
                        help="half-width of the coupling strip")
    parser.add_argument("-mg_type", type=str, default="mg",
                        choices=("amg", "mg"))
    parser.add_argument("-smoother", type=str, default="cheb",
                        choices=("cheb", "patch"),
                        help="mg smoother: nodal-block Chebyshev (the "
                        "default) or 'patch' = vertex-star patch "
                        "relaxation (the firedrake.PatchPC analog, "
                        "bidomain_2d_firedrake.py:113-120: overlapping "
                        "1-level vertex-neighborhood Schwarz blocks, "
                        "exact dense block solves, multiplicative)")
    parser.add_argument("-ncells", type=int, default=8,
                        help="coarse mesh cells (refined nrefs times)")
    args, _ = parser.parse_known_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)

    params = Params(args.kappa1, args.kappa2, args.gamma)
    print_red(f"{params} width={args.width} mg_type={args.mg_type}")
    # strip-consistent MMS: the coupling term vanishes on the exact
    # solution, so H1 rates stay clean at every gamma (the reference
    # reuses the global-coupling forcing and loses consistency at
    # large gamma — see setup_bidomain_strip_mms)
    data = mms.setup_bidomain_strip_mms(params, width=args.width)

    tag = (f"mg{args.mg_type}_kappa1{args.kappa1}_kappa2{args.kappa2}"
           f"_gamma{args.gamma}_width{args.width}")
    tables = ExperimentTables("./results/bidomain_2d_firedrake/", tag)

    n = args.ncells
    for _ in range(args.nrefs):
        n *= 2
        mesh = tagged_unit_square(n)
        A, b, sizes = get_system_strip(mesh, data, params, args.width)
        then = time.time()
        from dataclasses import replace
        from ..config import PRESETS
        if args.mg_type == "mg" and args.smoother == "patch":
            # full-MG + vertex-star patch smoothing: every dof seeds a
            # 1-level neighborhood Schwarz block (= the star of basis
            # functions PatchPC assembles), solved exactly and applied
            # multiplicatively; F-cycle application = PETSc
            # pc_mg_type full (bidomain_2d_firedrake.py:106-125)
            idofs = np.arange(sum(sizes))
            rep = solve_system(A, b, "hazmath_Schwarz", sizes,
                               idofs=idofs,
                               params=replace(PRESETS["standard_schwarz"],
                                              cycle_type="fmg"),
                               tol=1e-10, maxiter=500)
        elif args.mg_type == "mg":
            # geometric grid hierarchy with AMLI(2) acceleration.  The
            # reference's h-robustness comes from P1 transfers + PatchPC
            # (bidomain_2d_firedrake.py:106-125); our window transfers
            # are piecewise-constant (UA), which V/F cycles cannot make
            # h-robust (measured 9->33 iters over 5 refinements) —
            # AMLI(2) polynomial acceleration restores level-independent
            # convergence (measured 11->15 iters, cond plateaus at 2.4,
            # equal at gamma=1 and 1e8; scripts/exp_gmg.py — degree 3
            # saves <1 iteration at ~10x the per-apply cost), the same
            # cure HAZmath applies to UA hierarchies (amli_degree,
            # amg_parameters.py:8)
            rep = solve_system(A, b, "metric_mono", sizes, tol=1e-10,
                               maxiter=500, grid=((n + 1, n + 1), 2),
                               params=replace(
                                   PRESETS["metric_mono_default"],
                                   cycle_type="amli", amli_degree=2,
                                   max_w_work=1024))
        else:
            idofs = np.arange(sizes[0], sum(sizes))
            rep = solve_system(A, b, "hazmath", sizes, idofs=idofs,
                               tol=1e-10, maxiter=500)
        dt = time.time() - then
        e1, e2 = compute_errors(mesh, data, rep.x, sizes)
        tables.add(sum(sizes), rep.niters, rep.cond, dt, rep.r_norm,
                   mesh.hmin(), [e1, e2])
        tables.show()
    return tables


if __name__ == "__main__":
    main()
