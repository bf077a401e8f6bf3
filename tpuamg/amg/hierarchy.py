"""AMG hierarchy: host-side setup, device-resident multilevel preconditioner.

Mirrors the reference's split (SURVEY.md §3.1): HAZmath runs AMG *setup*
once in C on the host (strength -> aggregation -> prolongators -> RAP ->
Schwarz blocks -> coarse factorization), then applies cycles per PCG
iteration.  Here setup is vectorized numpy on host; the result is a pytree
(`MGPreconditioner`) whose `matvec` is fully jittable — the entire PCG +
preconditioner solve compiles to ONE XLA program with zero host crossings
per iteration (the shape of the reference's all-in-C fast path,
/root/reference/src/utils.py:119, without the per-iteration SWIG hop of its
slow path).

Cycle types: V, W, AMLI(degree), additive — HAZmath ``cycle_type``
(/root/reference/src/amg_parameters.py:6). W/AMLI recursion is unrolled at
trace time (static level count); a work cap degrades W->V below the depth
where the recursive visit count would blow up the trace.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR, ELL, rap_unsmoothed
from ..config import AMGParameters
from .strength import strength_graph
from .aggregation import AGGREGATORS, hem_aggregation, mwm_aggregation
from .prolongation import tentative_prolongator, smoothed_prolongator
from ..smoothers import (build_jacobi, build_l1_jacobi, build_multicolor_gs,
                         build_chebyshev, build_schwarz, MetricSmoother,
                         SchwarzSmoother)


@jax.tree_util.register_pytree_node_class
class MGLevel:
    """One level: fine operator + smoother + transfer to the next level."""

    def __init__(self, A: ELL, smoother, agg=None, P=None, R=None, nc=0):
        self.A = A
        self.smoother = smoother
        self.agg = agg      # (n,) int32 aggregate map (UA fast transfers)
        self.P = P          # ELL (SA) or None
        self.R = R          # ELL (SA) or None
        self.nc = nc        # coarse size (static)

    def tree_flatten(self):
        return ((self.A, self.smoother, self.agg, self.P, self.R),
                (self.nc,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        A, sm, agg, P, R = ch
        return cls(A, sm, agg, P, R, aux[0])

    def restrict(self, r):
        if self.agg is not None:
            return jnp.zeros(self.nc, dtype=r.dtype).at[self.agg].add(r)
        return self.R.matvec(r)

    def prolong(self, ec):
        if self.agg is not None:
            return ec[self.agg]
        return self.P.matvec(ec)


@jax.tree_util.register_pytree_node_class
class MGPreconditioner:
    """Multilevel cycle as a linear operator (pytree; jit-traceable)."""

    def __init__(self, levels, coarse_inv, cycle="v", maxit=1,
                 presmooth=1, postsmooth=1, amli_degree=3, max_w_work=256,
                 coarse_scaling=False):
        self.levels = tuple(levels)
        self.coarse_inv = coarse_inv
        self.cycle = cycle
        self.maxit = maxit
        self.presmooth = presmooth
        self.postsmooth = postsmooth
        self.amli_degree = amli_degree
        self.max_w_work = max_w_work
        # HAZmath AMG_coarse_scaling (parameters_standard: ON): energy-
        # minimizing scaling of each coarse correction,
        # alpha = <rc,ec>/<ec,Ac ec> capped at 2 — the classic cure for
        # piecewise-constant (UA) coarse spaces over-stiffening the
        # Galerkin operators (measured: restores bidomain_2d 'hazmath'
        # h-robustness, scripts/exp_std_amg.py).  Makes the
        # preconditioner mildly nonlinear (same as HAZmath applying it
        # under plain PCG).
        self.coarse_scaling = coarse_scaling

    def tree_flatten(self):
        return ((self.levels, self.coarse_inv),
                (self.cycle, self.maxit, self.presmooth, self.postsmooth,
                 self.amli_degree, self.max_w_work, self.coarse_scaling))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        levels, coarse_inv = ch
        return cls(levels, coarse_inv, *aux)

    # -- application --------------------------------------------------
    def _coarse_solve(self, b):
        return jnp.matmul(self.coarse_inv, b,
                          precision=jax.lax.Precision.HIGHEST)

    def _n_recursive(self, lvl):
        """Recursive visits of level lvl in a pure W/AMLI cycle."""
        mu = 2 if self.cycle in ("w", "fmg_w") else (
            self.amli_degree if self.cycle in ("amli", "nl_amli") else 1)
        return mu ** lvl

    def _cycle(self, lvl, b, x):
        if lvl == len(self.levels):
            return self._coarse_solve(b)
        L = self.levels[lvl]
        # adopt the level's operator dtype: mixed-precision hierarchies
        # (f32 window levels + f64 algebraic tail — structured.py tail
        # note) must iterate each level in ITS precision, or the .at[]
        # updates round every correction back to the fine dtype
        ldt = getattr(L.A, "dtype", None)
        if ldt is not None and b.dtype != ldt:
            b = b.astype(ldt)
            x = x.astype(ldt)
        if hasattr(L.smoother, "smooth_residual"):
            # pre-smooth + residual fused into one kernel launch
            x, r = L.smoother.smooth_residual(L.A, x, b, self.presmooth)
        else:
            x = L.smoother.smooth(L.A, x, b, self.presmooth)
            r = L.A.residual(x, b)   # fused launch on the PDIA path
        # NOTE: post-smoothing below passes reverse=True so nonsymmetric
        # smoothers (forward GS) apply their transpose — keeping the whole
        # cycle a symmetric operator, which CG requires.
        rc = L.restrict(r)
        ec = jnp.zeros(L.nc, dtype=b.dtype)
        # number of coarse-grid visits at the NEXT level
        if self.cycle in ("w", "fmg_w") and \
                self._n_recursive(lvl + 1) <= self.max_w_work:
            ec = self._cycle(lvl + 1, rc, ec)
            ec = self._cycle(lvl + 1, rc, ec)
        elif self.cycle in ("amli", "nl_amli") and \
                self._n_recursive(lvl + 1) <= self.max_w_work:
            ec = self._amli_inner(lvl + 1, rc, ec)
        else:   # v (or degraded deep levels)
            ec = self._cycle(lvl + 1, rc, ec)
        ec = ec.astype(b.dtype)
        if self.coarse_scaling and lvl + 1 < len(self.levels):
            Ac = self.levels[lvl + 1].A
            denom = jnp.vdot(ec, Ac.matvec(ec)).real
            num = jnp.vdot(rc, ec).real
            alpha = jnp.where(denom > 0,
                              jnp.clip(num / (denom + 1e-300), 0.0, 2.0),
                              1.0)
            ec = alpha * ec
        x = x + L.prolong(ec)
        x = L.smoother.smooth(L.A, x, b, self.postsmooth, reverse=True)
        return x

    def _amli_inner(self, lvl, b, x):
        """Nonlinear AMLI: `amli_degree` steps of flexible steepest descent
        on the coarse problem, preconditioned by the recursive cycle."""
        if lvl == len(self.levels):
            return self._coarse_solve(b)
        A = self.levels[lvl].A if lvl < len(self.levels) else None
        for _ in range(self.amli_degree):
            r = A.residual(x, b)
            z = self._cycle(lvl, r, jnp.zeros_like(r))
            Az = A.matvec(z)
            denom = jnp.vdot(z, Az).real
            alpha = jnp.where(denom > 0, jnp.vdot(z, r).real / denom, 1.0)
            x = x + alpha * z
        return x

    def _fmg(self, b):
        """Full-multigrid (F-cycle) application: restrict the rhs through
        every level, coarse-solve first, then work upward — at each level
        prolong the current solution and run one V-cycle with the
        restricted rhs.  The PETSc ``pc_mg_type: full`` configuration of
        the reference's GMG path
        (/root/reference/src/bidomain_2d_firedrake.py:106-125)."""
        rs = [b]
        for L in self.levels:
            rs.append(L.restrict(rs[-1]))
        x = self._coarse_solve(rs[-1])
        for i in reversed(range(len(self.levels))):
            x = self.levels[i].prolong(x)
            x = self._cycle(i, rs[i], x)
        return x

    def _additive(self, b):
        """Additive (BPX-like) cycle: smoother contributions from every
        level plus the coarse solve, summed."""
        rs = [b]
        for L in self.levels:
            rs.append(L.restrict(rs[-1]))
        ec = self._coarse_solve(rs[-1])
        for i in reversed(range(len(self.levels))):
            L = self.levels[i]
            z = L.smoother.smooth(L.A, jnp.zeros_like(rs[i]), rs[i], 1)
            ec = z + L.prolong(ec)
        return ec

    # -- split application (host-tail hybrids) ------------------------
    # A V-cycle (maxit=1, zero initial guess) split at the coarse
    # boundary into two device programs, so a HOST step can run the
    # coarse solve between them (amg.structured.HostTailHybrid).
    # For cycle='v',
    # cycle_up(carry, tail(rc)) == matvec(b) EXACTLY when the tail
    # preconditioner equals the levels this object would have held
    # below the boundary (same recursion, zero initial coarse guess).
    def cycle_down(self, b):
        """Pre-smooth + restrict through every level.

        Returns (carry, rc): carry = per-level (x, b) tuples for
        cycle_up, rc = the residual restricted to the coarse boundary
        (the tail's level-0 size)."""
        xs, bs = [], []
        for L in self.levels:
            ldt = getattr(L.A, "dtype", None)
            if ldt is not None and b.dtype != ldt:
                b = b.astype(ldt)
            x = jnp.zeros_like(b)
            if hasattr(L.smoother, "smooth_residual"):
                x, r = L.smoother.smooth_residual(L.A, x, b,
                                                  self.presmooth)
            else:
                x = L.smoother.smooth(L.A, x, b, self.presmooth)
                r = L.A.residual(x, b)
            xs.append(x)
            bs.append(b)
            b = L.restrict(r)
        return (tuple(xs), tuple(bs)), b

    def cycle_up(self, carry, ec):
        """Prolong + post-smooth back up from the coarse correction."""
        xs, bs = carry
        for i in reversed(range(len(self.levels))):
            L = self.levels[i]
            b, x = bs[i], xs[i]
            ec = ec.astype(b.dtype)
            if self.coarse_scaling and i + 1 < len(self.levels):
                Ac = self.levels[i + 1].A
                rc = bs[i + 1]
                denom = jnp.vdot(ec, Ac.matvec(ec)).real
                num = jnp.vdot(rc, ec).real
                alpha = jnp.where(denom > 0,
                                  jnp.clip(num / (denom + 1e-300),
                                           0.0, 2.0), 1.0)
                ec = alpha * ec
            x = x + L.prolong(ec)
            x = L.smoother.smooth(L.A, x, b, self.postsmooth,
                                  reverse=True)
            ec = x
        return ec

    def matvec(self, b):
        if self.cycle == "add":
            return self._additive(b).astype(b.dtype)
        if self.cycle in ("fmg", "fmg_w"):
            # FMG once, then (maxit-1) cycles refine from it ("fmg" =
            # V inner cycles; "fmg_w" = W inner cycles — piecewise-
            # constant window-UA transfers are not h-robust under V,
            # W restores level-independent convergence)
            x = self._fmg(b)
            for _ in range(self.maxit - 1):
                x = self._cycle(0, b, x)
            return x.astype(b.dtype)
        x = jnp.zeros_like(b)
        for _ in range(self.maxit):
            x = self._cycle(0, b, x)
        # keep the Krylov iteration's dtype even if hierarchy data is wider
        return x.astype(b.dtype)


def _apply_mg(prec: MGPreconditioner, b):
    return prec.matvec(b)


def as_operator(prec: MGPreconditioner):
    """Partial-wrapped apply: jit cache keys on structure, not identity."""
    return jax.tree_util.Partial(_apply_mg, prec)


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

def _build_level_smoother(A: HostCSR, params: AMGParameters, level,
                          idofs, dtype):
    use_schwarz = (level < params.schwarz_levels)
    if use_schwarz:
        # Blocks are *seeded* at interface dofs but grow through the full
        # matrix graph: the gamma*M coupling reaches the partner dofs
        # outside the interface set, and block solves must capture that
        # pair coupling for gamma-robustness.
        from ..smoothers.schwarz_setup import build_schwarz_fast
        schwarz = build_schwarz_fast(
            A, idofs=idofs if idofs is not None
            else np.arange(A.shape[0]),
            maxlvl=params.schwarz_maxlvl,
            mmsize=params.schwarz_mmsize,
            symmetric=(params.schwarz_type == "symmetric"),
            dtype=dtype,
            cluster=getattr(params, "schwarz_cluster", False))
        if idofs is not None and len(idofs) < A.shape[0]:
            # complement smoother (utils.py:84 semantics: GS elsewhere).
            # smoother="chebyshev" swaps in masked Chebyshev — exactly
            # Chebyshev on the complement block (build_chebyshev
            # docstring), gather-only: ~20x fewer gather/scatter ops per
            # cycle than multicolor GS
            mask = np.ones(A.shape[0], dtype=bool)
            mask[idofs] = False
            if params.smoother == "chebyshev":
                gs = build_chebyshev(A, degree=3, active=mask,
                                     dtype=dtype)
            else:
                gs = build_multicolor_gs(
                    A, omega=1.0, symmetric=False, active=mask,
                    max_colors=getattr(params, "gs_max_colors", 24),
                    dtype=dtype)
        else:
            gs = None
        return MetricSmoother(schwarz, gs)
    sm = params.smoother
    if sm == "jacobi":
        return build_jacobi(A, omega=1.0 / params.relaxation, dtype=dtype)
    if sm == "l1_jacobi":
        return build_l1_jacobi(A, dtype=dtype)
    if sm == "chebyshev":
        return build_chebyshev(A, degree=3, dtype=dtype)
    mc = getattr(params, "gs_max_colors", 24)
    if sm == "gs":
        return build_multicolor_gs(A, omega=1.0, symmetric=False,
                                   max_colors=mc, dtype=dtype)
    if sm == "sor":      # HAZmath SOR = GS with relaxation weight
        return build_multicolor_gs(A, omega=params.relaxation,
                                   symmetric=False, max_colors=mc,
                                   dtype=dtype)
    if sm == "ssor":
        return build_multicolor_gs(A, omega=params.relaxation,
                                   symmetric=True, max_colors=mc,
                                   dtype=dtype)
    # default sgs
    return build_multicolor_gs(A, omega=1.0, symmetric=True,
                               max_colors=mc, dtype=dtype)


def _batch_isolated_rows(A: HostCSR, agg, nagg, max_aggregation):
    """Merge aggregates of off-diagonal-free rows into batches."""
    r, c, _ = A.to_coo()
    offdeg = np.zeros(A.shape[0], dtype=np.int64)
    np.add.at(offdeg, r[r != c], 1)
    iso = np.flatnonzero(offdeg == 0)
    if len(iso) < 2:
        return agg, nagg
    group = max(2, int(max_aggregation))
    new_ids = nagg + np.arange(len(iso)) // group
    agg = agg.copy()
    agg[iso] = new_ids
    used, inv = np.unique(agg[agg >= 0], return_inverse=True)
    out = np.full(len(agg), -1, dtype=np.int64)
    out[agg >= 0] = inv
    return out, len(used)


def setup_amg(A_host: HostCSR, params: AMGParameters = AMGParameters(),
              idofs=None, pad_multiple=1) -> MGPreconditioner:
    """Build the multilevel hierarchy on host, ship to device.

    idofs: interface dof indices — rows that get the Schwarz treatment on
    Schwarz-enabled levels (metricAMG semantics,
    /root/reference/src/utils.py:86-88). Propagated to coarse levels
    through the aggregation map.

    pad_multiple: pad every level's row count to this multiple with inert
    identity rows so all per-row arrays are divisible by the device-mesh
    size (dist.sharding); callers must pad the RHS to match."""
    from ..sparse.host import pad_csr_identity
    dtype = jnp.float64 if params.dtype == "float64" else jnp.float32
    aggregate = AGGREGATORS[params.aggregation_type]
    levels = []
    A = pad_csr_identity(A_host, pad_multiple)
    cur_idofs = None if idofs is None else np.asarray(idofs, dtype=np.int64)
    while (len(levels) < params.max_levels - 1
           and A.shape[0] > params.coarse_dof):
        # UA coarse operators grow their diagonal with aggregate size, so a
        # fixed strength threshold starves the strength graph on coarse
        # levels (coarsening stagnates). Decay theta per level — same
        # cure HAZmath applies on coarse grids.
        theta = params.strong_coupled * (0.5 ** len(levels))
        S = strength_graph(A, theta)
        if params.aggregation_type in ("hem", "mwm"):
            # pairwise matchings coarsen by <=2x per pass; compose passes
            pair = (hem_aggregation if params.aggregation_type == "hem"
                    else mwm_aggregation)
            agg, nagg = pair(S)
            for _ in range(params.pairwise_passes - 1):
                if nagg <= params.coarse_dof:
                    break
                Ac_tmp = rap_unsmoothed(A, agg, nagg)
                S2 = strength_graph(Ac_tmp, theta)
                agg2, nagg2 = pair(S2)
                agg = agg2[agg]
                nagg = nagg2
        else:
            agg, nagg = aggregate(S, params.max_aggregation)
        # Rows with no off-diagonal coupling (eliminated Dirichlet rows,
        # fully decoupled dofs) never aggregate and would stall coarsening
        # as eternal singletons. Batch them into group aggregates: safe,
        # since one pre-smoothing sweep solves decoupled rows exactly, so
        # their restricted residual is 0 and the (inexact) group coarse
        # correction never activates.
        agg, nagg = _batch_isolated_rows(A, agg, nagg,
                                         params.max_aggregation)
        if nagg > 0.85 * A.shape[0]:   # stagnation — dense-solve the rest
            break
        if params.amg_type == "sa":
            assert pad_multiple == 1, \
                "sharded SA transfers not supported yet (UA/agg path only)"
            P_t = tentative_prolongator(agg, nagg)
            P = smoothed_prolongator(A, P_t, params.strong_coupled)
            R = P.T
            Ac = R.matmat(A.matmat(P))
            smoother = _build_level_smoother(A, params, len(levels),
                                             cur_idofs, dtype)
            levels.append(MGLevel(
                ELL.from_host(A, dtype=dtype), smoother,
                agg=None,
                P=ELL.from_host(P, dtype=dtype),
                R=ELL.from_host(R, dtype=dtype), nc=nagg))
        else:
            Ac = pad_csr_identity(rap_unsmoothed(A, agg, nagg),
                                  pad_multiple)
            smoother = _build_level_smoother(A, params, len(levels),
                                             cur_idofs, dtype)
            levels.append(MGLevel(
                ELL.from_host(A, dtype=dtype), smoother,
                agg=jnp.asarray(agg, dtype=jnp.int32), nc=Ac.shape[0]))
        if cur_idofs is not None:
            cur_idofs = np.unique(agg[cur_idofs])
            cur_idofs = cur_idofs[cur_idofs >= 0]
        A = Ac
    coarse_inv = np.linalg.inv(A.toarray()) if A.shape[0] > 0 else \
        np.zeros((0, 0))
    return MGPreconditioner(
        levels, jnp.asarray(coarse_inv, dtype=dtype),
        cycle=params.cycle_type, maxit=params.maxit,
        presmooth=params.presmooth_iter, postsmooth=params.postsmooth_iter,
        amli_degree=params.amli_degree, max_w_work=params.max_w_work,
        coarse_scaling=params.coarse_scaling)
