"""Overlapping Schwarz block smoother, batched into dense products.

Device rebuild of HAZmath's Schwarz method (SURVEY.md §2b "HAZmath
Schwarz smoother"; parameters ``Schwarz_levels/mmsize/maxlvl/type/blksolver``
at /root/reference/src/amg_parameters.py:39-43 and
``input_metric.dat`` precond type 16 = symmetric multiplicative Schwarz on
interface dofs + GS elsewhere, /root/reference/src/utils.py:84).

Design mapping (reference -> device):
- blocks grown `maxlvl` graph-levels from seed dofs, capped at `mmsize`
  rows  ->  same BFS growth on the host at setup, with seeds optionally
  thinned to a covering independent set so the block count stays bounded;
- per-block UMFPACK LU solves  ->  blocks padded to a uniform size, dense
  inverses precomputed on host, application is ONE batched (nblk, m, m) @
  (nblk, m) product;
- symmetric multiplicative ordering  ->  blocks colored by overlap
  (host greedy coloring of the block-intersection graph); within a color
  blocks are disjoint, so a multiplicative sweep is a short static sequence
  of batched updates; symmetric = forward colors then reversed.

The `MetricSmoother` composes Schwarz-on-interface-dofs with multicolor GS
on the remaining dofs — the paper's metric-AMG smoother split
(idofs semantics, /root/reference/src/utils.py:84).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR, ELL


def _bfs_blocks(A: HostCSR, seeds, maxlvl, mmsize, restrict=None):
    """Grow one block per seed: all dofs within graph distance `maxlvl`,
    optionally restricted to the dof set `restrict`; capped at mmsize."""
    indptr, indices = A.indptr, A.indices
    allowed = None
    if restrict is not None:
        allowed = np.zeros(A.shape[0], dtype=bool)
        allowed[restrict] = True
    blocks = []
    for s in seeds:
        frontier = [int(s)]
        seen = {int(s)}
        for _ in range(maxlvl):
            nxt = []
            for u in frontier:
                for vtx in indices[indptr[u]:indptr[u + 1]]:
                    vtx = int(vtx)
                    if vtx in seen:
                        continue
                    if allowed is not None and not allowed[vtx]:
                        continue
                    seen.add(vtx)
                    nxt.append(vtx)
                    if len(seen) >= mmsize:
                        break
                if len(seen) >= mmsize:
                    break
            frontier = nxt
            if len(seen) >= mmsize:
                break
        blocks.append(np.fromiter(sorted(seen), dtype=np.int64))
    return blocks


def _thin_seeds(A: HostCSR, idofs, maxlvl):
    """Covering independent set: greedy distance-(maxlvl) MIS over the
    idofs-induced subgraph, guaranteeing every idof lands in some block."""
    idofs = np.asarray(idofs, dtype=np.int64)
    in_set = np.zeros(A.shape[0], dtype=bool)
    in_set[idofs] = True
    indptr, indices = A.indptr, A.indices
    covered = np.zeros(A.shape[0], dtype=bool)
    seeds = []
    for s in idofs:
        if covered[s]:
            continue
        seeds.append(s)
        # mark distance-maxlvl neighborhood (within idofs) as covered
        frontier = [int(s)]
        covered[s] = True
        for _ in range(maxlvl):
            nxt = []
            for u in frontier:
                for vtx in indices[indptr[u]:indptr[u + 1]]:
                    vtx = int(vtx)
                    if in_set[vtx] and not covered[vtx]:
                        covered[vtx] = True
                        nxt.append(vtx)
            frontier = nxt
    return np.asarray(seeds, dtype=np.int64)


def _color_blocks(blocks, n):
    """Greedy coloring of the block overlap graph (shared dof = edge)."""
    owner = [[] for _ in range(n)]
    for bi, blk in enumerate(blocks):
        for d in blk:
            owner[d].append(bi)
    colors = np.full(len(blocks), -1, dtype=np.int64)
    for bi in range(len(blocks)):
        used = set()
        for d in blocks[bi]:
            for bj in owner[d]:
                if bj != bi and colors[bj] >= 0:
                    used.add(int(colors[bj]))
        c = 0
        while c in used:
            c += 1
        colors[bi] = c
    return colors


@jax.tree_util.register_pytree_node_class
class SchwarzSmoother:
    """Colored multiplicative (or additive) overlapping Schwarz.

    Per color c:
      dof_ids[c]:  (nb_c, m) int32, padded with n (ghost row of x/b),
      inv_blocks[c]: (nb_c, m, m) dense inverses (identity in padding).
    """

    def __init__(self, dof_ids, inv_blocks, symmetric=True, additive=False,
                 weight=1.0):
        self.dof_ids = tuple(dof_ids)
        self.inv_blocks = tuple(inv_blocks)
        self.symmetric = symmetric
        self.additive = additive
        self.weight = weight

    def tree_flatten(self):
        return ((self.dof_ids, self.inv_blocks, self.weight),
                (self.symmetric, self.additive))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        ids, inv, w = ch
        return cls(ids, inv, aux[0], aux[1], w)

    def _color_update(self, A: ELL, x, b, c):
        ids = self.dof_ids[c]
        inv = self.inv_blocks[c]
        r = b - A.matvec(x)
        rpad = jnp.concatenate([r, jnp.zeros((1,), dtype=r.dtype)])
        rb = rpad[ids]                                   # (nb, m)
        delta = jnp.einsum("bij,bj->bi", inv, rb,
                           precision=jax.lax.Precision.HIGHEST)
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        xpad = xpad.at[ids.reshape(-1)].add(
            self.weight * delta.reshape(-1))
        return xpad[:-1]

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        ncol = len(self.dof_ids)
        for _ in range(iters):
            if self.additive:
                r = b - A.matvec(x)
                rpad = jnp.concatenate([r, jnp.zeros((1,), dtype=r.dtype)])
                xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
                for c in range(ncol):
                    rb = rpad[self.dof_ids[c]]
                    delta = jnp.einsum("bij,bj->bi", self.inv_blocks[c],
                                       rb, precision=jax.lax.Precision.HIGHEST)
                    xpad = xpad.at[self.dof_ids[c].reshape(-1)].add(
                        self.weight * delta.reshape(-1))
                x = xpad[:-1]
            else:
                order = list(range(ncol))
                if reverse and not self.symmetric:
                    order = order[::-1]
                for c in order:
                    x = self._color_update(A, x, b, c)
                if self.symmetric:
                    for c in reversed(range(ncol)):
                        x = self._color_update(A, x, b, c)
        return x


def build_schwarz(A_host: HostCSR, seeds=None, idofs=None, maxlvl=1,
                  mmsize=100, symmetric=True, additive=False,
                  thin=True, restrict_to_idofs=True, weight=1.0,
                  dtype=jnp.float32):
    """Construct the Schwarz smoother data from the host matrix.

    idofs: dof set the smoother acts on (interface dofs); None = all.
    seeds: explicit seed dofs; default = thinned covering MIS of idofs.
    """
    n = A_host.shape[0]
    if idofs is None:
        idofs = np.arange(n, dtype=np.int64)
    idofs = np.asarray(idofs, dtype=np.int64)
    if seeds is None:
        seeds = _thin_seeds(A_host, idofs, maxlvl) if thin else idofs
    restrict = idofs if restrict_to_idofs else None
    blocks = _bfs_blocks(A_host, seeds, maxlvl, mmsize, restrict)
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    dof_ids, inv_blocks = [], []
    for c in range(ncol):
        bids = [blocks[i] for i in np.flatnonzero(colors == c)]
        nb = len(bids)
        ids = np.full((nb, m), n, dtype=np.int32)      # ghost pad
        inv = np.zeros((nb, m, m), dtype=np.float64)
        for k, blk in enumerate(bids):
            sz = len(blk)
            ids[k, :sz] = blk
            sub = A_host.extract_submatrix(blk, blk)
            inv[k, :sz, :sz] = np.linalg.inv(sub)
        dof_ids.append(jnp.asarray(ids))
        inv_blocks.append(jnp.asarray(inv, dtype=dtype))
    return SchwarzSmoother(dof_ids, inv_blocks, symmetric, additive, weight)


@jax.tree_util.register_pytree_node_class
class MetricSmoother:
    """Schwarz on interface dofs + multicolor GS on the rest, applied
    symmetrically: GS-forward, Schwarz(sym), GS-backward.  Mirrors
    HAZmath precond type 16 semantics (interface Schwarz + GS elsewhere,
    /root/reference/src/input_metric.dat:57, utils.py:84)."""

    def __init__(self, schwarz: SchwarzSmoother, gs):
        self.schwarz = schwarz
        self.gs = gs

    def tree_flatten(self):
        return ((self.schwarz, self.gs), ())

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch)

    def smooth(self, A: ELL, x, b, iters=1, reverse=False):
        for _ in range(iters):
            if self.gs is not None:
                x = self.gs.smooth(A, x, b, reverse=reverse)
            x = self.schwarz.smooth(A, x, b, reverse=reverse)
            if self.gs is not None:
                x = self.gs.smooth(A, x, b, reverse=not reverse)
        return x


@jax.tree_util.register_pytree_node_class
class LocalSchwarzSmoother:
    """Colored multiplicative Schwarz with LOCAL residuals.

    SchwarzSmoother computes a full ``b - A x`` per color, which is fine
    when the matvec is one op (ELL) but blows the compiled program up
    when it is op-heavy (wide-DIA / split structured operators, ~300 XLA
    ops each — the 3D-1D footprint blocks overlap ~10 deep along the
    curve, so color counts are O(10)).  Here each color carries batched
    dense extracts of its block ROWS of A (row_cols/row_vals, padded with
    the ghost column n), so one color update is

        r_loc  = b[ids] - sum_k row_vals * x[row_cols]      (local rows)
        x[ids] += inv_blocks @ r_loc                        (batched)

    ~6 ops per color regardless of the operator's matvec cost.  Blocks
    within a color are disjoint (overlap coloring), so the scatter is
    conflict-free and the sweep is a true multiplicative Gauss-Seidel
    over blocks; symmetric = forward colors then reversed."""

    def __init__(self, dof_ids, inv_blocks, row_cols, row_vals,
                 symmetric=True):
        self.dof_ids = tuple(dof_ids)        # per color: (nb, m)
        self.inv_blocks = tuple(inv_blocks)  # per color: (nb, m, m)
        self.row_cols = tuple(row_cols)      # per color: (nb, m, K)
        self.row_vals = tuple(row_vals)      # per color: (nb, m, K)
        self.symmetric = symmetric

    def tree_flatten(self):
        return ((self.dof_ids, self.inv_blocks, self.row_cols,
                 self.row_vals), (self.symmetric,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        ids, inv, rc, rv = ch
        return cls(ids, inv, rc, rv, aux[0])

    def _color_update(self, x, b, c):
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        bpad = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
        ax = jnp.einsum("bmk,bmk->bm", self.row_vals[c],
                        xpad[self.row_cols[c]],
                        precision=jax.lax.Precision.HIGHEST)
        r = bpad[self.dof_ids[c]] - ax
        delta = jnp.einsum("bij,bj->bi", self.inv_blocks[c], r,
                           precision=jax.lax.Precision.HIGHEST)
        xpad = xpad.at[self.dof_ids[c].reshape(-1)].add(
            delta.reshape(-1).astype(x.dtype))
        return xpad[:-1]

    def smooth(self, A, x, b, iters=1, reverse=False):
        del A
        ncol = len(self.dof_ids)
        for _ in range(iters):
            for c in range(ncol):
                x = self._color_update(x, b, c)
            if self.symmetric:
                for c in reversed(range(ncol)):
                    x = self._color_update(x, b, c)
        return x


def build_local_schwarz(A_host: HostCSR, seeds, maxlvl=1, mmsize=200,
                        symmetric=True, dtype=jnp.float32,
                        cluster=False):
    """LocalSchwarzSmoother from the host matrix (blocks = maxlvl-balls
    around the seeds, exact dense inverses, per-color padded row data).

    cluster=True merges runs of overlapping balls into shared blocks
    (schwarz_setup.merge_overlapping_blocks): at curve resolutions
    finer than the bulk mesh, per-seed footprints coincide and the
    local-residual colored sweep degrades with the overlap depth."""
    n = A_host.shape[0]
    blocks = _bfs_blocks(A_host, np.asarray(seeds, dtype=np.int64),
                         maxlvl, mmsize)
    if cluster:
        from .schwarz_setup import merge_overlapping_blocks
        blocks = merge_overlapping_blocks(blocks, mmsize)
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    indptr, indices, data = A_host.indptr, A_host.indices, A_host.data
    K = int(max((indptr[i + 1] - indptr[i] for blk in blocks
                 for i in blk), default=1))
    ids_c, inv_c, rc_c, rv_c = [], [], [], []
    for c in range(ncol):
        bids = [blocks[i] for i in np.flatnonzero(colors == c)]
        nb = len(bids)
        ids = np.full((nb, m), n, dtype=np.int32)
        inv = np.zeros((nb, m, m))
        rcols = np.full((nb, m, K), n, dtype=np.int32)
        rvals = np.zeros((nb, m, K))
        for k, blk in enumerate(bids):
            sz = len(blk)
            ids[k, :sz] = blk
            inv[k, :sz, :sz] = np.linalg.inv(
                A_host.extract_submatrix(blk, blk))
            for t, i in enumerate(blk):
                lo, hi = indptr[i], indptr[i + 1]
                rcols[k, t, :hi - lo] = indices[lo:hi]
                rvals[k, t, :hi - lo] = data[lo:hi]
        ids_c.append(jnp.asarray(ids))
        inv_c.append(jnp.asarray(inv, dtype=dtype))
        rc_c.append(jnp.asarray(rcols))
        rv_c.append(jnp.asarray(rvals, dtype=dtype))
    return LocalSchwarzSmoother(ids_c, inv_c, rc_c, rv_c, symmetric)


@jax.tree_util.register_pytree_node_class
class Rank1SchurSmoother:
    """Footprint smoother with O(|footprint|) storage per block.

    LocalSchwarzSmoother stores a dense inverse per block — nb*m^2
    values, which at real-neuron scale (1e4 curve dofs x ~200-dof
    footprints) is GBs re-read every application.  Here each block
    (seed curve dof s + footprint f) is solved with the structured
    approximation

        B = [[a, w^T], [w, E]],   E = D_l1 + w w^T / a

    where a = A[s,s], w = A[s,f] (the gamma-coupling row) and D_l1 the
    l1 row-sum diagonal.  The 3D-1D gamma block is EXACTLY rank-1
    (gamma*m*[1; -pi][1; -pi]^T with pi the averaging weights), and
    w w^T / a reproduces it: the approximation is gamma-exact while
    D_l1 >= A bounds the gamma-free remainder, so B is SPD and the
    update never overshoots.  B^{-1} applies in O(m) via
    Sherman-Morrison (t = w^T D^{-1} w, denom = a + t):

        E^{-1} v  = D^{-1} v - D^{-1} w (w^T D^{-1} v) / denom
        schur     = a - w^T E^{-1} w = a^2 / denom
        alpha     = (r_s - w^T E^{-1} r_f) / schur
        delta_f   = E^{-1}(r_f - w alpha),   delta_s = alpha

    Storage/bandwidth: 2 vectors + 1 scalar per block instead of m^2.
    Same colored-multiplicative application machinery (local residuals
    from padded row data) as LocalSchwarzSmoother; dof_ids[:, 0] is the
    seed by construction.

    STATUS (measured, 3D-1D synthetic neuron): gamma-robust up to
    ~1e4 (25 PCG iterations vs 13 for the exact block inverses); NOT
    yet robust at gamma >= 1e8 — the l1 diagonal double-counts the
    block's own gamma terms (they sit in BOTH D_l1 and w w^T/a),
    over-damping the coupled direction, and footprint overlaps put
    gamma weight on in-block 3D-3D off-diagonals the model drops.
    The Sherman-Morrison solve itself is exact for the modeled block
    (unit-tested).  Use LocalSchwarzSmoother (exact) where its nb*m^2
    storage fits; this class is the storage-light research direction
    for real-neuron scale (CLAUDE.md backlog)."""

    def __init__(self, dof_ids, dinv, w, aseed, row_cols, row_vals,
                 symmetric=True):
        self.dof_ids = tuple(dof_ids)        # per color: (nb, m)
        self.dinv = tuple(dinv)              # per color: (nb, m); [.,0]=0
        self.w = tuple(w)                    # per color: (nb, m); [.,0]=0
        self.aseed = tuple(aseed)            # per color: (nb,)
        self.row_cols = tuple(row_cols)      # per color: (nb, m, K)
        self.row_vals = tuple(row_vals)
        self.symmetric = symmetric

    def tree_flatten(self):
        return ((self.dof_ids, self.dinv, self.w, self.aseed,
                 self.row_cols, self.row_vals), (self.symmetric,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        ids, dinv, w, aseed, rc, rv = ch
        return cls(ids, dinv, w, aseed, rc, rv, aux[0])

    def _color_update(self, x, b, c):
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        bpad = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
        ax = jnp.einsum("bmk,bmk->bm", self.row_vals[c],
                        xpad[self.row_cols[c]],
                        precision=jax.lax.Precision.HIGHEST)
        r = bpad[self.dof_ids[c]] - ax
        dinv, w, a = self.dinv[c], self.w[c], self.aseed[c]
        t = jnp.sum(w * dinv * w, axis=1)
        denom = a + t
        wdr = jnp.sum(w * dinv * r, axis=1)
        # alpha = (r_s - w^T E^{-1} r_f)/(a^2/denom); w^T E^{-1} r_f =
        # wdr * a/denom  =>  alpha = (denom*r_s - a*wdr)/a^2
        alpha = (denom * r[:, 0] - a * wdr) / (a * a)
        v = r - w * alpha[:, None]
        wdv = wdr - t * alpha             # = sum(w*dinv*v)
        delta = dinv * v - (dinv * w) * (wdv / denom)[:, None]
        delta = delta.at[:, 0].set(alpha)
        xpad = xpad.at[self.dof_ids[c].reshape(-1)].add(
            delta.reshape(-1).astype(x.dtype))
        return xpad[:-1]

    smooth = LocalSchwarzSmoother.smooth


@jax.tree_util.register_pytree_node_class
class DiagRank1Smoother:
    """Rank-1 footprint smoother with O(m) storage per block.

    MEASURED NON-ROBUST above gamma~1e4 (docs/PERF_NOTES.md round-2
    cont.: n=10 sweep 11/10/31 then divergence at 1e6+) — the l1 bound
    on OVERLAPPING seeds' gamma in D is too loose once footprints
    overlap heavily, so the block model loses spectral equivalence.
    Kept as an experimental option (fp_solver="rank1g"); use the
    algebraic metric tail (solve_system ``algebraic_below``) for
    gamma-robust 3D-1D solves.

    The design (fix attempt for Rank1SchurSmoother's two failure modes,
    CLAUDE.md round-2 backlog): with the metric factorization
    A = AD + gamma R^T Mq R kept through assembly (io_utils.load_coupling)
    the block solve for seed curve-dof s models

        B_s = diag(D) + c_s u_s u_s^T,
        u_s = [1; -pi_s]   (the seed's coupling direction, EXACT),
        c_s = gamma * lump(Mq)_s,
        D_j = l1(AD)_j + (gamma*l1(M)_j - sum_s' c_s' |u_s'[j]| *
              ||u_s'||_1)_+

    i.e. the seed's own gamma lives ONLY in the rank-1 term (no double
    count in D), and OTHER overlapping seeds' gamma is l1-bounded into D
    (their directions are solved exactly by their own blocks in the
    multiplicative sweep).  The sign pattern of every seed's
    contribution matches M's, so the l1 split is additive and
    B_s >= A|block up to the mass-lumping perturbation.  Solve is
    Sherman-Morrison on diagonal + rank-1: O(m) storage and flops.

    Application machinery (local residuals from padded row data,
    colored multiplicative, symmetric) as LocalSchwarzSmoother."""

    def __init__(self, dof_ids, dinv, u, c, row_cols, row_vals,
                 symmetric=True):
        self.dof_ids = tuple(dof_ids)        # per color: (nb, m)
        self.dinv = tuple(dinv)              # per color: (nb, m)
        self.u = tuple(u)                    # per color: (nb, m)
        self.c = tuple(c)                    # per color: (nb,)
        self.row_cols = tuple(row_cols)      # per color: (nb, m, K)
        self.row_vals = tuple(row_vals)
        self.symmetric = symmetric

    def tree_flatten(self):
        return ((self.dof_ids, self.dinv, self.u, self.c,
                 self.row_cols, self.row_vals), (self.symmetric,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        ids, dinv, u, c, rc, rv = ch
        return cls(ids, dinv, u, c, rc, rv, aux[0])

    def _color_update(self, x, b, cc):
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        bpad = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
        ax = jnp.einsum("bmk,bmk->bm", self.row_vals[cc],
                        xpad[self.row_cols[cc]],
                        precision=jax.lax.Precision.HIGHEST)
        r = bpad[self.dof_ids[cc]] - ax
        dinv, u, c = self.dinv[cc], self.u[cc], self.c[cc]
        # (D + c u u^T)^{-1} r = D^{-1} r - D^{-1}u c (u^T D^{-1} r)
        #                                   / (1 + c u^T D^{-1} u)
        t = jnp.sum(u * dinv * u, axis=1)
        udr = jnp.sum(u * dinv * r, axis=1)
        coef = c * udr / (1.0 + c * t)
        delta = dinv * (r - u * coef[:, None])
        xpad = xpad.at[self.dof_ids[cc].reshape(-1)].add(
            delta.reshape(-1).astype(x.dtype))
        return xpad[:-1]

    smooth = LocalSchwarzSmoother.smooth


def rank1_gamma_data(A: HostCSR, gamma, Pi: HostCSR, Mq: HostCSR, sizes):
    """Precompute DiagRank1Smoother's inputs in ORIGINAL dof space from
    the metric factorization (A = AD + gamma R^T Mq R, block layout
    [3d; curve] — emi_3d1d.get_system(return_coupling=True) /
    io_utils.load_coupling).

    Returns (u_idx, u_val, c, l1_Mg, l1_AD):
      u_idx[s]/u_val[s]: seed s's direction u_s = e_{n3+s} - pi_s,
      c[s] = gamma * lump(Mq)_s,
      l1_Mg[j] = gamma * l1 row sums of M (the OWN seed's share is
      subtracted PER BLOCK inside build_diag_rank1 — subtracting every
      seed's share globally would cancel l1_Mg entirely, since under the
      lumped sign-consistent split attr == l1(M_lumped)),
      l1_AD[j] = l1 row sums of AD = A - gamma*M."""
    n3, n1 = sizes
    n = n3 + n1
    # lumped curve mass
    m_lump = np.zeros(n1)
    np.add.at(m_lump, np.repeat(np.arange(n1), np.diff(Mq.indptr)),
              Mq.data)
    c = float(gamma) * m_lump
    u_idx, u_val = [], []
    for s in range(n1):
        lo, hi = Pi.indptr[s], Pi.indptr[s + 1]
        u_idx.append(np.concatenate(
            [[n3 + s], Pi.indices[lo:hi].astype(np.int64)]))
        u_val.append(np.concatenate([[1.0], -Pi.data[lo:hi]]))
    # assembled metric part M = R^T Mq R and its l1 rows
    from ..sparse import bmat
    m01 = Pi.T.matmat(Mq)
    M = bmat([[Pi.T.matmat(Mq.matmat(Pi)), m01.scale(-1.0)],
              [m01.T.scale(-1.0), Mq]])
    l1_M = np.zeros(n)
    np.add.at(l1_M, np.repeat(np.arange(n), np.diff(M.indptr)),
              np.abs(M.data))
    l1_M *= float(gamma)
    AD = A.add(M, beta=-float(gamma))
    l1_AD = np.zeros(n)
    np.add.at(l1_AD, np.repeat(np.arange(n), np.diff(AD.indptr)),
              np.abs(AD.data))
    return u_idx, u_val, c, l1_M, l1_AD


def build_diag_rank1(A_host: HostCSR, seeds, gamma_data, maxlvl=1,
                     mmsize=200, symmetric=True, dtype=jnp.float32):
    """DiagRank1Smoother from the host matrix + gamma factorization.

    gamma_data: (u_idx, u_val, c, D_gamma, l1_AD) — all in the SAME
    index space as A_host (slot space on the structured path):
      u_idx[k]/u_val[k]: the k-th seed's coupling direction support and
      values (u_idx[k][0] == seeds[k], u_val[k][0] == 1),
      c: (nseeds,) gamma * lumped mass per seed,
      D_gamma: (n,) l1 of the OTHER-seed gamma per dof (attr-subtracted),
      l1_AD: (n,) l1 row sums of the gamma-free part."""
    n = A_host.shape[0]
    seeds = np.asarray(seeds, dtype=np.int64)
    u_idx, u_val, c_arr, D_gamma, l1_AD = gamma_data
    blocks = _bfs_blocks(A_host, seeds, maxlvl, mmsize)
    # seed-first, and force the seed's full u-support into the block so
    # the rank-1 term is exact (BFS may cap before covering it)
    blocks2 = []
    for s, blk, ui in zip(seeds, blocks, u_idx):
        allb = np.unique(np.concatenate([np.asarray(ui), blk]))
        blocks2.append(np.concatenate([[s], allb[allb != s]]))
    blocks = blocks2
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    indptr, indices, data = A_host.indptr, A_host.indices, A_host.data
    K = int(max((indptr[i + 1] - indptr[i] for blk in blocks
                 for i in blk), default=1))
    D_full = np.asarray(l1_AD) + np.asarray(D_gamma)
    D_full = np.where(D_full > 0, D_full, 1.0)
    ids_c, di_c, u_c, c_c, rc_c, rv_c = [], [], [], [], [], []
    for col in range(ncol):
        kidx = np.flatnonzero(colors == col)
        nb = len(kidx)
        ids = np.full((nb, m), n, dtype=np.int32)
        dinv = np.zeros((nb, m))
        uu = np.zeros((nb, m))
        cc = np.zeros(nb)
        rcols = np.full((nb, m, K), n, dtype=np.int32)
        rvals = np.zeros((nb, m, K))
        for kk, bi in enumerate(kidx):
            blk = blocks[bi]
            sz = len(blk)
            ids[kk, :sz] = blk
            dinv[kk, :sz] = 1.0 / D_full[blk]
            pos = {int(d): t for t, d in enumerate(blk)}
            for d, v in zip(u_idx[bi], u_val[bi]):
                t = pos.get(int(d))
                if t is not None:
                    uu[kk, t] = v
            cc[kk] = c_arr[bi]
            for t, i in enumerate(blk):
                lo, hi = indptr[i], indptr[i + 1]
                rcols[kk, t, :hi - lo] = indices[lo:hi]
                rvals[kk, t, :hi - lo] = data[lo:hi]
        ids_c.append(jnp.asarray(ids))
        di_c.append(jnp.asarray(dinv, dtype=dtype))
        u_c.append(jnp.asarray(uu, dtype=dtype))
        c_c.append(jnp.asarray(cc, dtype=dtype))
        rc_c.append(jnp.asarray(rcols))
        rv_c.append(jnp.asarray(rvals, dtype=dtype))
    return DiagRank1Smoother(ids_c, di_c, u_c, c_c, rc_c, rv_c,
                             symmetric)


def build_rank1_schur(A_host: HostCSR, seeds, maxlvl=1, mmsize=200,
                      symmetric=True, dtype=jnp.float32):
    """Rank1SchurSmoother from the host matrix (blocks = maxlvl-balls
    around the seeds, seed-first ordering, per-color padded row data)."""
    n = A_host.shape[0]
    seeds = np.asarray(seeds, dtype=np.int64)
    blocks = _bfs_blocks(A_host, seeds, maxlvl, mmsize)
    blocks = [np.concatenate([[s], blk[blk != s]])
              for s, blk in zip(seeds, blocks)]
    colors = _color_blocks(blocks, n)
    ncol = int(colors.max()) + 1 if len(blocks) else 0
    m = max((len(b) for b in blocks), default=1)
    indptr, indices, data = A_host.indptr, A_host.indices, A_host.data
    K = int(max((indptr[i + 1] - indptr[i] for blk in blocks
                 for i in blk), default=1))
    diag = A_host.diagonal()
    # l1 row sums: D_l1 >= A in the SPD sense, so the footprint part of
    # the approximate block solve cannot overshoot (a plain-diagonal D
    # underestimates the rank-1 gamma coupling inside the footprint and
    # the update diverges at large gamma -> indefinite preconditioner)
    l1 = np.zeros(n)
    np.add.at(l1, np.repeat(np.arange(n), np.diff(indptr_ := A_host.indptr)),
              np.abs(A_host.data))
    ids_c, di_c, w_c, sh_c, rc_c, rv_c = [], [], [], [], [], []
    for c in range(ncol):
        bids = [blocks[i] for i in np.flatnonzero(colors == c)]
        nb = len(bids)
        ids = np.full((nb, m), n, dtype=np.int32)
        dinv = np.zeros((nb, m))
        w = np.zeros((nb, m))
        aseed = np.ones(nb)
        rcols = np.full((nb, m, K), n, dtype=np.int32)
        rvals = np.zeros((nb, m, K))
        for k, blk in enumerate(bids):
            sz = len(blk)
            s = blk[0]
            ids[k, :sz] = blk
            dj = l1[blk[1:]]
            dinv[k, 1:sz] = np.where(dj != 0, 1.0 / np.where(
                dj == 0, 1.0, dj), 0.0)
            # seed row restricted to the footprint (w[0] stays 0)
            lo, hi = indptr[s], indptr[s + 1]
            cols = indices[lo:hi]
            vals = data[lo:hi]
            pos = {int(d): t for t, d in enumerate(blk)}
            for cc, vv in zip(cols, vals):
                t = pos.get(int(cc))
                if t is not None and t > 0:
                    w[k, t] = vv
            aseed[k] = diag[s] if diag[s] != 0 else 1.0
            for t, i in enumerate(blk):
                lo, hi = indptr[i], indptr[i + 1]
                rcols[k, t, :hi - lo] = indices[lo:hi]
                rvals[k, t, :hi - lo] = data[lo:hi]
        ids_c.append(jnp.asarray(ids))
        di_c.append(jnp.asarray(dinv, dtype=dtype))
        w_c.append(jnp.asarray(w, dtype=dtype))
        sh_c.append(jnp.asarray(aseed, dtype=dtype))
        rc_c.append(jnp.asarray(rcols))
        rv_c.append(jnp.asarray(rvals, dtype=dtype))
    return Rank1SchurSmoother(ids_c, di_c, w_c, sh_c, rc_c, rv_c,
                              symmetric)
