"""Structured (gather-free) device hierarchy for non-grid topologies.

This module builds a multilevel preconditioner whose application uses
only static slices, reshapes and batched small matrix products — no
gathers inside the cycle.  Architecture ("pair + Morton windows"):

1. **Level 0 ordering (one host-side permutation).** Dofs are paired by
   heavy-edge matching on the strength graph — for the metric systems
   A + gamma*M the heaviest edges are the gamma-coupled partners
   (u1_i, u2_i), so each pair solves the metric coupling exactly, playing
   the role of HAZmath's interface Schwarz blocks
   (/root/reference/src/utils.py:84).  Pairs are then sorted by the Morton
   (Z-order) code of their centroid and laid out in slot groups of 2
   (singletons ghost-padded).

2. **Coarse levels = contiguous windows.** Every coarser level aggregates
   s=4 *consecutive* dofs of the inherited order.  Because the inherited
   order is a Z-curve, windows are ~2x2 spatial quads: isotropic geometric
   coarsening with zero cross-level permutation — restriction is literally
   ``(r * mask).reshape(n_groups, s).sum(1)`` landing directly in the next
   level's row order, prolongation is a broadcast.

3. **Operators are DIA.** Z-order keeps neighbor slot-distances drawn from
   a small set (O(stencil * log n) distinct offsets), so each level's
   matvec is a short static-slice FMA loop.

4. **Smoother: slot-block Chebyshev.** Chebyshev polynomial in B^{-1}A,
   B = the slot-group block diagonal (batched precomputed inverses; one
   reshape + einsum to apply).

The generic cycle driver (MGPreconditioner) is reused via duck-typed
levels, so V/W/AMLI cycles and the jitted PCG work unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR
from ..sparse.dia import DIA
from ..config import AMGParameters
from ..smoothers.relaxation import cheb_coefs
from .strength import strength_graph
from .aggregation import hem_aggregation
from .hierarchy import MGPreconditioner


# ---------------------------------------------------------------------------
# smoother + level (device pytrees)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class BlockChebyshevSmoother:
    """Chebyshev polynomial smoother on B^{-1}A, B = slot-block diagonal.

    kind=1 classical / kind=4 fourth-kind (smoothers.relaxation.cheb_coefs)."""

    def __init__(self, blockinv, mask, lmax, lmin, degree=3, kind=1):
        self.blockinv = blockinv    # (n_groups, s, s)
        self.mask = mask            # (n_slots,) 1.0 real / 0.0 ghost
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree
        self.kind = kind

    def tree_flatten(self):
        return ((self.blockinv, self.mask), (self.lmax, self.lmin,
                                             self.degree, self.kind))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        blockinv, mask = ch
        return cls(blockinv, mask, *aux)

    def _binv(self, r):
        ng, s, _ = self.blockinv.shape
        rb = r.reshape(ng, s)
        return (jnp.einsum("bij,bj->bi", self.blockinv, rb,
                           precision=jax.lax.Precision.HIGHEST).reshape(-1)
                * self.mask)

    def smooth(self, A: DIA, x, b, iters=1, reverse=False):
        theta, coefs = cheb_coefs(self.lmax, self.lmin, self.degree,
                                  self.kind)
        for _ in range(iters):
            r = self._binv(A.residual(x, b))
            d = r / theta
            for ak, ck in coefs:
                x = x + d
                r = self._binv(A.residual(x, b))
                d = ak * d + ck * r
            x = x + d
        return x


@jax.tree_util.register_pytree_node_class
class StructuredOp:
    """Exact operator split  A = DIA + footprint-block correction.

    3D-1D coupling (cylinder average, /root/reference/src/emi_3d1d.py:65-68)
    gives each curve dof a wide 3D footprint; in slot space those entries
    scatter over O(1000) distinct diagonal offsets (measured: 1981 at 777
    dofs) — a plain DIA matvec would be a thousands-of-ops XLA program.
    Here every offset whose entries are all coverable by a footprint block
    moves into batched dense blocks (ids/mats); application is ONE 1-D
    gather + batched einsum + 1-D scatter-add on top of the narrow DIA
    matvec.  ids are padded with n (ghost slot)."""

    def __init__(self, dia, ids, mats, nnz=None, spill=None):
        self.dia = dia          # DIA
        self.ids = ids          # (nb, m) int32
        self.mats = mats        # (nb, m, m)
        self.spill = spill      # None | (rows, cols, vals): COO leftover
        #   (entries at rare offsets — bounds the DIA band count; one
        #   gather + scatter-add per apply, like the block part)
        self.shape = dia.shape
        self.nnz = nnz if nnz is not None else dia.nnz

    def tree_flatten(self):
        return ((self.dia, self.ids, self.mats, self.spill), (self.nnz,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        dia, ids, mats, spill = ch
        return cls(dia, ids, mats, aux[0], spill)

    @property
    def dtype(self):
        return self.dia.dtype

    def _block_apply(self, x):
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        xb = xpad[self.ids]
        yb = jnp.einsum("bij,bj->bi", self.mats, xb,
                        precision=jax.lax.Precision.HIGHEST)
        y = xpad.at[:].set(0.0).at[self.ids.reshape(-1)].add(
            yb.reshape(-1).astype(x.dtype))[:-1]
        if self.spill is not None:
            r_, c_, v_ = self.spill
            y = y.at[r_].add((v_ * x[c_]).astype(x.dtype))
        return y

    def matvec(self, x):
        return self.dia.matvec(x) + self._block_apply(x)

    def __matmul__(self, x):
        return self.matvec(x)

    def residual(self, x, b):
        return self.dia.residual(x, b) - self._block_apply(x)

    def diagonal(self):
        # offset 0 is always kept in the DIA part (split_footprint_operator)
        return self.dia.diagonal()


def _neighbor_blocks(A: HostCSR, seeds):
    """One block per seed: the seed + its full matrix-graph neighborhood
    (= the coupling footprint for 3D-1D curve dofs)."""
    indptr, indices = A.indptr, A.indices
    return [np.unique(np.concatenate(
        [[int(s)], indices[indptr[int(s)]:indptr[int(s) + 1]]]))
        for s in seeds]


def split_footprint_operator(A: HostCSR, blocks, max_offsets=None):
    """Exact split of A into (A_dia_host, ids, mats, spill).

    Every entry coverable by some block (both endpoints in it) is assigned
    to exactly one block; offsets whose entries are ALL coverable (except
    the main diagonal) move entirely to the block part, shrinking the DIA
    offset set from O(1000) to the bulk-stencil set.  Entries at offsets
    that also occur outside the blocks stay in the DIA part — the split is
    exact by construction (each entry lives in exactly one part).

    max_offsets: optional cap on the DIA band count — the most-populated
    offsets (main diagonal always) stay DIA, the tail moves to a COO
    ``spill`` (rows, cols, vals) applied as one gather + scatter-add
    (StructuredOp).  DIA planes are dense (band count x n values), so
    rare offsets waste ~n reads each; the cap bounds that at any scale.
    spill is None when nothing is capped."""
    n = A.shape[0]
    r, c, v = A.to_coo()
    # vectorized entry lookup (sorted-key searchsorted) + per-offset
    # coverage via bincount: the dict/per-offset-scan version was
    # O(nblocks*m^2 dict probes + noffsets*nnz) — quadratic blow-up at
    # production scale (86k distinct offsets x 4.3M nnz)
    keys = r.astype(np.int64) * n + c
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    covered = np.zeros(len(r), dtype=bool)
    assign = np.full(len(r), -1, dtype=np.int64)
    pos_i = np.zeros(len(r), dtype=np.int32)
    pos_j = np.zeros(len(r), dtype=np.int32)
    for bid, blk in enumerate(blocks):
        m = len(blk)
        kk = (blk[:, None].astype(np.int64) * n + blk[None, :]).ravel()
        loc = np.searchsorted(skeys, kk)
        locc = np.minimum(loc, len(skeys) - 1)
        hit = (loc < len(skeys)) & (skeys[locc] == kk)
        idx = order[locc[hit]]
        fresh = ~covered[idx]
        idxf = idx[fresh]
        covered[idxf] = True
        assign[idxf] = bid
        t = np.flatnonzero(hit)[fresh]
        pos_i[idxf] = (t // m).astype(np.int32)
        pos_j[idxf] = (t % m).astype(np.int32)
    offs = c - r
    uoff, oinv = np.unique(offs, return_inverse=True)
    tot = np.bincount(oinv)
    ncov = np.bincount(oinv, weights=covered).astype(np.int64)
    to_block = ((uoff != 0) & (ncov == tot))[oinv]
    keep = ~to_block
    spill = None
    if max_offsets is not None:
        cnt_keep = np.bincount(oinv[keep], minlength=len(uoff))
        sel = np.zeros(len(uoff), dtype=bool)
        sel[np.argsort(cnt_keep)[::-1][:max_offsets]] = True
        sel[uoff == 0] = True
        spill_sel = keep & ~sel[oinv]
        if spill_sel.any():
            spill = (r[spill_sel].astype(np.int64),
                     c[spill_sel].astype(np.int64), v[spill_sel])
            keep = keep & sel[oinv]
    A_dia = HostCSR.from_coo(r[keep], c[keep], v[keep], A.shape)
    nb = len(blocks)
    mpad = max((len(b) for b in blocks), default=1)
    ids = np.full((nb, mpad), n, dtype=np.int32)
    for bid, blk in enumerate(blocks):
        ids[bid, :len(blk)] = blk
    mats = np.zeros((nb, mpad, mpad))
    selb = np.flatnonzero(to_block)
    mats[assign[selb], pos_i[selb], pos_j[selb]] = v[selb]
    return A_dia, ids, mats, spill


@jax.tree_util.register_pytree_node_class
class FootprintMetricSmoother:
    """Exact colored-multiplicative footprint Schwarz + slot-block
    Chebyshev, composed symmetrically — the structured-path equivalent of
    HAZmath's metric smoother split (interface Schwarz + GS elsewhere,
    /root/reference/src/utils.py:84, input_metric.dat:57).

    Each Schwarz block holds one interface (curve) dof plus its FULL
    coupling footprint (the cylinder average couples a curve dof to every
    3D dof its circle touches, /root/reference/src/emi_3d1d.py:65-68 — a
    2-slot pair block cannot capture that), solved exactly; blocks are
    colored by overlap and swept multiplicatively (symmetric), the only
    variant measured gamma-robust (additive composite: 67 iters at
    gamma=1e8; PoU-weighted additive: diverges).

    Symmetry: pre-smooth = Schwarz(sym) then Chebyshev, post-smooth
    (reverse) = Chebyshev then Schwarz(sym) — the cycle operator stays
    symmetric (CG requirement)."""

    def __init__(self, schwarz, cheb):
        self.schwarz = schwarz
        self.cheb = cheb

    def tree_flatten(self):
        return ((self.schwarz, self.cheb), ())

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch)

    def smooth(self, A, x, b, iters=1, reverse=False):
        for _ in range(iters):
            if reverse:
                x = self.cheb.smooth(A, x, b, 1)
                x = self.schwarz.smooth(A, x, b, 1)
            else:
                x = self.schwarz.smooth(A, x, b, 1)
                x = self.cheb.smooth(A, x, b, 1)
        return x


@jax.tree_util.register_pytree_node_class
class StructuredLevel:
    """Duck-typed MG level: DIA operator + window-reshape transfers."""

    def __init__(self, A: DIA, smoother, mask, s, n_groups, nc=None):
        self.A = A
        self.smoother = smoother
        self.mask = mask
        self.s = s
        self.n_groups = n_groups
        # nc = next level's (padded) row count; groups beyond n_groups on
        # the coarse side are pure ghosts, handled by static zero-pad/slice
        self.nc = n_groups if nc is None else nc

    def tree_flatten(self):
        return ((self.A, self.smoother, self.mask),
                (self.s, self.n_groups, self.nc))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        A, sm, mask = ch
        return cls(A, sm, mask, *aux)

    def restrict(self, r):
        rc = (r * self.mask).reshape(self.n_groups, self.s).sum(axis=1)
        if self.nc > self.n_groups:
            rc = jnp.concatenate(
                [rc, jnp.zeros(self.nc - self.n_groups, dtype=r.dtype)])
        return rc

    def prolong(self, ec):
        e = ec[:self.n_groups]
        ef = jnp.broadcast_to(e[:, None],
                              (self.n_groups, self.s)).reshape(-1)
        return ef * self.mask


def _tail_matvec(prec, b):
    return prec.matvec(b)


_tail_jit = jax.jit(_tail_matvec)


class HostTailHybrid:
    """Structured window levels on device + the algebraic metric tail as
    a HOST-side CPU-jitted f64 program (NOT a pytree — drive with
    krylov.pcg_split, which runs fine.cycle_down / tail_apply /
    fine.cycle_up per PCG iteration).

    The tail is small, gather-heavy and needs f64; the boundary vectors
    between the window levels and the tail are tiny, so running it on the
    host costs two short transfers per cycle.  The split-launch design
    (rather than a host callback inside one program) keeps the device
    program free of host round trips.  Whether this still pays against
    the on-device algebraic tail is an open measurement."""

    def __init__(self, fine: MGPreconditioner, tail: MGPreconditioner,
                 A_boundary: HostCSR, coarse_scaling=False):
        cpu = jax.devices("cpu")[0]
        # Native C++/OpenMP tail executor (native/tailkit.cpp): the
        # jax-CPU cycle pays max-row-width padded-ELL reads + padded
        # Schwarz einsums on one core (~30 s per 383k-dof cycle at
        # production 3D-1D scale); the same cycle from CSR + ragged
        # blocks is sub-second.  None -> jax fallback (parity-tested;
        # TPUAMG_NO_NATIVE_TAIL=1 forces the fallback).
        from ..native.tail import build_native_tail
        self.native = build_native_tail(tail)
        # commit every tail leaf to the CPU device so _tail_jit
        # dispatches to the CPU backend (uncommitted arrays would
        # follow the default accelerator placement)
        self.tail = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, cpu) if isinstance(x, jax.Array)
            else x, tail)
        self.fine = fine
        self.coarse_scaling = coarse_scaling
        self._cpu = cpu
        self._Ab = A_boundary          # boundary operator (host CSR)
        self.nc = A_boundary.shape[0]  # boundary vector length

    def tail_apply(self, rc_np):
        """ec = tail V-cycle applied to the boundary residual (host)."""
        rc64 = np.asarray(rc_np, dtype=np.float64)
        if self.native is not None:
            ec = self.native.apply(rc64)
        else:
            rc = jax.device_put(jnp.asarray(rc64), self._cpu)
            ec = np.asarray(_tail_jit(self.tail, rc))
        if self.coarse_scaling and len(self.fine.levels) > 0:
            # the unified hybrid scales the boundary correction with
            # the tail's level-0 operator (hierarchy._cycle) — but only
            # when the boundary is between two levels: the unified
            # cycle never scales its own top-level output, so with no
            # device levels this scaling must be skipped for parity.
            Aec = self._Ab.matvec(ec)
            denom = float(ec @ Aec)
            alpha = min(max(float(rc64 @ ec) / denom, 0.0), 2.0) \
                if denom > 0 else 1.0
            ec = alpha * ec
        return ec


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------

def _grid_spacing(x):
    """Infer the native grid spacing of a coordinate array (median of
    positive diffs of the sorted unique values); 0 if degenerate."""
    u = np.unique(np.round(x, 12))
    if len(u) < 2:
        return 0.0
    d = np.diff(u)
    d = d[d > 1e-12]
    return float(np.median(d)) if len(d) else 0.0


def morton_code(coords, bits=16):
    """Z-order code per point (vectorized bit interleave), any dim <= 3.

    Coordinates are snapped to the data's own grid spacing per axis — for
    structured meshes neighbors then differ by exactly one quantum, so
    slot-distance offsets between mesh neighbors take only O(log n)
    distinct values (what keeps the DIA operators narrow)."""
    crd = np.asarray(coords, dtype=np.float64)
    lo = crd.min(axis=0)
    d = crd.shape[1]
    q = np.zeros((len(crd), d), dtype=np.uint64)
    lim = np.uint64(2 ** bits - 1)
    for k in range(d):
        h = _grid_spacing(crd[:, k])
        if h <= 0:
            q[:, k] = 0
            continue
        qi = np.round((crd[:, k] - lo[k]) / h).astype(np.int64)
        q[:, k] = np.minimum(np.maximum(qi, 0), lim).astype(np.uint64)
    code = np.zeros(len(crd), dtype=np.uint64)
    for b in range(bits):
        for k in range(d):
            code |= ((q[:, k] >> np.uint64(b)) & np.uint64(1)) << \
                np.uint64(b * d + k)
    return code


def _hem_pairs(A: HostCSR, theta, group=None):
    """Level-0 pairing: HEM matching on the strength graph. Returns
    match[i] = partner or -1.

    group: optional per-row window id — matching edges are restricted to
    same-window pairs (the banded-HEM hybrid: heavy-edge pairing with a
    bounded slot-distance footprint; see hem_tree_slots(window=...))."""
    S = strength_graph(A, theta)
    if group is not None:
        r, c, v = S.to_coo()
        keep = group[r] == group[c]
        S = HostCSR.from_coo(r[keep], c[keep], v[keep], S.shape)
    n = A.shape[0]
    # reuse the hand-shaking matching from aggregation (pairs only)
    agg, nagg = hem_aggregation(S)
    # agg groups of size <= 2 (single matching round set)  — hem_aggregation
    # does pure pairwise matching, so groups have size 1 or 2
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=nagg)
    match = np.full(n, -1, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    two = np.flatnonzero(sizes == 2)
    a1 = order[starts[two]]
    a2 = order[starts[two] + 1]
    match[a1] = a2
    match[a2] = a1
    return match


def _pad_to_multiple(A: HostCSR, mask, mult):
    """Pad rows/cols to a multiple of mult with identity ghost rows."""
    n = A.shape[0]
    n2 = ((n + mult - 1) // mult) * mult
    if n2 == n:
        return A, mask
    r, c, v = A.to_coo()
    extra = np.arange(n, n2)
    A2 = HostCSR.from_coo(np.concatenate([r, extra]),
                          np.concatenate([c, extra]),
                          np.concatenate([v, np.ones(n2 - n)]), (n2, n2))
    return A2, np.concatenate([mask, np.zeros(n2 - n)])


def _window_coarse(A: HostCSR, mask, s):
    """Galerkin coarse operator for window aggregation agg[i] = i // s,
    restricted to real (mask=1) rows; ghost-only windows become identity
    coarse rows with mask 0."""
    n = A.shape[0]
    ng = n // s
    r, c, v = A.to_coo()
    real = (mask[r] > 0) & (mask[c] > 0)
    rc = r[real] // s
    cc = c[real] // s
    mask_c = (mask.reshape(ng, s).sum(axis=1) > 0).astype(np.float64)
    dead = np.flatnonzero(mask_c == 0)
    Ac = HostCSR.from_coo(
        np.concatenate([rc, dead]), np.concatenate([cc, dead]),
        np.concatenate([v[real], np.ones(len(dead))]), (ng, ng))
    return Ac, mask_c


def _slot_blocks(A: HostCSR, s):
    """(n_groups, s, s) dense slot-diagonal blocks + batched inverses."""
    n = A.shape[0]
    ng = n // s
    r, c, v = A.to_coo()
    inblk = (r // s) == (c // s)
    blocks = np.zeros((ng, s, s))
    blocks[r[inblk] // s, r[inblk] % s, c[inblk] % s] = v[inblk]
    # ensure invertibility where a slot has an empty diagonal
    idx = np.arange(s)
    diag = blocks[:, idx, idx]
    blocks[:, idx, idx] = np.where(diag == 0, 1.0, diag)
    return np.linalg.inv(blocks)


def _estimate_lmax(A: HostCSR, blockinv, mask, s, iters=15, seed=0):
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    ng = blockinv.shape[0]
    x = rng.standard_normal(n) * mask
    lam = 1.0
    for _ in range(iters):
        y = A.matvec(x)
        y = np.einsum("bij,bj->bi", blockinv,
                      y.reshape(ng, s)).reshape(-1) * mask
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def hem_tree_slots(A_host: HostCSR, coords, theta=0.1, max_rounds=30,
                   coarse_units=4, window=0):
    """Multilevel HEM matching tree -> slot permutation.

    The Morton-window layout above coarsens geometrically, which loses
    gamma-robustness on the 3D-1D systems (iterations grow ~9 -> ~23
    over 10 decades of gamma: the coarse spaces stop resolving the
    metric coupling).  This ordering makes EVERY window of the
    structured hierarchy a heavy-edge aggregate instead:

    round 0 pairs dofs by HEM on strength(A) — exactly the pairing the
    Morton layout uses; each later round pairs the previous round's
    units by HEM on the pair-Galerkin coarse operator (metric-aware at
    every depth, like HAZmath's multilevel HEM,
    /root/reference/src/amg_parameters.py:59), with leftover singletons
    force-paired by Morton adjacency of their centroids so the tree
    stays perfect (ghosts only from odd counts).  The slot order is the
    DFS leaf order of the tree: a round-k unit occupies 2^k consecutive
    slots, so the s=2 / s=4 windows of setup_structured ARE the HEM
    aggregates — metric-aware coarsening at zero solve-path cost (the
    permutation is applied outside the jitted loop, like the Morton
    one).  Top-level units are ordered by centroid Morton code to keep
    what locality remains (DIA offset width).

    window > 0 selects the BANDED-HEM hybrid: each round's matching is
    restricted to pairs inside the same Morton macro-window of `window`
    units.  Pure HEM pairs globally by strength, which interleaves far
    dofs and widens the slot-space DIA bands toward dense at small n;
    the metric (gamma) couplings it must capture are spatially local
    (the 3D-1D cylinder average couples a curve dof to NEARBY 3D dofs),
    so windowed pairing keeps the heavy edges while bounding the
    band growth to ~window slots per round.

    Returns (slots0, nsl): slots0[dof] = leaf slot; nsl = total leaves
    (a power-of-two multiple of the top unit count)."""
    from ..sparse import rap_unsmoothed
    n0 = A_host.shape[0]
    crd = np.asarray(coords, dtype=np.float64)
    members = np.arange(n0, dtype=np.int64)[:, None]   # (nu, 2^k)
    cent = crd.copy()
    A = A_host
    rounds = 0
    while len(members) > coarse_units and rounds < max_rounds:
        group = None
        if window and len(members) > window:
            rank = np.empty(len(members), dtype=np.int64)
            rank[np.argsort(morton_code(cent), kind="stable")] = \
                np.arange(len(members))
            group = rank // int(window)
        match = _hem_pairs(A, theta * (0.5 ** rounds), group=group)
        left = np.flatnonzero(match < 0)
        if len(left) > 1:
            order = np.argsort(morton_code(cent[left]), kind="stable")
            lo = left[order]
            npair = len(lo) // 2
            a, b = lo[:2 * npair:2], lo[1:2 * npair:2]
            match[a] = b
            match[b] = a
        lead = (match < 0) | (np.arange(len(members)) < match)
        units = np.flatnonzero(lead)
        partner = match[units]
        w = members.shape[1]
        mem_new = np.full((len(units), 2 * w), -1, dtype=np.int64)
        mem_new[:, :w] = members[units]
        has_p = partner >= 0
        mem_new[has_p, w:] = members[partner[has_p]]
        cnt = (mem_new >= 0).sum(axis=1)
        csum = np.where((mem_new >= 0)[:, :, None],
                        crd[np.maximum(mem_new, 0)], 0.0).sum(axis=1)
        cent = csum / cnt[:, None]
        agg = np.empty(len(members), dtype=np.int64)
        agg[units] = np.arange(len(units))
        agg[partner[has_p]] = np.flatnonzero(has_p)
        A = rap_unsmoothed(A, agg, len(units))
        members = mem_new
        rounds += 1
    top = np.argsort(morton_code(cent), kind="stable")
    leaves = members[top].reshape(-1)
    nsl = len(leaves)
    slots0 = np.empty(n0, dtype=np.int64)
    real = leaves >= 0
    slots0[leaves[real]] = np.flatnonzero(real)
    return slots0, nsl


def lattice_tiled_slots(coords, idofs, n, tile=8, idof_stride=1):
    """Tiled-lattice slot ordering for grid-bulk + curve systems.

    Morton RANK ordering smears offsets on non-power-of-two boxes (a
    full 65^3 box has ~79k distinct 27-stencil rank offsets — measured),
    because rank != code unless the box is a full power of two.  Here
    the bulk dofs are snapped to their integer lattice, the lattice is
    padded to full `tile`^d tiles (ghost slots), tiles are ordered
    row-major and slots INSIDE a tile by Morton code — within a FULL
    power-of-two tile rank == code, so every in-tile and cross-tile
    neighbor offset is a trace-time constant: the whole stencil takes
    O(stencil) distinct offsets at ANY problem size (the scale-breaker
    for the Morton order at production 3D-1D size, 86k offsets).

    Interface dofs (idofs: the curve) get their own region AFTER the
    bulk slots, ordered by Morton code of their coordinates (curve
    locality); their wide couplings to the bulk are exactly the entries
    the footprint split moves out of the DIA.

    The s=2/4 windows of the structured hierarchy are Morton-consecutive
    in-tile slots: isotropic 2x coarsening inside tiles; window
    coarsening keeps the tiled structure (tile size shrinks 8->2 over
    three levels, then windows group row-major tiles).

    idof_stride > 1 reserves an ALIGNED block of `idof_stride` slots per
    interface dof (the dof at the block start, ghosts after): with
    stride 2*4^(L-1) an idof stays ALONE in its window through L window
    levels (s=2 then s=4 per setup_structured), i.e. it passes to every
    window coarse level by INJECTION — the metricAMG idofs contract
    (keep interface dofs to the coarsest level,
    /root/reference/src/utils.py:84) applied to the window hierarchy:
    coarse functions keep u1 free while u3 is window-constant, so the
    gamma-kernel (Pi u3 = u1) stays representable.  See
    setup_structured(keep_idofs=...).

    Returns (slots0, nsl); raises ValueError when the bulk dofs do not
    occupy a clean lattice (caller falls back to 'morton')."""
    n_all = n
    idofs = np.asarray(idofs, dtype=np.int64) if idofs is not None \
        else np.empty(0, dtype=np.int64)
    bulk = np.setdiff1d(np.arange(n_all), idofs)
    crd = np.asarray(coords, dtype=np.float64)
    cb = crd[bulk]
    d = cb.shape[1]
    q = np.zeros((len(bulk), d), dtype=np.int64)
    for k in range(d):
        h = _grid_spacing(cb[:, k])
        if h <= 0:
            raise ValueError("degenerate bulk lattice axis")
        qi = np.round((cb[:, k] - cb[:, k].min()) / h)
        if np.max(np.abs(qi - np.round(qi))) > 1e-6:
            raise ValueError("bulk dofs off-lattice")
        q[:, k] = qi.astype(np.int64)
    dims = q.max(axis=0) + 1
    # occupancy check: unique cell per dof, full box
    flat = q[:, 0]
    for k in range(1, d):
        flat = flat * dims[k] + q[:, k]
    if len(np.unique(flat)) != len(bulk) or len(bulk) != int(
            np.prod(dims)):
        raise ValueError("bulk dofs are not a full lattice")
    ntile = -(-dims // tile)
    tid = q // tile
    tflat = tid[:, 0]
    for k in range(1, d):
        tflat = tflat * ntile[k] + tid[:, k]
    code_in = morton_code(q % tile, bits=4)
    slots_bulk = tflat * (tile ** d) + code_in.astype(np.int64)
    nbulk = int(np.prod(ntile)) * tile ** d
    # idof blocks must start on idof_stride boundaries (window
    # alignment); tile**d covers strides up to 2*4^3 for d=3 tiles,
    # round up otherwise
    nbulk = -(-nbulk // idof_stride) * idof_stride
    slots0 = np.empty(n_all, dtype=np.int64)
    slots0[bulk] = slots_bulk
    if len(idofs):
        corder = np.argsort(morton_code(crd[idofs]), kind="stable")
        slots0[idofs[corder]] = nbulk + np.arange(len(idofs)) \
            * idof_stride
    nsl = nbulk + len(idofs) * idof_stride
    nsl = -(-nsl // 2) * 2
    return slots0, nsl


def setup_structured(A_host: HostCSR, coords,
                     params: AMGParameters = AMGParameters(),
                     dtype=jnp.float32, cheb_degree=3, cheb_ratio=8.0,
                     cheb_kind=1, pairs=None, idofs=None,
                     order="morton", algebraic_below=0, fp_maxlvl=1,
                     fp_solver="exact", gamma_data=None,
                     dia_max_offsets=1024, host_tail=False,
                     keep_idofs=0):
    """Build the gather-free structured hierarchy.

    coords: (n, d) spatial position per dof (field-stacked systems repeat
    mesh vertices per field; partner dofs share positions, so HEM pairs
    them and the Z-curve keeps them adjacent).
    pairs: optional explicit partner map (match[i] = j or -1); default =
    HEM matching on the strength graph.
    idofs: interface dofs with WIDE coupling footprints (3D-1D averaging:
    a curve dof couples to every 3D dof in its circle) — when given and
    params.schwarz_levels > 0, level 0 additionally gets footprint
    Schwarz blocks seeded at these dofs (FootprintMetricSmoother).
    order: "morton" (pair + Z-curve windows, geometric coarse levels) or
    "hem" (multilevel HEM matching tree: every window is a heavy-edge
    aggregate — metric-aware at every level; see hem_tree_slots).
    algebraic_below: real-dof threshold below which the remaining levels
    are built by the ALGEBRAIC metric-AMG setup (amg/hierarchy.setup_amg:
    HEM aggregation on the metric strength graph + interface Schwarz) —
    the hybrid that recovers the algebraic path's gamma-flat coarse
    spaces at structured-path speed: gather-based coarse levels are
    cheap once small, while the fine (window/DIA) levels carry the
    flops.  0 disables (pure window hierarchy).
    keep_idofs: L > 0 keeps every interface dof UNCOARSENED (passed by
    injection) through at most L window levels — the metricAMG idofs
    contract (/root/reference/src/utils.py:84) applied to the window
    hierarchy.  Plain window aggregation coarsens u1 together with the
    bulk, which destroys the gamma-kernel (Pi u3 = u1) in the coarse
    space — the measured round-4 gamma=1e8 stall at production curve
    density (docs/PERF_NOTES.md).  Requires the tiled slot order
    (idofs get aligned ghost-padded stride blocks); the level loop is
    capped at L so idofs reach the algebraic tail unmerged.  Slot
    inflation: (2*4^(L-1) - 1) ghost slots per interface dof.

    Returns (prec, slots0, n_slots0): solve in slot space —
        b_s = jnp.zeros(n_slots0).at[slots0].set(b)   # out-of-loop scatter
        ... jitted PCG on the permuted operator ...
        x = x_s[slots0]                                # out-of-loop gather
    """
    n0 = A_host.shape[0]
    crd = np.asarray(coords, dtype=np.float64)
    keep_idofs = int(keep_idofs or 0)
    if keep_idofs and (idofs is None or not len(idofs)):
        keep_idofs = 0
    stride = 2 * 4 ** (keep_idofs - 1) if keep_idofs else 1
    if order in ("tiled", "auto") and pairs is None:
        try:
            slots0, nsl = lattice_tiled_slots(crd, idofs, n0,
                                              idof_stride=stride)
        except ValueError:
            if order == "tiled":
                raise
            order = "morton"
        else:
            order = "_tiled_done"
    if keep_idofs and order != "_tiled_done":
        raise ValueError(
            "keep_idofs requires the tiled slot order (aligned idof "
            f"stride blocks); order={order!r} does not support it")
    if order == "_tiled_done":
        pass
    elif order is not None and order.startswith("hem") and pairs is None:
        # "hem" = global multilevel HEM tree; "hem_banded[:W]" = the
        # banded hybrid (HEM pairing inside Morton macro-windows of W
        # units, default 64 — narrow DIA bands, metric-aware windows)
        window = 0
        if order.startswith("hem_banded"):
            window = int(order.split(":", 1)[1]) if ":" in order else 64
        slots0, nsl = hem_tree_slots(A_host, crd, params.strong_coupled,
                                     window=window)
    else:
        match = pairs if pairs is not None else _hem_pairs(
            A_host, params.strong_coupled)

        # enumerate units (pairs + singletons), sort by Morton of centroid
        lead = (match < 0) | (np.arange(n0) < match)
        units = np.flatnonzero(lead)
        cent = crd[units].copy()
        has_p = match[units] >= 0
        cent[has_p] = 0.5 * (crd[units[has_p]] + crd[match[units[has_p]]])
        uorder = np.argsort(morton_code(cent), kind="stable")
        units = units[uorder]
        # slot layout: unit u -> slots (2u, 2u+1)
        slots0 = np.empty(n0, dtype=np.int64)
        slots0[units] = 2 * np.arange(len(units))
        partner = match[units]
        paired = partner >= 0
        slots0[partner[paired]] = 2 * np.flatnonzero(paired) + 1
        nsl = 2 * len(units)
    mask = np.zeros(nsl)
    mask[slots0] = 1.0

    r, c, v = A_host.to_coo()
    ghost = np.flatnonzero(mask == 0)
    A = HostCSR.from_coo(
        np.concatenate([slots0[r], ghost]),
        np.concatenate([slots0[c], ghost]),
        np.concatenate([v, np.ones(len(ghost))]), (nsl, nsl))

    # Footprint blocks only for genuinely low-dimensional interfaces
    # (3D-1D curve dofs: n1 << n).  For same-dimension interfaces
    # (bidomain/EMI trace coupling) the HEM pair blocks already solve
    # the coupling exactly and idofs can be O(n) — skip.
    fp_blocks = fp_seeds = None
    gd = None
    # keep_idofs forces the footprint machinery on: it exists exactly
    # for the 3D-1D production regime where the curve can be denser
    # than the O(n) gate allows (curve finer than bulk).  With
    # keep_idofs the footprint SPLIT (narrow DIA) is needed even at
    # schwarz_levels=0 — interface smoothing can live entirely in the
    # tail since the interface rows reach it by injection.
    if (idofs is not None
            and (params.schwarz_levels > 0 or keep_idofs)
            and (keep_idofs or 0 < len(idofs) * 8 < A_host.shape[0])):
        fp_seeds = np.sort(slots0[np.asarray(idofs)])
        fp_blocks = _neighbor_blocks(A, fp_seeds)
        if fp_solver == "rank1g":
            # gamma-exact O(m)-storage smoother: translate the original-
            # space gamma factorization (smoothers.rank1_gamma_data) into
            # slot space; coarsened per level by window restriction
            assert gamma_data is not None, "rank1g needs gamma_data"
            u_idx0, u_val0, c0, Dg0, l10 = gamma_data
            gd = {"seeds": slots0[np.asarray(idofs)],
                  "u_idx": [slots0[np.asarray(ui)] for ui in u_idx0],
                  "u_val": [np.asarray(uv, dtype=np.float64)
                            for uv in u_val0],
                  "c": np.asarray(c0, dtype=np.float64),
                  "Dg": np.zeros(nsl), "l1ad": np.ones(nsl)}
            gd["Dg"][slots0] = Dg0
            gd["l1ad"][slots0] = l10
    levels = []
    # interface slots tracked through window coarsening for the tail's
    # idofs contract — independent of the footprint machinery (the
    # fp gate can be off while window levels still exist; level-0 slot
    # indices passed to the tail were out of range then)
    tail_seeds = np.sort(slots0[np.asarray(idofs)]) \
        if idofs is not None and len(idofs) else None
    s = 2
    while (len(levels) < params.max_levels - 1
           and (not keep_idofs or len(levels) < keep_idofs)
           and mask.sum() > max(params.coarse_dof, algebraic_below)):
        A, mask = _pad_to_multiple(A, mask, s)
        ng = A.shape[0] // s
        if gd is not None and len(gd["Dg"]) < A.shape[0]:
            pad = A.shape[0] - len(gd["Dg"])
            gd["Dg"] = np.concatenate([gd["Dg"], np.zeros(pad)])
            gd["l1ad"] = np.concatenate([gd["l1ad"], np.ones(pad)])
        blockinv = _slot_blocks(A, s)
        fp_schwarz = None
        if fp_blocks is not None and len(levels) < params.schwarz_levels:
            # exact colored-multiplicative Schwarz on footprint blocks
            # with LOCAL per-color residuals — the full-matvec variant
            # traces ~300 XLA ops per color x O(10) colors (footprints
            # overlap ~10 deep along the curve): 28-minute compiles.
            # (See FootprintMetricSmoother for why not additive/PoU.)
            from ..smoothers.schwarz import (build_local_schwarz,
                                             build_rank1_schur,
                                             build_diag_rank1)
            mm = max(params.schwarz_mmsize,
                     max(len(b) for b in fp_blocks) + 1)
            if fp_solver == "rank1g":
                fp_schwarz = build_diag_rank1(
                    A, gd["seeds"],
                    (gd["u_idx"], gd["u_val"], gd["c"], gd["Dg"],
                     gd["l1ad"]),
                    maxlvl=fp_maxlvl, mmsize=mm, symmetric=True,
                    dtype=dtype)
            elif fp_solver == "exact":
                fp_schwarz = build_local_schwarz(
                    A, seeds=fp_seeds, maxlvl=fp_maxlvl,
                    mmsize=mm, symmetric=True, dtype=dtype,
                    cluster=getattr(params, "schwarz_cluster", False))
            else:
                fp_schwarz = build_rank1_schur(
                    A, seeds=fp_seeds, maxlvl=fp_maxlvl,
                    mmsize=mm, symmetric=True, dtype=dtype)
        lmax = _estimate_lmax(A, blockinv, mask, s)
        if fp_blocks is not None:
            # exact DIA + footprint-block split (O(1000) offsets would
            # otherwise land in the DIA)
            A_dia, op_ids, op_mats, spill = split_footprint_operator(
                A, fp_blocks, max_offsets=dia_max_offsets)
            D = DIA.from_host(A_dia, dtype=dtype)
            Adev = StructuredOp(D, jnp.asarray(op_ids),
                                jnp.asarray(op_mats, dtype=dtype),
                                nnz=A.nnz,
                                spill=None if spill is None else (
                                    jnp.asarray(spill[0]),
                                    jnp.asarray(spill[1]),
                                    jnp.asarray(spill[2], dtype=dtype)))
            smoother = BlockChebyshevSmoother(
                jnp.asarray(blockinv, dtype=dtype),
                jnp.asarray(mask, dtype=dtype),
                1.1 * lmax, 1.1 * lmax / cheb_ratio, cheb_degree,
                kind=cheb_kind)
            if fp_schwarz is not None:
                smoother = FootprintMetricSmoother(fp_schwarz, smoother)
        else:
            smoother = BlockChebyshevSmoother(
                jnp.asarray(blockinv, dtype=dtype),
                jnp.asarray(mask, dtype=dtype),
                1.1 * lmax, 1.1 * lmax / cheb_ratio, cheb_degree,
                kind=cheb_kind)
            Adev = DIA.from_host(A, dtype=dtype)
        levels.append(StructuredLevel(
            Adev, smoother,
            jnp.asarray(mask, dtype=dtype), s, ng))
        A, mask = _window_coarse(A, mask, s)
        if tail_seeds is not None:
            tail_seeds = np.unique(tail_seeds // s)
        if fp_blocks is not None:
            fp_blocks = [np.unique(blk // s) for blk in fp_blocks]
            fp_seeds = np.unique(fp_seeds // s)
            if gd is not None:
                # window restriction of the gamma data: directions sum
                # within windows (P^T u), l1 bounds sum (triangle ineq.)
                ngc = len(gd["Dg"]) // s
                gd["Dg"] = gd["Dg"][:ngc * s].reshape(ngc, s).sum(1)
                gd["l1ad"] = gd["l1ad"][:ngc * s].reshape(ngc, s).sum(1)
                gd["seeds"] = gd["seeds"] // s
                ui2, uv2 = [], []
                for ui, uv in zip(gd["u_idx"], gd["u_val"]):
                    uq, inv = np.unique(ui // s, return_inverse=True)
                    vv = np.zeros(len(uq))
                    np.add.at(vv, inv, uv)
                    ui2.append(uq)
                    uv2.append(vv)
                gd["u_idx"], gd["u_val"] = ui2, uv2
        s = 4

    # stitch level nc = next level's actual (padded) row count; the
    # coarsest structured level's nc = dense-coarse size (A as-is)
    for i, L in enumerate(levels):
        L.nc = levels[i + 1].A.shape[0] if i + 1 < len(levels) \
            else A.shape[0]
    if algebraic_below and mask.sum() > params.coarse_dof:
        # algebraic metric-AMG tail (see docstring): setup_amg keeps
        # level-0 size == A.shape[0] (pad_multiple=1), so the last
        # structured level's nc stitch above already matches.  Ghost
        # slots are isolated identity rows — batched into inert
        # aggregates by setup_amg._batch_isolated_rows.
        #
        # The tail always runs in f64 regardless of the fine-level
        # dtype: the metric tail is f32-FRAGILE (measured: the n=8
        # gamma=1e8 hybrid converges in 7 iterations in f64 but stalls
        # unconverged at 40 in f32 — gamma-cancellation noise in the
        # ELL residuals the multiplicative smoothers consume), while
        # the window levels are f32-robust.  The tail is small, so f64
        # costs little; jnp promotes the f32 restricted residual on
        # entry and the cycle casts back to the Krylov dtype on
        # exit.
        from dataclasses import replace as _replace
        from .hierarchy import setup_amg
        # The tail ALWAYS gets the interface dofs (metricAMG contract:
        # Schwarz on idofs, GS elsewhere — /root/reference/src/utils.py
        # :84).  fp_seeds carries them through window coarsening; with
        # no window levels (the production host-tail config) fall back
        # to the slot-space idofs directly.  The `len(idofs)*8 < n`
        # gate above only governs the DEVICE footprint machinery —
        # letting it strip the tail's idofs made setup_amg seed a
        # Schwarz block at EVERY dof (measured at the n=16
        # production-density dump: 7505 seeds x 500^2 dense inverses,
        # ~30 GB and minutes of inversion, plus the wrong smoother
        # semantics).
        tail_idofs = fp_seeds if fp_blocks is not None else tail_seeds
        if host_tail:
            # HOST tail: keep only the window levels on device and run
            # the algebraic tail as a CPU-jitted f64 program between
            # the two device launches of a split V-cycle (krylov.
            # pcg_split); the boundary vectors are tiny
            # (<=algebraic_below dofs).  Mathematically identical
            # to the unified hybrid for cycle='v', maxit=1 (the tail
            # recursion with zero initial guess IS tail.matvec).
            if params.cycle_type != "v" or params.maxit != 1:
                raise ValueError("host_tail supports cycle_type='v', "
                                 "maxit=1 (the .dat metric config)")
            cpu = jax.devices("cpu")[0]
            with jax.default_device(cpu):
                tail = setup_amg(A, _replace(params, dtype="float64"),
                                 idofs=tail_idofs)
            fine = MGPreconditioner(
                tuple(levels), None,
                cycle="v", maxit=1,
                presmooth=params.presmooth_iter,
                postsmooth=params.postsmooth_iter,
                amli_degree=params.amli_degree,
                max_w_work=params.max_w_work,
                coarse_scaling=params.coarse_scaling)
            prec = HostTailHybrid(fine, tail, A,
                                  coarse_scaling=params.coarse_scaling)
            n_slots0 = levels[0].A.shape[0] if levels else A.shape[0]
            return prec, slots0, n_slots0
        tail = setup_amg(A, _replace(params, dtype="float64"),
                         idofs=tail_idofs)
        prec = MGPreconditioner(
            tuple(levels) + tuple(tail.levels), tail.coarse_inv,
            cycle=params.cycle_type, maxit=params.maxit,
            presmooth=params.presmooth_iter,
            postsmooth=params.postsmooth_iter,
            amli_degree=params.amli_degree, max_w_work=params.max_w_work,
            coarse_scaling=params.coarse_scaling)
        n_slots0 = levels[0].A.shape[0] if levels else A.shape[0]
        return prec, slots0, n_slots0
    coarse_inv = np.linalg.inv(A.toarray()) if A.shape[0] else \
        np.zeros((0, 0))
    prec = MGPreconditioner(
        tuple(levels), jnp.asarray(coarse_inv, dtype=dtype),
        cycle=params.cycle_type, maxit=params.maxit,
        presmooth=params.presmooth_iter, postsmooth=params.postsmooth_iter,
        amli_degree=params.amli_degree, max_w_work=params.max_w_work,
        coarse_scaling=params.coarse_scaling)
    n_slots0 = levels[0].A.shape[0] if levels else A.shape[0]
    return prec, slots0, n_slots0


def structured_system(A_host: HostCSR, slots, n_slots, dtype=jnp.float32,
                      idofs=None, dia_max_offsets=1024):
    """Permute the outer operator into slot space (identity ghosts).

    idofs: as in setup_structured — when the interface dofs have wide
    coupling footprints (3D-1D), the operator is split into a narrow DIA
    plus batched footprint blocks (StructuredOp)."""
    r, c, v = A_host.to_coo()
    mask = np.zeros(n_slots)
    mask[slots] = 1.0
    ghost = np.flatnonzero(mask == 0)
    A_slots = HostCSR.from_coo(
        np.concatenate([slots[r], ghost]),
        np.concatenate([slots[c], ghost]),
        np.concatenate([v, np.ones(len(ghost))]), (n_slots, n_slots))
    if (idofs is not None
            and 0 < len(idofs) * 8 < A_host.shape[0]):
        blocks = _neighbor_blocks(A_slots,
                                  np.sort(slots[np.asarray(idofs)]))
        A_dia, op_ids, op_mats, spill = split_footprint_operator(
            A_slots, blocks, max_offsets=dia_max_offsets)
        return StructuredOp(DIA.from_host(A_dia, dtype=dtype),
                            jnp.asarray(op_ids),
                            jnp.asarray(op_mats, dtype=dtype),
                            nnz=A_slots.nnz,
                            spill=None if spill is None else (
                                jnp.asarray(spill[0]),
                                jnp.asarray(spill[1]),
                                jnp.asarray(spill[2], dtype=dtype)))
    return DIA.from_host(A_slots, dtype=dtype)
