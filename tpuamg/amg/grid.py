"""Grid-structured hierarchy: reshape-based geometric transfers with
Galerkin (algebraic) coarse operators for the reference's structured-mesh
problems.

All five reference problems discretize structured grids
(UnitSquare/UnitCubeMesh, utils.py:149-182).  With dofs kept in
lexicographic grid order the operator
has ~stencil-many DIA offsets at EVERY level, and 2x2(x2) window
aggregation is a pure reshape:

    restrict: (ny, nx) -> pad-to-even -> (ny/2, 2, nx/2, 2).sum((1, 3))
    prolong:  broadcast back, crop

No gathers, no scatters, no permutations between levels (the single
field-interleave permutation at level 0 is applied outside the jitted
loop).  Field handling: dofs are interleaved per node (u1_i, u2_i
adjacent), level 0 collapses the F fields of each node — the pairwise
metric aggregate of HAZmath's HEM on A + gamma*M — and the level-0
smoother solves the F x F node blocks exactly (batched inverses), which is
the gather-free equivalent of the interface Schwarz smoother
(/root/reference/src/utils.py:84).  Coarse operators remain Galerkin
products of the true matrix (algebraic, not rediscretized), so Dirichlet
elimination and coefficient jumps are respected; masked (eliminated) rows
are excluded from the coarse sum.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import HostCSR
from ..sparse.dia import DIA
from ..config import AMGParameters
from .hierarchy import MGPreconditioner
from .structured import BlockChebyshevSmoother


@jax.tree_util.register_pytree_node_class
class ChebyshevDiagSmoother:
    """Chebyshev on D^{-1}A with a masked diagonal (coarse grid levels)."""

    def __init__(self, invd, mask, lmax, lmin, degree=3, kind=1):
        self.invd = invd
        self.mask = mask
        self.lmax = lmax
        self.lmin = lmin
        self.degree = degree
        self.kind = kind

    def tree_flatten(self):
        return ((self.invd, self.mask), (self.lmax, self.lmin,
                                         self.degree, self.kind))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        invd, mask = ch
        return cls(invd, mask, *aux)

    def _binv(self, r):
        return self.invd * r * self.mask

    smooth = BlockChebyshevSmoother.smooth   # same recurrence


@jax.tree_util.register_pytree_node_class
class GridLevel:
    """MG level over a (dims) grid; optional per-node field axis F.

    Vector layout: fields fastest, then grid axes lex (last axis fastest):
    flat index = ((i0*d1 + i1)*... )*F + f.
    Transfers: collapse F (if collapse_fields) and halve each grid axis.
    """

    def __init__(self, A: DIA, smoother, mask, dims, F):
        self.A = A
        self.smoother = smoother
        self.mask = mask
        self.dims = tuple(dims)     # static grid dims
        self.F = F                  # fields per node (static; kept at
        #                             every level — the coarse space must
        #                             represent each field separately or
        #                             the u1-u2 component loses its coarse
        #                             correction at small gamma)
        cd = tuple((d + 1) // 2 for d in dims)
        self.cdims = cd
        self.nc = int(np.prod(cd)) * F

    def tree_flatten(self):
        return ((self.A, self.smoother, self.mask), (self.dims, self.F))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        A, sm, mask = ch
        return cls(A, sm, mask, *aux)

    def restrict(self, r):
        g = (r * self.mask).reshape(self.dims + (self.F,))
        pads = [(0, d % 2) for d in self.dims] + [(0, 0)]
        g = jnp.pad(g, pads)
        for ax in range(len(self.dims)):
            d2 = (self.dims[ax] + 1) // 2
            shape = g.shape[:ax] + (d2, 2) + g.shape[ax + 1:]
            g = g.reshape(shape).sum(axis=ax + 1)
        return g.reshape(-1)

    def prolong(self, ec):
        g = ec.reshape(self.cdims + (self.F,))
        for ax in range(len(self.dims)):
            g = jnp.repeat(g, 2, axis=ax)
            g = jax.lax.slice_in_dim(g, 0, self.dims[ax], axis=ax)
        return g.reshape(-1) * self.mask


def interleave_fields(nv, F):
    """slots[f*nv + v] = v*F + f — per-node field interleave."""
    v = np.arange(nv)
    slots = np.empty(nv * F, dtype=np.int64)
    for f in range(F):
        slots[f * nv:(f + 1) * nv] = v * F + f
    return slots


def _permute(A: HostCSR, slots, n_out):
    r, c, v = A.to_coo()
    return HostCSR.from_coo(slots[r], slots[c], v, (n_out, n_out))


def _grid_coarse(A: HostCSR, mask, dims, F):
    """Galerkin window-coarse operator: aggregate = (2^d grid-cell window,
    field) — the field axis is preserved.  Masked rows excluded; empty
    aggregates become identity rows with mask 0."""
    d = len(dims)
    cdims = tuple((x + 1) // 2 for x in dims)
    n = A.shape[0]
    idx = np.arange(n)
    f = idx % F
    node = idx // F
    coords = []
    rem = node
    for ax in reversed(range(d)):
        coords.append(rem % dims[ax])
        rem //= dims[ax]
    coords = coords[::-1]                   # coords[ax]
    cnode = 0
    for ax in range(d):
        cnode = cnode * cdims[ax] + coords[ax] // 2
    agg = cnode * F + f
    r, c, v = A.to_coo()
    real = (mask[r] > 0) & (mask[c] > 0)
    nc = int(np.prod(cdims)) * F
    sums = np.bincount(agg, weights=mask, minlength=nc)
    mask_c = (sums > 0).astype(np.float64)
    dead = np.flatnonzero(mask_c == 0)
    Ac = HostCSR.from_coo(
        np.concatenate([agg[r[real]], dead]),
        np.concatenate([agg[c[real]], dead]),
        np.concatenate([v[real], np.ones(len(dead))]), (nc, nc))
    return Ac, mask_c, cdims


def _node_blocks(A: HostCSR, F):
    n = A.shape[0]
    ng = n // F
    r, c, v = A.to_coo()
    inblk = (r // F) == (c // F)
    blocks = np.zeros((ng, F, F))
    blocks[r[inblk] // F, r[inblk] % F, c[inblk] % F] = v[inblk]
    idx = np.arange(F)
    diag = blocks[:, idx, idx]
    blocks[:, idx, idx] = np.where(diag == 0, 1.0, diag)
    return np.linalg.inv(blocks)


def _lmax_blockinv(A: HostCSR, apply_binv, mask, iters=15, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0]) * mask
    lam = 1.0
    for _ in range(iters):
        y = apply_binv(A.matvec(x)) * mask
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


def setup_grid(A_host: HostCSR, dims, F=1, mask=None,
               params: AMGParameters = AMGParameters(),
               dtype=jnp.float32, cheb_degree=3, cheb_ratio=8.0,
               cheb_kind=1):
    """Build the grid hierarchy for a field-stacked structured-grid system.

    A_host: monolithic operator in *field-major* order ([u1-block; u2-...]);
    dims: grid dims (points per axis, last axis fastest in vertex order);
    F: number of fields. Returns (prec, slots, n) with slots the
    field-interleave permutation (apply outside the loop)."""
    nv = int(np.prod(dims))
    assert A_host.shape[0] == nv * F
    slots = interleave_fields(nv, F)
    A = _permute(A_host, slots, nv * F)
    if mask is None:
        mask_np = np.ones(nv * F)
    else:
        mask_np = np.zeros(nv * F)
        mask_np[slots] = np.asarray(mask, dtype=np.float64)

    levels = []
    dims_cur = tuple(dims)
    while (len(levels) < params.max_levels - 1
           and mask_np.sum() > params.coarse_dof):
        if F > 1:
            blockinv = _node_blocks(A, F)

            def apply_binv(r, bi=blockinv, s=F):
                return np.einsum("bij,bj->bi", bi,
                                 r.reshape(-1, s)).reshape(-1)
            lmax = _lmax_blockinv(A, apply_binv, mask_np)
        else:
            dg = A.diagonal().copy()
            dg[dg == 0] = 1.0
            blockinv = (1.0 / dg).reshape(-1, 1, 1)

            def apply_binv(r, iv=1.0 / dg):
                return iv * r
            lmax = _lmax_blockinv(A, apply_binv, mask_np)
        if F > 1:
            smoother = BlockChebyshevSmoother(
                jnp.asarray(blockinv, dtype=dtype),
                jnp.asarray(mask_np, dtype=dtype),
                1.1 * lmax, 1.1 * lmax / cheb_ratio, cheb_degree,
                kind=cheb_kind)
            Adev = DIA.from_host(A, dtype=dtype)
        else:
            smoother = ChebyshevDiagSmoother(
                jnp.asarray(blockinv.reshape(-1), dtype=dtype),
                jnp.asarray(mask_np, dtype=dtype),
                1.1 * lmax, 1.1 * lmax / cheb_ratio, cheb_degree,
                kind=cheb_kind)
            Adev = DIA.from_host(A, dtype=dtype)
        levels.append(GridLevel(
            Adev, smoother,
            jnp.asarray(mask_np, dtype=dtype), dims_cur, F))
        A, mask_np, dims_cur = _grid_coarse(A, mask_np, dims_cur, F)

    coarse_inv = np.linalg.inv(A.toarray()) if A.shape[0] else \
        np.zeros((0, 0))
    prec = MGPreconditioner(
        tuple(levels), jnp.asarray(coarse_inv, dtype=dtype),
        cycle=params.cycle_type, maxit=params.maxit,
        presmooth=params.presmooth_iter, postsmooth=params.postsmooth_iter,
        amli_degree=params.amli_degree, max_w_work=params.max_w_work,
        # AMG_coarse_scaling is pinned OFF on the whole grid path: the
        # grid-path iteration counts recorded in the tables were taken
        # with the unscaled cycle, and the window coarse spaces carry
        # their own geometric scaling; scaling is honored on the
        # algebraic + structured paths.
        coarse_scaling=False)
    return prec, slots, nv * F


def grid_system(A_host: HostCSR, slots, dtype=jnp.float32):
    """Outer operator in interleaved order (DIA)."""
    n = A_host.shape[0]
    return DIA.from_host(_permute(A_host, slots, n), dtype=dtype)
