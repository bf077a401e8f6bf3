"""DIA (diagonal) sparse format — the gather-free grid/structured format.

FE matrices from structured meshes are inherently multi-diagonal (the fine
bidomain operator has 17 distinct offsets in interleaved order), and AMG
coarse operators stay diagonal-concentrated when coarse dofs are ordered
by aggregate centroid.  The grid and structured solve paths store every
level as DIA:

    y = sum_d  data[d, :] * x_padded[PAD + offset_d : PAD + offset_d + n]

— a static-offset dynamic_slice per diagonal, no gather at all.  XLA
fuses the whole sum into one loop kernel that streams the diagonal planes
once; the SpMV is bound by memory bandwidth.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .host import HostCSR


@jax.tree_util.register_pytree_node_class
class DIA:
    """offsets: static tuple of ints; data: (ndiags, n) with data[d, i] =
    A[i, i + offsets[d]] (zero where out of range)."""

    def __init__(self, offsets, data, shape, nnz=None):
        self.offsets = tuple(int(o) for o in offsets)
        self.data = data
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int(np.count_nonzero(
            np.asarray(data)))

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (data,) = children
        offsets, shape, nnz = aux
        obj = cls.__new__(cls)
        obj.offsets = offsets
        obj.data = data
        obj.shape = shape
        obj.nnz = nnz
        return obj

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_host(A: HostCSR, dtype=jnp.float32) -> "DIA":
        n, m = A.shape
        assert n == m, "DIA path expects square operators"
        r, c, v = A.to_coo()
        offs = c - r
        uoffs = np.unique(offs)
        data = np.zeros((len(uoffs), n), dtype=np.float64)
        idx = np.searchsorted(uoffs, offs)
        data[idx, r] = v
        return DIA(uoffs.tolist(), jnp.asarray(data, dtype=dtype), (n, n),
                   nnz=A.nnz)

    def to_host(self) -> HostCSR:
        n = self.shape[0]
        data = np.asarray(self.data)
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            r = np.arange(max(0, -off), min(n, n - off))
            c = r + off
            vv = data[d, r]
            keep = vv != 0
            rows.append(r[keep])
            cols.append(c[keep])
            vals.append(vv[keep])
        return HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                                np.concatenate(vals), self.shape)

    def matvec(self, x):
        n = self.shape[0]
        pad = max((abs(o) for o in self.offsets), default=0)
        if pad == 0:
            return self.data[0] * x if self.offsets == (0,) else \
                jnp.zeros_like(x)
        xp = jnp.pad(x, (pad, pad))
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            seg = jax.lax.dynamic_slice(xp, (pad + off,), (n,))
            y = y + self.data[d] * seg
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def residual(self, x, b):
        """b - A @ x (XLA fuses the subtraction into the SpMV kernel)."""
        return b - self.matvec(x)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros(self.shape[0], dtype=self.data.dtype)

    def astype(self, dtype):
        return DIA(self.offsets, self.data.astype(dtype), self.shape,
                   self.nnz)


def _dia_matvec(M, x):
    return M.matvec(x)


def dia_matvec_op(A: DIA):
    """Partial-wrapped matvec (krylov-compatible operator).  The function
    is module-level: a fresh lambda per call would give every operator
    its own pytree structure, so each solve would trace and compile the
    Krylov program again."""
    return jax.tree_util.Partial(_dia_matvec, A)
