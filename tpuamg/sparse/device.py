"""Device-resident sparse format (ELL / sliced-ELL) and SpMV.

Data-dependent CSR row pointers defeat XLA's static-shape model, so device
matrices are stored as **padded ELL**: dense ``(n, L)`` column-index and
value planes (L = max row nnz, padded entries point at a zero "ghost"
slot).  SpMV is then a gather + multiply + row-reduction, which XLA fuses
into one kernel.

This replaces the device role of HAZmath's ``dCSRmat`` SpMV inside the PCG
hot loop (/root/reference/src/bidomain_2d.py:205-206, SURVEY.md §3.1).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .host import HostCSR


@jax.tree_util.register_pytree_node_class
class ELL:
    """Padded ELL sparse matrix on device.

    cols: (n, L) int32 — column index per slot; padded slots point to column
          ``shape[1]`` (a ghost slot; matvec pads x with one trailing zero).
    vals: (n, L) float — value per slot; padded slots are 0.
    """

    def __init__(self, cols, vals, shape, nnz=None):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int(np.sum(np.asarray(vals) != 0))

    def tree_flatten(self):
        return (self.cols, self.vals), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals = children
        shape, nnz = aux
        obj = cls.__new__(cls)
        obj.cols = cols
        obj.vals = vals
        obj.shape = shape
        obj.nnz = nnz
        return obj

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def row_width(self):
        return self.cols.shape[1]

    @staticmethod
    def from_host(A: HostCSR, dtype=jnp.float32, width=None) -> "ELL":
        n, m = A.shape
        lens = A.row_lengths()
        L = int(lens.max()) if len(lens) and lens.max() > 0 else 1
        if width is not None:
            assert width >= L, (width, L)
            L = width
        cols = np.full((n, L), m, dtype=np.int32)  # ghost column
        vals = np.zeros((n, L), dtype=np.float64)
        # slot index of each nnz within its row
        slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(A.indptr[:-1], lens)
        rows = A.rows_expanded()
        cols[rows, slot] = A.indices
        vals[rows, slot] = A.data
        return ELL(jnp.asarray(cols), jnp.asarray(vals, dtype=dtype), (n, m),
                   nnz=A.nnz)

    def to_host(self) -> HostCSR:
        cols = np.asarray(self.cols)
        vals = np.asarray(self.vals)
        n, m = self.shape
        r, s = np.nonzero(cols != m)
        return HostCSR.from_coo(r, cols[r, s], vals[r, s], self.shape)

    # -- device kernels ----------------------------------------------
    def matvec(self, x):
        """y = A @ x.  x: (m,) -> (n,)."""
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        return jnp.sum(self.vals * xpad[self.cols], axis=1)

    def __matmul__(self, x):
        return self.matvec(x)

    def residual(self, x, b):
        """b - A @ x (duck-type parity with DIA)."""
        return b - self.matvec(x)

    def matvec_rows(self, x, row_ids):
        """Partial SpMV over a static set of rows (for multicolor GS):
        returns (A @ x)[row_ids] without touching other rows."""
        xpad = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        c = self.cols[row_ids]
        v = self.vals[row_ids]
        return jnp.sum(v * xpad[c], axis=1)

    def diagonal(self):
        n = self.shape[0]
        rows = jnp.arange(n)[:, None]
        hit = self.cols == rows
        return jnp.sum(jnp.where(hit, self.vals, 0), axis=1)

    def l1_row_norms(self):
        return jnp.sum(jnp.abs(self.vals), axis=1)

    def astype(self, dtype):
        return ELL(self.cols, self.vals.astype(dtype), self.shape, self.nnz)


def _ell_matvec(A: ELL, x):
    return A.matvec(x)


def matvec_op(A: ELL):
    """Bind an ELL matrix into a traceable operator: a
    ``jax.tree_util.Partial`` whose matrix data is a *traced pytree arg*, so
    jitted solvers (krylov.pcg) cache-key on shape/structure, not on the
    Python object — no recompile when values change."""
    import jax
    return jax.tree_util.Partial(_ell_matvec, A)


def ell_rows(A: ELL, row_ids) -> ELL:
    """Static row-slice of an ELL matrix (host-time; row_ids is concrete)."""
    return ELL(A.cols[np.asarray(row_ids)], A.vals[np.asarray(row_ids)],
               (len(row_ids), A.shape[1]))
