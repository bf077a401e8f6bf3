"""System dump/load: the assemble -> solve -> visualize checkpoint pipeline.

Two on-disk layouts, both read by ``load_system``/``load_coupling``:

- the reference's handoff files (SURVEY.md §5.4), written by default:
  ``A.npy`` COO triplets ``np.c_[row, col, data]``
  (reference src/utils.py:304-333), ``b.npy`` dense RHS,
  ``idofs.npy`` / ``idofs3d.npy`` interface / 3d dof index ranges, and the
  optional ``Pi.npy``/``Mq.npy``/``gamma.npy``/``coords.npy`` extensions;
- the compact form (``compact=True``): ``A.npz`` (and ``Pi.npz``,
  ``Mq.npz``) as compressed CSR planes with int32 column indices, and
  every vector in one compressed ``vectors.npz``.  About a tenth of the
  COO size, and it loads into the identical HostCSR.

``solution.txt``: length-prefixed flat solution vector
(reference src/emi_3d1d.py:150-152).
"""
from __future__ import annotations

import os

import numpy as np

from ..sparse import HostCSR


def _save_csr(path, M: HostCSR):
    np.savez_compressed(path, indptr=M.indptr,
                        indices=M.indices.astype(np.int32), data=M.data,
                        shape=np.asarray(M.shape, dtype=np.int64))


def _load_csr(path):
    with np.load(path) as z:
        return HostCSR(z["indptr"], z["indices"], z["data"],
                       tuple(int(d) for d in z["shape"]))


def _save_coo(path, M: HostCSR):
    r, c, v = M.to_coo()
    np.save(path, np.c_[r.astype(np.float64), c.astype(np.float64), v])


def _load_coo(path, shape):
    coo = np.load(path)
    return HostCSR.from_coo(coo[:, 0].astype(np.int64),
                            coo[:, 1].astype(np.int64), coo[:, 2], shape)


def dump_system(A: HostCSR, b, sizes, folder, coords=None, coupling=None,
                gamma=None, compact=False):
    """Write A, b, idofs, idofs3d — utils.py:304-333 layout, or the
    compact form with ``compact=True`` (module docstring).

    coords: optional (n, d) dof coordinates, saved as ``coords.npy`` —
    an ADDITION to the reference format used by the structured path.

    coupling: optional (Pi, Mq) metric factorization (A = AD + gamma *
    R^T Mq R, R = [-Pi, I]) saved as ``Pi.npy``/``Mq.npy`` COO triplets
    plus ``gamma.npy`` — a further extension letting the offline solver
    build gamma-exact smoothers without re-deriving the split from A."""
    os.makedirs(folder, exist_ok=True)
    if not (np.all(np.isfinite(A.data)) and np.all(np.isfinite(b))):
        raise ValueError("dump_system: non-finite entries in A or b")
    n1 = sizes[0]
    ntot = sum(sizes)
    vectors = {"b": np.asarray(b, dtype=np.float64),
               "idofs": np.arange(n1, ntot, dtype=np.int32),
               "idofs3d": np.arange(n1, dtype=np.int32)}
    if coords is not None:
        vectors["coords"] = np.asarray(coords, dtype=np.float64)
    mats = {"A": A}
    if coupling is not None:
        Pi, Mq = coupling
        mats.update(Pi=Pi, Mq=Mq)
        vectors["gamma"] = np.asarray(
            [0.0 if gamma is None else float(gamma),
             float(Pi.shape[0]), float(Pi.shape[1])])
    if compact:
        for name, M in mats.items():
            _save_csr(os.path.join(folder, f"{name}.npz"), M)
        np.savez_compressed(os.path.join(folder, "vectors.npz"), **vectors)
        return
    for name, M in mats.items():
        _save_coo(os.path.join(folder, f"{name}.npy"), M)
    for name, v in vectors.items():
        np.save(os.path.join(folder, f"{name}.npy"), v)


def _load_vectors(folder):
    """name -> array for every vector of the dump (either layout)."""
    vpath = os.path.join(folder, "vectors.npz")
    if os.path.exists(vpath):
        with np.load(vpath) as z:
            return {k: z[k] for k in z.files}
    out = {}
    for name in ("b", "idofs", "idofs3d", "coords", "gamma"):
        path = os.path.join(folder, f"{name}.npy")
        if os.path.exists(path):
            out[name] = np.load(path)
    return out


def _load_matrix(folder, name, shape):
    path = os.path.join(folder, f"{name}.npz")
    if os.path.exists(path):
        return _load_csr(path)
    return _load_coo(os.path.join(folder, f"{name}.npy"), shape)


def load_system(folder, with_coords=False):
    """Read the dump back: (A: HostCSR, b, idofs, idofs3d[, coords])."""
    vec = _load_vectors(folder)
    b = vec["b"]
    n = len(b)
    A = _load_matrix(folder, "A", (n, n))
    if with_coords:
        return A, b, vec["idofs"], vec["idofs3d"], vec.get("coords")
    return A, b, vec["idofs"], vec["idofs3d"]


def load_coupling(folder):
    """Read the optional metric factorization dump:
    (gamma, Pi: HostCSR, Mq: HostCSR) or None when absent."""
    vec = _load_vectors(folder)
    if "gamma" not in vec:
        return None
    gamma, n1, n3 = vec["gamma"]
    Pi = _load_matrix(folder, "Pi", (int(n1), int(n3)))
    Mq = _load_matrix(folder, "Mq", (int(n1), int(n1)))
    return float(gamma), Pi, Mq


def write_solution(path_or_dir, x):
    """solution.txt: first entry is the length (emi_3d1d.py:150-152)."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, "solution.txt")
    out = np.concatenate([[float(len(x))], np.asarray(x, dtype=np.float64)])
    np.savetxt(path, out)
    return path


def read_solution(path_or_dir):
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, "solution.txt")
    sol = np.loadtxt(path)
    size = int(sol[0])
    return sol[1:1 + size]
