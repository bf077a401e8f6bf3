"""The device kernels as XLA compiles them: DIA SpMV and residual against
scipy, the Chebyshev smoother recurrences against numpy, and explicit
HIGHEST precision on every float32 dot of the solve path (so a GPU
cannot drop them to TF32)."""
import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from tpuamg.sparse import HostCSR, ELL
from tpuamg.sparse.dia import DIA


def _grid_offsets(stencil):
    """Offsets of a structured-grid operator in lexicographic order:
    2D 5-point (n=24), 3D 7-point (n=10), and the 2-field interleaved
    2D P1 operator of the bidomain grid path (n=16)."""
    if stencil == "2d":
        n = 24
        return n * n, [-n, -1, 0, 1, n]
    if stencil == "3d":
        n = 10
        return n ** 3, [-n * n, -n, -1, 0, 1, n, n * n]
    n = 16
    nodes = [0, 1, n + 1, n + 2]
    offs = sorted({2 * s * o + df for o in nodes for s in (-1, 1)
                   for df in (-1, 0, 1)})
    return 2 * (n + 1) ** 2, offs


def _random_dia(stencil, storage, seed=0):
    """DIA with random planes in `storage` dtype, and the float64 scipy
    matrix of exactly the stored values."""
    nrows, offsets = _grid_offsets(stencil)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), nrows))
    rows = np.arange(nrows)
    for d, o in enumerate(offsets):
        data[d, (rows + o < 0) | (rows + o >= nrows)] = 0.0
    dev = jnp.asarray(data, dtype=storage)
    stored = np.asarray(dev.astype(jnp.float64))
    r = np.concatenate([rows] * len(offsets))
    c = np.concatenate([rows + o for o in offsets])
    keep = (c >= 0) & (c < nrows)
    ref = sp.csr_matrix((stored.reshape(-1)[keep], (r[keep], c[keep])),
                        shape=(nrows, nrows))
    return DIA(offsets, dev, (nrows, nrows)), ref


# float64 storage is exact up to summation order; float32 and bfloat16
# storage run the arithmetic in float32 (vectors are float32), so the
# bound is float32 rounding over <= 9 terms
_TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}


@pytest.mark.parametrize("op", ["matvec", "residual"])
@pytest.mark.parametrize("stencil", ["2d", "3d", "bidomain"])
@pytest.mark.parametrize("storage", ["float64", "float32", "bfloat16"])
def test_dia_against_scipy(storage, stencil, op):
    D, ref = _random_dia(stencil, storage)
    vdt = jnp.float64 if storage == "float64" else jnp.float32
    rng = np.random.default_rng(1)
    n = ref.shape[0]
    x = jnp.asarray(rng.standard_normal(n), vdt)
    b = jnp.asarray(rng.standard_normal(n), vdt)
    x64 = np.asarray(x, np.float64)
    b64 = np.asarray(b, np.float64)
    if op == "matvec":
        got = jax.jit(lambda A, v: A.matvec(v))(D, x)
        want = ref @ x64
    else:
        got = jax.jit(lambda A, v, w: A.residual(v, w))(D, x, b)
        want = b64 - ref @ x64
    assert got.dtype == vdt
    err = np.linalg.norm(np.asarray(got, np.float64) - want) \
        / np.linalg.norm(want)
    assert err <= _TOL[storage], err


def _wrap_dia(seed):
    from tpuamg.sparse.dia import dia_matvec_op
    return dia_matvec_op(_random_dia("2d", "float64", seed)[0])


def _wrap_dense_inverse(seed):
    from tpuamg.problems.solve import _dense_inv_op
    rng = np.random.default_rng(seed)
    A = sp.csr_matrix(rng.standard_normal((5, 5)) + 5.0 * np.eye(5))
    return _dense_inv_op(HostCSR(A.indptr, A.indices, A.data, A.shape),
                         jnp.float64)


@pytest.mark.parametrize("wrap", [_wrap_dia, _wrap_dense_inverse])
def test_operator_wrappers_share_one_compiled_program(wrap):
    """Two operators of the same shapes are one pytree structure, so a
    second solve reuses the compiled Krylov program of the first."""
    a, b = wrap(0), wrap(1)
    assert jax.tree_util.tree_structure(a) == \
        jax.tree_util.tree_structure(b)
    traces = []
    f = jax.jit(lambda op, v: (traces.append(1), op(v))[1])
    v = jnp.ones(a.args[0].shape[0], jnp.float64)
    f(a, v)
    f(b, v)
    assert len(traces) == 1


def _numpy_chebyshev(A, binv, x, b, lmax, lmin, degree, kind):
    """Reference polynomial smoother, written from the textbook
    recurrences (Saad, Alg. 12.1, for kind 1; Lottes 2022, Alg. 3, for
    the fourth kind)."""
    if kind == 1:
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = binv(b - A @ x) / theta
        for _ in range(1, degree):
            x = x + d
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + 2.0 * rho_new / delta * binv(b - A @ x)
            rho = rho_new
        return x + d
    d = 4.0 / (3.0 * lmax) * binv(b - A @ x)
    for k in range(1, degree):
        x = x + d
        d = ((2 * k - 1) / (2 * k + 3)) * d \
            + (8 * k + 4) / ((2 * k + 3) * lmax) * binv(b - A @ x)
    return x + d


def _spd_block_problem(nb, s, seed=0):
    rng = np.random.default_rng(seed)
    n = nb * s
    M = sp.random(n, n, density=4.0 / n, random_state=rng)
    A = (M + M.T + sp.eye(n) * 8.0).tocsr()
    H = HostCSR(A.indptr, A.indices, A.data, A.shape)
    blocks = np.stack([np.linalg.inv(A[i * s:(i + 1) * s,
                                       i * s:(i + 1) * s].toarray())
                       for i in range(nb)])
    return A, H, blocks, rng


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("kind", [1, 4])
def test_block_chebyshev_matches_numpy(kind, degree):
    from tpuamg.amg.structured import BlockChebyshevSmoother
    nb, s = 40, 2
    A, H, blocks, rng = _spd_block_problem(nb, s)
    mask = np.ones(nb * s)
    mask[-3:] = 0.0                      # ghost rows stay untouched

    def binv(r):
        return np.einsum("bij,bj->bi", blocks, r.reshape(nb, s)) \
            .reshape(-1) * mask
    lmax, lmin = 2.0, 0.25
    x0 = rng.standard_normal(nb * s)
    b = rng.standard_normal(nb * s)
    sm = BlockChebyshevSmoother(jnp.asarray(blocks), jnp.asarray(mask),
                                lmax, lmin, degree, kind=kind)
    D = DIA.from_host(H, dtype=jnp.float64)
    got = jax.jit(lambda S, M, v, w: S.smooth(M, v, w))(
        sm, D, jnp.asarray(x0), jnp.asarray(b))
    want = _numpy_chebyshev(A, binv, x0, b, lmax, lmin, degree, kind)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("kind", [1, 4])
def test_diag_chebyshev_matches_numpy(kind, degree):
    from tpuamg.amg.grid import ChebyshevDiagSmoother
    A, H, _, rng = _spd_block_problem(30, 2, seed=3)
    n = A.shape[0]
    invd = 1.0 / A.diagonal()
    mask = np.ones(n)
    mask[:2] = 0.0

    def binv(r):
        return invd * r * mask
    lmax, lmin = 1.8, 0.3
    x0 = rng.standard_normal(n)
    b = rng.standard_normal(n)
    sm = ChebyshevDiagSmoother(jnp.asarray(invd), jnp.asarray(mask),
                               lmax, lmin, degree, kind=kind)
    got = jax.jit(lambda S, M, v, w: S.smooth(M, v, w))(
        sm, DIA.from_host(H, dtype=jnp.float64), jnp.asarray(x0),
        jnp.asarray(b))
    want = _numpy_chebyshev(A, binv, x0, b, lmax, lmin, degree, kind)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12)


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in fn's lowered program."""
    text = jax.jit(fn).lower(*args).as_text()
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert lines, "no dot in the lowered program"
    return [ln.split("precision = ")[1].split("]")[0] + "]"
            if "precision = " in ln else "<none>" for ln in lines]


def _f32(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _site_coarse_solve():
    from tpuamg.amg.hierarchy import MGPreconditioner
    P = MGPreconditioner((), _f32(np.eye(8)), cycle="v")
    return (lambda P, v: P._coarse_solve(v)), P, _f32(np.ones(8))


def _site_schwarz(additive):
    from tpuamg.smoothers.schwarz import SchwarzSmoother
    n, m = 16, 4
    ids = np.arange(n, dtype=np.int32).reshape(-1, m)
    sm = SchwarzSmoother([jnp.asarray(ids)], [_f32(np.ones((n // m, m, m)))],
                         additive=additive)
    A = ELL.from_host(HostCSR.eye(n), dtype=jnp.float32)
    return (lambda S, M, v: S.smooth(M, v, v)), sm, A, _f32(np.ones(n))


def _site_local_schwarz():
    from tpuamg.smoothers.schwarz import LocalSchwarzSmoother
    nb, m, K, n = 2, 3, 2, 6
    ids = np.arange(n, dtype=np.int32).reshape(nb, m)
    sm = LocalSchwarzSmoother([jnp.asarray(ids)],
                              [_f32(np.ones((nb, m, m)))],
                              [jnp.asarray(np.zeros((nb, m, K), np.int32))],
                              [_f32(np.ones((nb, m, K)))])
    return (lambda S, v: S._color_update(v, v, 0)), sm, _f32(np.ones(n))


def _site_block_chebyshev():
    from tpuamg.amg.structured import BlockChebyshevSmoother
    sm = BlockChebyshevSmoother(_f32(np.ones((4, 2, 2))), _f32(np.ones(8)),
                                2.0, 0.25)
    return (lambda S, v: S._binv(v)), sm, _f32(np.ones(8))


def _site_structured_op():
    from tpuamg.amg.structured import StructuredOp
    D = DIA((0,), _f32(np.ones((1, 6))), (6, 6))
    op = StructuredOp(D, jnp.asarray(np.arange(6, dtype=np.int32)
                                     .reshape(2, 3)),
                      _f32(np.ones((2, 3, 3))))
    return (lambda S, v: S.matvec(v)), op, _f32(np.ones(6))


def _site_dense_inverse():
    from tpuamg.problems.solve import _dense_inv_op
    op = _dense_inv_op(HostCSR.eye(5), jnp.float32)
    return (lambda f, v: f(v)), op, _f32(np.ones(5))


def _site_gmres_arnoldi():
    from tpuamg.krylov.gmres import _arnoldi_cycle
    A = jax.tree_util.Partial(lambda v: 2.0 * v)
    return (lambda A, v: _arnoldi_cycle(A, A, v, v, 3)), A, _f32(np.ones(6))


def _site_gmres_update():
    from tpuamg.krylov.gmres import _apply_update
    return (lambda V, x, y: _apply_update(V, x, y)), \
        _f32(np.ones((4, 6))), _f32(np.ones(6)), _f32(np.ones(3))


_SITES = {
    "coarse_solve": _site_coarse_solve,
    "schwarz_multiplicative": lambda: _site_schwarz(False),
    "schwarz_additive": lambda: _site_schwarz(True),
    "local_schwarz": _site_local_schwarz,
    "block_chebyshev": _site_block_chebyshev,
    "structured_footprint_blocks": _site_structured_op,
    "dense_block_inverse": _site_dense_inverse,
    "gmres_cgs2": _site_gmres_arnoldi,
    "gmres_update": _site_gmres_update,
}


@pytest.mark.parametrize("site", sorted(_SITES))
def test_float32_dots_ask_for_highest_precision(site):
    fn, *args = _SITES[site]()
    precs = _dot_precisions(fn, *args)
    assert all(p == "[HIGHEST, HIGHEST]" for p in precs), precs


@pytest.mark.gpu
def test_float32_dots_on_gpu_match_float64(gpu_device):
    """On the card, an f32 coarse solve agrees with float64 numpy to 1e-5
    relative — TF32 (about three decimal digits) would not."""
    from tpuamg.amg.hierarchy import MGPreconditioner
    rng = np.random.default_rng(0)
    nc = 2048
    inv = (rng.standard_normal((nc, nc)) / np.sqrt(nc)).astype(np.float32)
    r = rng.standard_normal(nc).astype(np.float32)
    P = jax.device_put(MGPreconditioner((), jnp.asarray(inv), cycle="v"),
                       gpu_device)
    got = jax.jit(lambda P, v: P._coarse_solve(v))(
        P, jax.device_put(jnp.asarray(r), gpu_device))
    want = inv.astype(np.float64) @ r.astype(np.float64)
    err = np.linalg.norm(np.asarray(got, np.float64) - want) \
        / np.linalg.norm(want)
    assert err <= 1e-5, err


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["float64", "float32"])
def test_dia_on_gpu_against_scipy(gpu_device, storage):
    D, ref = _random_dia("bidomain", storage)
    vdt = jnp.float64 if storage == "float64" else jnp.float32
    x = np.random.default_rng(1).standard_normal(ref.shape[0])
    xd = jax.device_put(jnp.asarray(x, vdt), gpu_device)
    got = jax.jit(lambda A, v: A.matvec(v))(jax.device_put(D, gpu_device),
                                           xd)
    want = ref @ np.asarray(xd, np.float64)
    err = np.linalg.norm(np.asarray(got, np.float64) - want) \
        / np.linalg.norm(want)
    assert err <= _TOL[storage], err
