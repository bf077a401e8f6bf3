"""Runtime plumbing: the compile-cache location, the native library build,
the GPU guard of bench.py / chip_smoke.py, and chip_smoke's helpers."""
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import tpuamg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _load("chip_smoke")


def _ignored_dirs():
    """Directory patterns of the repository's .gitignore."""
    with open(os.path.join(ROOT, ".gitignore")) as f:
        return {ln.strip().rstrip("/") for ln in f
                if ln.strip().endswith("/")}


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert tpuamg.compilation_cache_dir() == str(tmp_path / "c")
    assert tpuamg.enable_compilation_cache() == str(tmp_path / "c")
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = tpuamg.enable_compilation_cache()
    assert path == tpuamg.DEFAULT_CACHE_DIR
    assert path == os.path.join(ROOT, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.relpath(path, ROOT) in _ignored_dirs()


def test_empty_cache_variable_means_default(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert tpuamg.compilation_cache_dir() == tpuamg.DEFAULT_CACHE_DIR


def test_native_library_builds_into_ignored_dir():
    from tpuamg import native
    assert native.get_lib() is not None
    assert os.path.dirname(native._LIB) == native._BUILD_DIR
    assert os.path.exists(native._LIB)
    assert os.path.relpath(native._BUILD_DIR, ROOT) in _ignored_dirs()
    # no prebuilt library beside the sources
    assert not [f for f in os.listdir(native._HERE)
                if f.endswith(".so")]


@pytest.mark.parametrize("ok", [True, False])
def test_check_exits_nonzero_on_failure(chip_smoke, capsys, ok):
    if ok:
        chip_smoke.check(True, "thing")
    else:
        with pytest.raises(SystemExit) as e:
            chip_smoke.check(False, "thing")
        assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert out == f"  check thing: {'ok' if ok else 'FAILED'}\n"


@pytest.mark.parametrize("argv", [[], ["--four-cards"], ["--gamma1"]])
def test_chip_smoke_refuses_cpu(chip_smoke, capsys, argv):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_bench_refuses_cpu(capsys):
    bench = _load("bench")
    with pytest.raises(SystemExit) as e:
        bench.main(["--n", "4"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_stencil_offsets_follow_the_grid(chip_smoke):
    """The offsets chip_smoke rewrites for n=1024 are the ones the grid
    path itself builds at that size (checked here at n=8 -> n=16)."""
    from tpuamg.amg.grid import grid_system, interleave_fields
    offs = {}
    for n in (8, 16):
        _, _, A, _, _ = chip_smoke.assemble_bidomain(n, 1e6)
        slots = interleave_fields((n + 1) ** 2, 2)
        offs[n] = list(grid_system(A, slots, dtype=jnp.float64).offsets)
    assert chip_smoke.stencil_offsets(offs[8], 8, 16) == offs[16]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dia_case_reference(chip_smoke, dtype):
    offs = [-7, -1, 0, 1, 7]
    D, ref = chip_smoke.dia_case(offs, 60, dtype, seed=0)
    np.testing.assert_allclose(np.asarray(D.to_host().toarray()),
                               ref.toarray(), rtol=0, atol=0)
    assert D.data.dtype == dtype


def test_cpu_table_errors_row(chip_smoke):
    e1, e2 = chip_smoke.cpu_table_errors(526338)
    assert e1 == pytest.approx(0.012443541800750298)
    assert e2 == pytest.approx(0.005565276198602372)


def test_compile_clock_counts_compiles(chip_smoke):
    import time
    clock = chip_smoke.CompileClock()
    mark = clock.mark()
    t0 = time.time()
    jax.jit(lambda v: jnp.sin(v) * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()
    wall = time.time() - t0
    assert 0.0 < clock.since(mark) <= wall


def test_union_length(chip_smoke):
    assert chip_smoke.union_length([(5, 9), (0, 2), (1, 3), (8, 10)]) == 8
    assert chip_smoke.union_length([]) == 0


def test_compile_clock_merges_nested_spans(chip_smoke):
    clock = chip_smoke.CompileClock.__new__(chip_smoke.CompileClock)
    clock.spans = [(10.0, 20.0), (12.0, 15.0), (18.0, 25.0), (30.0, 31.0),
                   (1.0, 5.0)]
    assert clock.since(0.0) == 20.0
    assert clock.since(13.0) == 13.0
