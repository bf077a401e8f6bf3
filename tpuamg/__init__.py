"""tpuamg: metric-AMG sparse solver framework in JAX.

Rebuilds the capabilities of anabudisa/metric-amg-examples (FEniCS +
HAZmath + cbc.block) as a JAX/XLA stack; see SURVEY.md for the structural
map and README.md for the component overview.
"""
import os

# Fixed cache location inside the checkout (listed in .gitignore), so
# every run from one checkout finds what an earlier run compiled.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compilation_cache_dir():
    """The persistent compile-cache directory this process uses:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache():
    """Persistent XLA compilation cache: the jitted PCG+cycle programs are
    large (unrolled multilevel traces); caching makes repeated CLI and
    benchmark runs start in seconds instead of minutes.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no other
    directory is set here.  Returns the directory in use."""
    import jax
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


class profile_trace:
    """Device-trace context: `with tpuamg.profile_trace("/tmp/tr"): ...`
    writes a TensorBoard-compatible jax.profiler trace (per-kernel device
    timelines) — the equivalent of the reference's wall-clock timers and
    HAZmath print_level breakdowns (SURVEY.md §5.1)."""

    def __init__(self, logdir):
        self.logdir = str(logdir)

    def __enter__(self):
        import jax
        os.makedirs(self.logdir, exist_ok=True)
        jax.profiler.start_trace(self.logdir)
        return self

    def __exit__(self, *exc):
        import jax
        jax.profiler.stop_trace()
        return False
