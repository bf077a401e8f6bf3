"""Test configuration: JAX on a virtual 8-device CPU mesh with x64.

XLA fakes 8 host devices, so the shard_map / sharded code paths run for
real without a cluster (SURVEY.md §4).  Must run before jax is imported
anywhere.

JAX_PLATFORMS defaults to the CPU.  Tests marked ``gpu`` need the card:
they take the ``gpu_device`` fixture, which skips them when JAX sees no
GPU.  On a machine with one, run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import resource  # noqa: E402

# the default 8 MB stack soft-limit segfaults LLVM's recursive passes on
# the big unrolled multilevel programs (libgcc unwind SIGSEGV / "LLVM
# compilation error: Cannot allocate memory"); raise toward the hard cap
_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
_want = _hard if _hard != resource.RLIM_INFINITY else 1 << 30
if _soft != resource.RLIM_INFINITY and _soft < _want:
    try:
        resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))
    except (ValueError, OSError):
        pass

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent XLA compile cache: the suite compiles ~100 multilevel
# programs; with the cache, reruns skip compiles entirely.
import tpuamg  # noqa: E402

tpuamg.enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped when JAX sees none")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return gpus[0]
