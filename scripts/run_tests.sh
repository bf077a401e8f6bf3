#!/bin/bash
# Run the test suite on the CPU in fresh-interpreter batches.
#
# One pytest process accumulates XLA/LLVM compile state across the
# ~100 jitted multilevel programs and can segfault near the end
# (libgcc unwind SIGSEGV on a compile thread); batching sidesteps it
# and the persistent compile cache (tests/conftest.py) makes later
# batches/reruns fast.
set -u
cd "$(dirname "$0")/.."
ulimit -s unlimited 2>/dev/null || true
ENV=(env JAX_PLATFORMS=cpu)
rc=0
batches=(
  "tests/test_sparse.py tests/test_fem.py tests/test_io.py tests/test_native.py tests/test_native_tail.py tests/test_refine.py tests/test_runtime.py"
  "tests/test_amg.py tests/test_grid_path.py tests/test_problems.py tests/test_gmg.py tests/test_run_solver.py"
  "tests/test_xla_kernels.py tests/test_dist.py tests/test_3d1d_structured.py"
)
for b in "${batches[@]}"; do
  echo "=== pytest $b"
  "${ENV[@]}" python -m pytest $b -q "$@" || rc=$?
done
exit $rc
