"""The card a measurement ran on: the benchmark and the smoke test print
this beside every number, and refuse to run without a GPU."""
from __future__ import annotations

import subprocess
import sys


def card_lines():
    """One ``name, power.limit`` line per GPU, as nvidia-smi reports them
    (a card set below its top power limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()


def require_gpu():
    """jax.devices() when JAX's default devices are GPUs; otherwise print
    why to stderr and exit non-zero (a measurement never falls back to
    the CPU)."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX's default backend is {devices[0].platform!r}",
              file=sys.stderr)
        raise SystemExit(2)
    return devices


def device_summary(devices):
    """The device as JAX reports it (platform, kind, count)."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}
