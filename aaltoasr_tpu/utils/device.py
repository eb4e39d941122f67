"""The card a measurement runs on: anything but a GPU is refused, and
the card's name and power limit come from ``nvidia-smi``."""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpu(prog: str):
    """The first device, which must be a GPU; exits 2 otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"{prog}: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        raise SystemExit(2)
    return dev


def nvidia_smi() -> str:
    """One ``name, power limit`` line per card, read by a child process
    that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
