"""The device a benchmark or smoke run measures, and the refusal to measure
anything else.

Every timed number this repository prints names the device it ran on.  A
run that finds no GPU fails instead of timing the CPU backend.
"""
from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """JAX's device as ``{"platform", "kind", "count"}``; raises SystemExit
    when JAX's default device is not a GPU."""
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {dev.platform!r}; this run "
            "measures the card only")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def card() -> str:
    """The cards' names and power limits, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (one line per card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def header() -> dict:
    """``require_gpu()`` plus the card line; printed first by every run."""
    info = require_gpu()
    info["card"] = card()
    return info
