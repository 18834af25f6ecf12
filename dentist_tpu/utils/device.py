"""The GPU a measurement runs on: refuse anything else, and name the card.

Timings are only meaningful on the accelerator users run, so measuring
scripts (``bench.py``, ``chip_smoke.py``) fail on any other backend
instead of falling back to the CPU, and print the card's name and power
limit beside their numbers (a card set below its maximum power runs
slower under load).
"""

from __future__ import annotations

import subprocess


def require_gpu(devices):
    """Return ``devices[0]`` if it is a GPU; otherwise exit non-zero."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU: JAX's first device is on platform "
                         f"{found!r}; this measurement runs only on a GPU")
    return devices[0]


def nvidia_smi_name_power() -> list[str]:
    """``name, power.limit`` of each card, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def describe(devices) -> dict:
    """Platform, kind and count of the devices JAX reports."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
