"""Which device a measurement ran on.

Every number the tools print names its device: JAX's platform, kind and
count, and for an NVIDIA card the name and power limit as `nvidia-smi`
reports them (a card set below its maximum power runs slower under
load, so a time without its power limit cannot be compared).
"""

from __future__ import annotations

import subprocess
from typing import Optional


def card_name_and_power() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per
    card, or None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def jax_device() -> dict:
    """{"platform", "kind", "count"} of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
