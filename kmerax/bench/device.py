"""The device a measurement ran on.

Every benchmark result names its device, and a measurement path that finds
no GPU stops instead of timing the CPU backend.
"""

from __future__ import annotations

import shutil
import subprocess


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's devices, as JAX reports them.
    Raises SystemExit (non-zero) unless the first device is a GPU."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {info['platform']} "
            f"({info['kind']}) — no result")
    return info


def card_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card (the
    power limit caps the clocks a card holds under load)."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return out.stdout.strip() or out.stderr.strip()
