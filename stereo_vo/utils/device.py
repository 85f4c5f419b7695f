"""The accelerator this program measures and runs on: one NVIDIA GPU.

Entry points that need the card call ``require_gpu`` and fail without one;
none falls back to the CPU.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    pass


def require_gpu():
    """JAX's default device; raises ``NoGPUError`` unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default device is {dev.platform} ({dev.device_kind})"
        )
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one per line.

    Run as a child process that does not use JAX; a card set below its
    maximum power runs slower under load, so this goes beside every
    device number."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
