"""The device a measurement ran on, and the refusal to measure without one."""

from __future__ import annotations

import subprocess


def require_gpu() -> None:
    """Exit non-zero unless JAX's default backend is a GPU: a device
    measurement never falls back to the CPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"this run needs a GPU, but JAX's default backend is {backend!r}"
        )


def device_info() -> dict:
    """Platform, kind and count of the devices as JAX reports them."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def nvidia_smi() -> str:
    """The cards' name and power limit, one line per card, as nvidia-smi
    reports them (a card set below its maximum power runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def peak_bytes_in_use() -> int | None:
    """Peak device memory the program's arrays took on device 0."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")
