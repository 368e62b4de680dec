"""What the program asks of the device it runs on.

Two decisions live here so that every module makes them the same way:
whether the device dataflow paths are taken (an accelerator backend), and
how large the memory-sized caps are (a fraction of the device's memory).
Both are made at run time, never at import: touching the backend at import
would break ``jax.distributed.initialize``.
"""
from __future__ import annotations

#: the device memory the memory-sized caps were first sized against; each
#: cap keeps the same fraction of the device's ``bytes_limit``
REFERENCE_DEVICE_BYTES = 16 << 30


def on_accelerator() -> bool:
    """True when JAX's default backend is an accelerator.

    Then the device paths are taken: device index build, device query
    gather, fused ``-j 1`` pw, ``correct_batch_device`` and the CUDA DP
    kernel.  On the CPU backend the host paths stay the default; the tests
    use them as the plain references.
    """
    import jax

    return jax.default_backend() != "cpu"


def device_bytes_limit() -> int:
    """The default device's usable memory (``memory_stats()["bytes_limit"]``).

    Raises when the device does not report it: a cap sized from a guess
    would fail later and less clearly.
    """
    import jax

    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(f"device {dev.device_kind!r} reports no "
                           "memory_stats()['bytes_limit']")
    return int(limit)


def memory_scaled(value: int) -> int:
    """``value``, sized for :data:`REFERENCE_DEVICE_BYTES` of device memory,
    scaled to this device's memory.  Unchanged on the CPU backend."""
    if not on_accelerator():
        return value
    return max(1, value * device_bytes_limit() // REFERENCE_DEVICE_BYTES)


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each: a card set below its maximum power runs slower under load, so
    every measurement is reported beside this.  Runs in a child process
    that stays off JAX."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
