"""Process set-up shared by the entry points (CLI, bench, GPU smoke test).

* :func:`enable_compile_cache` — JAX's persistent compilation cache.  When
  ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and nothing is
  changed; otherwise the cache lives at ``<checkout>/.jax_cache``, a fixed
  path, so a later process on the same checkout finds it again.
* :func:`describe_device` — the device as JAX reports it, plus the card's
  name and power limit as ``nvidia-smi`` reports them (a card set below
  its maximum power runs slower under load, so every timing names both).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = ["CACHE_DIR", "enable_compile_cache", "describe_device",
           "card_name_and_power"]

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def card_name_and_power() -> str:
    """``name, power.limit`` of every card, one line each, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def describe_device() -> dict:
    """Platform, kind and count of JAX's devices and the card's name and
    power limit."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power()}
