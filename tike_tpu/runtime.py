"""Process set-up shared by the repository's entry-point scripts.

``chip_smoke.py``, ``bench.py`` and ``bench_all.py`` call these before their
first compilation. Nothing here runs on import: the library itself never
sets a compile-cache directory and never inspects the devices.
"""

from __future__ import annotations

import os
import subprocess

import jax


def enable_compile_cache(checkout: str) -> str:
    """Keep JAX's persistent compile cache at one fixed path; return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache lives in ``<checkout>/.jax_cache``, a
    path that does not move between runs, so a later process finds what an
    earlier one compiled.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(os.path.abspath(checkout), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str:
    """What ``nvidia-smi --query-gpu=name,power.limit`` says, one card a line."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as error:
        return f"nvidia-smi unavailable: {error}"
    return (out.stdout or out.stderr).strip()


def device_summary() -> dict:
    """Platform, device kind and count of JAX's default backend."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu() -> dict:
    """:func:`device_summary`, raising unless JAX's devices are GPUs."""
    summary = device_summary()
    if summary["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX's default devices are {summary}")
    return summary


def describe_run(cache_dir: str) -> list[str]:
    """Header lines every measurement prints before its results; the
    first is ``nvidia-smi``'s own output, one card a line."""
    return [
        gpu_name_and_power_limit(),
        f"device: {device_summary()}",
        f"jax {jax.__version__}",
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
        f"compile cache: {cache_dir}",
    ]
