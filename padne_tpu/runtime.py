"""Process-level JAX configuration shared by the entry points.

Two settings live here so that the CLI, the serve daemon, bench.py and
chip_smoke.py agree on them:

* the persistent compile cache: JAX_COMPILATION_CACHE_DIR when the
  environment sets it (JAX reads the variable itself), otherwise one
  fixed directory: ``<repo root>/.jax_cache`` when the package runs
  from a source checkout, else ``~/.cache/padne_tpu/jax_cache``;
* pinning a process to the CPU before any backend starts, so a client
  of the serve daemon never opens the accelerator the daemon holds.
"""

from __future__ import annotations

import os
import pathlib

PACKAGE_PARENT = pathlib.Path(__file__).resolve().parent.parent


def default_cache_dir(root: pathlib.Path = PACKAGE_PARENT) -> pathlib.Path:
    """``<root>/.jax_cache`` when root is a source checkout (it holds
    pyproject.toml); otherwise a fixed per-user directory, since an
    installed package or a bundled binary lives in site-packages or an
    unpacked temporary tree."""
    if (root / "pyproject.toml").is_file():
        return root / ".jax_cache"
    return pathlib.Path.home() / ".cache" / "padne_tpu" / "jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(default_cache_dir())
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def pin_to_cpu() -> None:
    """Restrict this process to the CPU backend.  Call it before any
    JAX backend starts; raises RuntimeError when the process already
    runs on another platform (it holds an accelerator, and must not
    hand its solves to a daemon that holds the same card)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError(
            f"this process already runs on {jax.default_backend()!r}; "
            "pin_to_cpu must come before any JAX backend starts")
