"""Persistent XLA compilation cache, shared by every entry point.

The cache key includes its directory, so the directory must not move between
runs: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
otherwise ``.jax_cache/`` at the root of the checkout (listed in
``.gitignore``).
"""

from __future__ import annotations

import os

#: fixed in-checkout cache directory used when the environment names none
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """The directory the persistent compilation cache uses."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str | None:
    """Turn on the persistent compilation cache for this process and return
    its directory. The CPU backend (tests, tiny smoke runs) keeps none: its
    programs compile in seconds, and cached CPU executables are tied to the
    host's instruction set."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
