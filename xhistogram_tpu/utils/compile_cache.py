"""Persistent XLA compile cache for the repository's scripts.

JAX keys its persistent cache on the directory path, so the cache lives at a
fixed place: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX
reads that variable itself), else ``<root>/.jax_cache``.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]


def compile_cache_dir(root, environ=None):
    """``(path, from_env)``: the compile-cache directory for scripts rooted
    at ``root``, and whether the environment chose it."""
    environ = os.environ if environ is None else environ
    path = environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path, True
    return os.path.join(os.path.abspath(root), ".jax_cache"), False


def enable_compile_cache(root):
    """Point JAX's persistent compile cache at ``compile_cache_dir(root)``.

    Sets nothing when the environment already names the directory.
    Returns the directory."""
    path, from_env = compile_cache_dir(root)
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
