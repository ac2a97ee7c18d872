"""Persistent XLA compilation cache wiring.

The device path's fused truncate+expand dispatch compiles PER (pa, m,
max_dim) shape (the pa retention ladder exists precisely to bound the shape
count).  Those compiles are deterministic, so JAX's persistent compilation
cache removes them from every process after the first: a cold process's
first solve then costs what a warm solve costs, plus only
cache-deserialization milliseconds.

Placement: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself, and nothing here overrides it); otherwise the fixed directory
``<checkout>/.jax_cache`` next to the package.  The path is part of the
cache's key, so it must not move between runs.

Call :func:`enable` early (before the first jit execution) — ``bench.py``
and ``chip_smoke.py`` do, and long-lived services should too.
"""

import os

#: Fixed in-checkout location used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset (git-ignored).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir():
    """The directory the persistent cache lives in (see module doc)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable(*, min_compile_time=1.0):
    """Turn on JAX's persistent compilation cache at :func:`cache_dir`.

    ``min_compile_time``: only cache compilations that took at least this
    many seconds (the tiny eager-op compiles are cheaper to redo than to
    serialize).  Returns the cache directory.
    """
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time))
    # Cache every kind of miss (including first-ever compiles).
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
