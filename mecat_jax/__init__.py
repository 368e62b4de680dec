"""mecat_jax: a JAX long-read overlap / error-correction / mapping framework.

Built from scratch in JAX with the capabilities of xiaochuanle/MECAT
(mecat2pw, mecat2cns, mecat2ref, extract_sequences, and the correct+trim
pipeline).  See SURVEY.md for the blueprint and provenance notes.
"""
import os

__version__ = "0.1.0"

#: the compile cache when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: path (the path is part of the cache key, so it must not move)
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE


def _configure_compilation_cache():
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    Set through the config API: JAX may have been imported (and read its
    environment) before this package.
    """
    import jax

    cache_dir = compile_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_configure_compilation_cache()
