"""Native (C++) host data layer, loaded via ctypes.

The reference keeps its data layer in C++ (SURVEY.md §2.1 component 1);
host-side parsing/serialisation throughput must not starve the chip
(SURVEY.md §7 "Hard parts" #5), so the hot host paths are native here too.
The library is compiled on first import with g++ (cached next to the source);
every caller has a pure-Python fallback, so an unavailable toolchain degrades
performance, not capability.  Set MECAT_NO_NATIVE=1 to force the
fallbacks (used by differential tests).
"""
from __future__ import annotations

import os

from .api import NativeLib, load

_lib: NativeLib | None = None
_tried = False


def get() -> NativeLib | None:
    """The loaded native library, or None if unavailable/disabled."""
    global _lib, _tried
    if os.environ.get("MECAT_NO_NATIVE"):
        return None
    if not _tried:
        _tried = True
        try:
            _lib = load()
        except Exception as exc:  # toolchain missing / compile failure
            import sys
            print(f"mecat_jax.native: falling back to Python data layer "
                  f"({exc})", file=sys.stderr)
            _lib = None
    return _lib


def available() -> bool:
    return get() is not None
