"""Structured logging (SURVEY.md §5 observability: replaces stderr printf)."""
from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(asctime)s %(name)s %(levelname).1s] %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("MECAT_LOG", "INFO").upper()
        logging.basicConfig(stream=sys.stderr, level=level, format=_FMT,
                            datefmt="%H:%M:%S")
        _configured = True
    return logging.getLogger(f"mecat_jax.{name}")
