"""Structured metrics / observability (SURVEY.md §5 aux subsystems).

The reference's observability is printf timers around stages; the driver
contract here asks for structured per-stage throughput counters
(overlaps/s/chip etc.) plus kernel-level profiling.  This module provides:

* :class:`Metrics` — named counters + wall-clock stage timers, emitted as
  one JSON line per stage to stderr (machine-parseable, greppable), and
  queryable by the pipelines for their stats objects;
* :func:`profile_scope` — a `jax.profiler` trace scope gated on the
  ``MECAT_PROFILE=<dir>`` env var, so any pipeline run can produce a
  TensorBoard-loadable device trace without code changes.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator


class Metrics:
    """Process-wide counters and stage timers with JSON-line emission."""

    def __init__(self, component: str, emit: bool = True):
        self.component = component
        self.counters: Dict[str, float] = defaultdict(float)
        self._emit = emit and os.environ.get("MECAT_METRICS", "1") != "0"

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def set(self, name: str, value: float) -> None:
        self.counters[name] = value

    @contextlib.contextmanager
    def stage(self, name: str, **extra) -> Iterator[None]:
        """Time a pipeline stage; emits one JSON line on exit."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.counters[f"{name}_seconds"] += dt
            self.emit(stage=name, seconds=round(dt, 3), **extra)

    def emit(self, **fields) -> None:
        if not self._emit:
            return
        rec = {"component": self.component, "ts": round(time.time(), 3),
               **fields}
        print(json.dumps(rec), file=sys.stderr, flush=True)

    def summary(self) -> Dict[str, float]:
        return dict(self.counters)

    def emit_summary(self, **extra) -> None:
        self.emit(event="summary", **{k: round(v, 3) if isinstance(v, float)
                                      else v
                                      for k, v in self.counters.items()},
                  **extra)


@contextlib.contextmanager
def profile_scope(name: str) -> Iterator[None]:
    """jax.profiler trace around a block, when MECAT_PROFILE=<dir> is set.

    The trace covers device kernels (the DP kernel, sort, gathers) and host
    dispatch; load the output directory in TensorBoard or `xprof`.
    """
    out_dir = os.environ.get("MECAT_PROFILE")
    if not out_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(os.path.join(out_dir, name))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
