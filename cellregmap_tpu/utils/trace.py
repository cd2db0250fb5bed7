"""Tracing / profiling / structured logging for scans.

The reference has no observability beyond tqdm bars and commented-out
``time()`` scaffolding (/root/reference/cellregmap/_cellregmap.py:385-387,
407,421,428).  This module provides the equivalents promised in
SURVEY.md section 5.1/5.5:

- ``trace_scope(name)``: a context manager that both times the scope on the
  host and annotates it in the device trace via
  ``jax.profiler.TraceAnnotation``, so xprof timelines line up with the
  engine's phases (null-fit grid, Newton polish, score pass, p-value tail).
- ``PhaseTimers``: an accumulator of per-phase wall times; every scan method
  returns its timers inside the ``info`` dict when ``ScanConfig.trace`` is
  on.
- ``profile_to(logdir)``: wraps ``jax.profiler.trace`` for capturing a full
  xprof/Tensorboard trace of one scan.
- ``log_event(event, **fields)``: one-line structured (JSON) logging on the
  ``cellregmap_tpu`` logger; silent unless the application configures
  logging.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Dict, Iterator, Optional

logger = logging.getLogger("cellregmap_tpu")


def log_event(event: str, **fields) -> None:
    """Emit one structured JSON log line (INFO) on the package logger."""
    if logger.isEnabledFor(logging.INFO):
        logger.info("%s", json.dumps({"event": event, **fields}, default=str,
                                     sort_keys=True))


class PhaseTimers:
    """Accumulates wall-clock seconds per named phase.

    Device work launched inside a phase is NOT forced to completion; phases
    that need device time to be attributed correctly should end with the
    result already blocked on (the api layer's batch loop calls
    ``jax.device_get``, which blocks, so its phase times are true).
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with _device_annotation(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.seconds.items(), key=lambda kv: -kv[1]))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        body = ", ".join(f"{k}={v:.3f}s" for k, v in self.summary().items())
        return f"PhaseTimers({body})"


@contextlib.contextmanager
def _device_annotation(name: str) -> Iterator[None]:
    """jax.profiler.TraceAnnotation if available, else a no-op."""
    try:
        import jax.profiler as _prof

        with _prof.TraceAnnotation(name):
            yield
    except Exception:
        yield


@contextlib.contextmanager
def trace_scope(name: str,
                timers: Optional[PhaseTimers] = None) -> Iterator[None]:
    """Time + annotate a scope; accumulate into ``timers`` when given."""
    if timers is not None:
        with timers.phase(name):
            yield
    else:
        t0 = time.perf_counter()
        with _device_annotation(name):
            yield
        log_event("trace_scope", name=name,
                  seconds=round(time.perf_counter() - t0, 6))


@contextlib.contextmanager
def profile_to(logdir: str) -> Iterator[None]:
    """Capture an xprof trace of the enclosed scope into ``logdir``.

    View with TensorBoard's profile plugin or xprof.  On a GPU the trace
    includes the device kernel timelines; on CPU it is host-only.
    """
    import jax.profiler as _prof

    _prof.start_trace(logdir)
    try:
        yield
    finally:
        _prof.stop_trace()
