"""Lightweight span tracer emitting Chrome-trace (about://tracing) JSON.

Port of cslam_tpu/runtime/tracing.py (pure Python). Every SwarmNode
stage can be wrapped in a `span`, and the result loaded straight into
chrome://tracing / Perfetto beside a `torch.profiler` device trace.

Design constraints:
- Disabled tracer costs one attribute check per span (no clock reads,
  no allocation) — safe to leave instrumented in production code.
- Spans nest arbitrarily; each thread is its own Chrome-trace `tid`
  row, each process (robot) its own `pid` row, so multi-robot missions
  overlay cleanly.
- Bounded memory: a deque ring of `capacity` events; a saturated
  mission drops the OLDEST events and counts the drops (`n_dropped`).
- CUDA kernels launched inside a span run asynchronously: a span covers
  the host-side launches unless the stage itself synchronizes with the
  card (the solver stages do: they copy their results to the host, and
  each descriptor search copies its top-k back). A span around pure
  device work therefore reads host time, not device time; the dump
  says so in its "async_note" metadata.

Enable globally via `tracer.enable(path)` or the CSLAM_TRACE=path
environment variable (checked at import).
"""

import atexit
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = ["Tracer", "tracer", "span"]


class Tracer:
    """Process-wide span recorder; see module docstring."""

    def __init__(self, capacity: int = 200_000):
        self.enabled = False
        self._path = None
        self._events = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._pid_label = None
        self.n_dropped = 0
        self._t0 = time.perf_counter()

    # -- control ------------------------------------------------------
    def enable(self, path: str, pid_label: str = None):
        """Start recording; `path` is written on dump()/process exit.

        pid_label names this process's row in the viewer (e.g. "r3").
        """
        self._path = path
        self._pid_label = pid_label
        self.enabled = True
        atexit.register(self._dump_at_exit)

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events.clear()
            self.n_dropped = 0

    # -- recording ----------------------------------------------------
    @contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        tid = threading.get_ident()
        t_begin = time.perf_counter()
        try:
            yield
        finally:
            t_end = time.perf_counter()
            with self._lock:
                if len(self._events) == self._events.maxlen:
                    self.n_dropped += 2
                # Complete ("X") events: one record per span keeps the
                # ring twice as deep as B/E pairs would.
                self._events.append({
                    "name": name, "ph": "X", "pid": self._pid, "tid": tid,
                    "ts": (t_begin - self._t0) * 1e6,
                    "dur": (t_end - t_begin) * 1e6,
                    "args": args,
                })

    def instant(self, name: str, **args):
        """Zero-duration marker (message arrivals, state transitions)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "s": "t", "pid": self._pid,
                "tid": threading.get_ident(),
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "args": args,
            })

    def counter(self, name: str, **values):
        """Chrome-trace counter track (queue depths, comm bytes)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "C", "pid": self._pid,
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "args": values,
            })

    # -- output -------------------------------------------------------
    def dump(self, path: str = None) -> str:
        """Write the chrome-trace JSON file; returns the path."""
        path = path or self._path
        with self._lock:
            events = list(self._events)
        meta = []
        if self._pid_label:
            meta.append({"name": "process_name", "ph": "M",
                         "pid": self._pid,
                         "args": {"name": self._pid_label}})
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "n_dropped": self.n_dropped,
                "async_note": "spans cover host-side time; device work "
                              "is async unless the stage syncs",
            },
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def _dump_at_exit(self):
        if self.enabled and self._path:
            try:
                self.dump()
            except Exception:
                pass


#: process-wide default tracer; `span("x")` is shorthand for
#: `tracer.span("x")`.
tracer = Tracer()
span = tracer.span

_env_path = os.environ.get("CSLAM_TRACE")
if _env_path:
    tracer.enable(_env_path)
