"""Lightweight span tracer emitting Chrome-trace (about://tracing) JSON.

Port of cslam_tpu/runtime/tracing.py (pure Python). Every SwarmNode
stage can be wrapped in a `span`, and the result loaded straight into
chrome://tracing / Perfetto beside a `torch.profiler` device trace.

Design constraints:
- A span on a thread that records nothing returns one shared no-op
  context manager: no clock read, no allocation beyond the call's
  keyword dict, a thread-local depth count — safe to leave instrumented
  in production code.
- Spans nest arbitrarily; each thread is its own Chrome-trace `tid`
  row, each process (robot) its own `pid` row, so multi-robot missions
  overlay cleanly.
- Whether a thread records is decided once, when its outermost span
  opens: spans, instants and counters inside it are recorded if and
  only if that span is, whatever `enable`/`disable` do meanwhile. A
  stage that straddles the moment tracing starts or stops (a solve on
  the back-end's worker thread) is then recorded whole or not at all,
  so its counters always go with its span. Outside any span the
  tracer's current state decides.
- Bounded memory: a deque ring of `capacity` events (a million by
  default: a sim5r.explore window of ~22,000 keyframes records ~650k,
  ~29 a keyframe); a saturated mission drops the OLDEST events and
  counts each dropped event once (`n_dropped`).
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

__all__ = ["Tracer", "tracer", "span"]


class _ThreadState(threading.local):
    depth = 0    # spans open on this thread
    on = False   # whether the outermost of them records


class _Off:
    """The span of a thread that records nothing: shared, no clock."""

    __slots__ = ("_state",)

    def __init__(self, state):
        self._state = state

    def __enter__(self):
        self._state.depth += 1
        return self

    def __exit__(self, *exc):
        self._state.depth -= 1
        return False


class _Span:
    """A span that reads the clock; recorded at exit if its thread
    records (decided at entry). `t_begin`, `t_end` and `seconds` are
    perf_counter readings; `args` may be added to before exit."""

    __slots__ = ("_tracer", "name", "args", "on", "t_begin", "t_end")

    def __init__(self, tr, name, args):
        self._tracer = tr
        self.name = name
        self.args = args

    def __enter__(self):
        st = self._tracer._state
        if not st.depth:
            st.on = self._tracer.enabled
        self.on = st.on
        st.depth += 1
        self.t_begin = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t_end = time.perf_counter()
        st = self._tracer._state
        st.depth -= 1
        if not st.depth:
            st.on = False
        if self.on:
            tr = self._tracer
            # Complete ("X") events: one record per span keeps the
            # ring twice as deep as B/E pairs would.
            tr._append({
                "name": self.name, "ph": "X", "pid": tr._pid,
                "tid": threading.get_ident(),
                "ts": (self.t_begin - tr._t0) * 1e6,
                "dur": (self.t_end - self.t_begin) * 1e6,
                "args": self.args,
            })
        return False

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_begin


class Tracer:
    """Process-wide span recorder; see module docstring."""

    def __init__(self, capacity: int = 1_000_000):
        self.enabled = False
        self._path = None
        self._events = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._pid_label = None
        self.n_dropped = 0
        self._t0 = time.perf_counter()
        self._state = _ThreadState()
        self._off = _Off(self._state)
        self._exit_hooked = False

    # -- control ------------------------------------------------------
    def enable(self, path, pid_label: str = None):
        """Start recording; `path` is written on dump()/process exit
        (None records in memory only, for `totals`).

        pid_label names this process's row in the viewer (e.g. "r3").
        """
        self._path = path
        self._pid_label = pid_label
        self.enabled = True
        if not self._exit_hooked:
            atexit.register(self._dump_at_exit)
            self._exit_hooked = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events.clear()
            self.n_dropped = 0

    # -- recording ----------------------------------------------------
    def _records(self) -> bool:
        st = self._state
        return st.on if st.depth else self.enabled

    def _append(self, event):
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.n_dropped += 1
            self._events.append(event)

    def span(self, name: str, **args):
        """Context manager timing a stage (a Complete event)."""
        if not self._records():
            return self._off
        return _Span(self, name, args)

    def timed(self, name: str, **args) -> _Span:
        """A span that reads the clock whether or not it is recorded,
        for a stage that keeps its own time too: `.seconds` after exit,
        the same readings as the recorded event's."""
        return _Span(self, name, args)

    def instant(self, name: str, **args):
        """Zero-duration marker (message arrivals, state transitions)."""
        if not self._records():
            return
        self._append({
            "name": name, "ph": "i", "s": "t", "pid": self._pid,
            "tid": threading.get_ident(),
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "args": args,
        })

    def counter(self, name: str, **values):
        """Chrome-trace counter track (queue depths, comm bytes, the
        iterations a stage took)."""
        if not self._records():
            return
        self._append({
            "name": name, "ph": "C", "pid": self._pid,
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "args": values,
        })

    def totals(self) -> dict:
        """{span name: {"count": n, "seconds": host seconds}} over the
        recorded spans (dropped ones are not counted)."""
        with self._lock:
            events = [e for e in self._events if e["ph"] == "X"]
        out = {}
        for e in events:
            t = out.setdefault(e["name"], {"count": 0, "seconds": 0.0})
            t["count"] += 1
            t["seconds"] += e["dur"] / 1e6
        return out

    def counter_totals(self) -> dict:
        """{counter name: {key: summed value}} over the recorded counter
        events (dropped ones are not counted)."""
        with self._lock:
            events = [e for e in self._events if e["ph"] == "C"]
        out = {}
        for e in events:
            t = out.setdefault(e["name"], {})
            for k, v in e["args"].items():
                t[k] = t.get(k, 0) + v
        return out

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
