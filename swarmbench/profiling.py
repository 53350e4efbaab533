"""The device trace of a traced window, reduced to what the metrics read.

`torch.profiler` records the device's activity (kernels, copies, sets)
over the window. A marker (`torch.cuda._sleep`) launched right after a
host clock reading ties the trace's clock to the host's, so an idle gap
on the device can be named by the host span open at the time (the
program's and the harness's spans, `runtime/tracing.py`).
"""

import json
import os
import re
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

MARKER_CYCLES = 200_000
MARKER_NAME = "spin_kernel"
# kernels of the port's cosine top-k search (csrc/cosine_topk.cu), as the
# trace names them: "(anonymous namespace)::topk_f32_gemv(...)"
TOPK_KERNEL = re.compile(r"(?:^|::|\s)topk_\w+[<(]")


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda else \
            [torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(MARKER_CYCLES)
        else:
            self.t_mark = time.perf_counter()
        self.t_open = time.perf_counter()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.t_close = time.perf_counter()
        self.prof.stop()

    def _events(self):
        """(names, starts_s, durations_s) of the device events, starts on
        the host's perf_counter clock."""
        want = "CUDA" if self.cuda else "CPU"
        names, starts, durs = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if want not in str(e.device_type()):
                continue
            names.append(e.name())
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
        starts = np.asarray(starts, dtype=np.float64) * 1e-9
        durs = np.asarray(durs, dtype=np.float64) * 1e-9
        mark = [i for i, n in enumerate(names) if MARKER_NAME in n]
        if self.cuda and mark:
            offset = self.t_mark - starts[mark[0]]
        elif len(starts):
            offset = self.t_open - starts.min()
        else:
            offset = 0.0
        return names, starts + offset, durs

    def reduce(self, span_events, main_tid):
        """{busy_s, window_s, ops: {name: s}, idle: {host span: s},
        kernels: {name: (count, s)}} over the window."""
        names, starts, durs = self._events()
        window = self.t_close - self.t_open
        ops = defaultdict(float)
        kernels = defaultdict(lambda: [0, 0.0])
        for n, d in zip(names, durs):
            if MARKER_NAME in n:
                continue
            ops[n] += d
            kernels[n][0] += 1
            kernels[n][1] += d
        keep = np.array([MARKER_NAME not in n for n in names], dtype=bool)
        s, d = starts[keep], durs[keep]
        order = np.argsort(s)
        s, e = s[order], s[order] + d[order]
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        edge = self.t_open
        for a, b in zip(s, e):
            a, b = max(a, self.t_open), min(b, self.t_close)
            if b <= a:
                continue
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((edge, a))
                elif a > edge:
                    gaps.append((edge, a))
                cur_s, cur_e = a, b
                edge = b
            else:
                cur_e = max(cur_e, b)
                edge = cur_e
        if cur_e is not None:
            busy += cur_e - cur_s
            edge = cur_e
        if self.t_close > edge:
            gaps.append((edge, self.t_close))
        idle = defaultdict(float)
        mids = [(a + b) / 2 for a, b in gaps]
        for (a, b), name in zip(gaps, name_times(mids, span_events,
                                                  main_tid)):
            idle[name] += b - a
        return {"busy_s": busy, "window_s": window, "ops": dict(ops),
                "events": len(names),
                "idle": dict(idle),
                "kernels": {k: tuple(v) for k, v in kernels.items()}}


def name_times(times, events, main_tid):
    """For each host time, the innermost span open then on the main
    thread, else the latest opened on another thread, else "host": one
    sweep over span openings, closings and the queries in time order."""
    marks = []
    for i, e in enumerate(events):
        marks.append((e["t0"], 0, i))
        marks.append((e["t1"], 2, i))
    for q, t in enumerate(times):
        marks.append((t, 1, q))
    marks.sort()
    stacks = {}
    out = ["host"] * len(times)
    for _, kind, i in marks:
        if kind == 0:
            stacks.setdefault(events[i]["tid"], []).append(i)
        elif kind == 2:
            st = stacks[events[i]["tid"]]
            st.remove(i)
        else:
            main = stacks.get(main_tid)
            if main:
                out[i] = events[main[-1]]["name"]
            else:
                tops = [st[-1] for st in stacks.values() if st]
                if tops:
                    out[i] = events[max(tops, key=lambda j: events[j]["t0"])
                                    ]["name"]
    return out


def host_spans(tracer):
    """The tracer's complete spans as dicts with host perf_counter times
    (dumped to a file under TMPDIR and read back; an instant marker ties
    the dump's clock to perf_counter)."""
    was = tracer.enabled
    tracer.enabled = True
    t_mark = time.perf_counter()
    tracer.instant("bench.clock")
    tracer.enabled = was
    fd, path = tempfile.mkstemp(suffix=".json", prefix="swarmbench_spans_")
    os.close(fd)
    try:
        tracer.dump(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    marks = [e for e in doc["traceEvents"] if e.get("name") == "bench.clock"]
    t_base = t_mark - marks[-1]["ts"] * 1e-6 if marks else 0.0
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        t0 = t_base + e["ts"] * 1e-6
        out.append({"name": e["name"], "tid": e["tid"], "t0": t0,
                    "t1": t0 + e["dur"] * 1e-6})
    return out
