"""Run one cell of the port's benchmark once.

    python3 -m swarmbench.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names its configuration and traffic, found by name under `swarmbench/`.
Set-up makes the recording from the seed, loads (or, in a fresh
checkout, builds) the port's kernel and native libraries, and warms the
swarm up on the recording's first steps; then the window replays the
recording through the port's swarm (`harness.py`) for `--seconds`. Once
the window has closed, what the timed path produced is compared with
the plain reference (`compare.py`). The last line of standard output is
one JSON object: correct, attempted (keyframes fed in the window),
failed (those whose estimate never came), the metrics (`--trace 0`: the
cell's end-to-end metrics; `--trace 1`: its per-layer metrics, from a
device trace and host spans), the device, and last the numbers compared
with their limits, which also end standard error.

`--control 1` (never used by the benchmark's own runs) also judges the
reference's TF32 control in the program's place, for setting limits.
Needs a CUDA card; `run_cell(..., device="cpu")` runs a cell on the CPU
for the tests.
"""

import os
import sys
import time

T_IMPORT = time.perf_counter()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, "swarmbench", "_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(_CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "cslam_tpu")
# watchdog: set-up (a fresh checkout builds), then the window and after
SETUP_WATCHDOG_S = 1150
AFTER_OPEN_WATCHDOG_S = 330
# device operations are named in the breakdown by this many characters
NAME_CHARS = 160


def process_age_s():
    """Seconds since this process started (/proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What the metric readers read (`metrics/<name>.py`: read(ctx))."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _warm_libraries(device):
    """Solver libraries the window uses: cuBLAS, cuSOLVER (eigh,
    Cholesky), so their handles exist before the window."""
    a = torch.eye(8, device=device) * 2.0
    torch.linalg.eigh(a)
    torch.linalg.cholesky(a)
    (a @ a).sum().item()


def run_cell(root, workload, seed, seconds, trace=False, device="cuda",
             control=False):
    """One run of a cell; returns (result dict, check rows, extra)."""
    from cslam_tpu_torch.device import resolve_device
    from cslam_tpu_torch.runtime.tracing import tracer
    from swarmbench.harness import Cell, Run, leftover_threads
    from swarmbench.profiling import DeviceTrace, host_spans

    dev = resolve_device(device)
    setup = {"imported_s": process_age_s()}
    cell = Cell(root, workload)
    run = Run(cell, seed, dev)
    setup["recording_s"] = process_age_s() - setup["imported_s"]
    try:
        if dev.type == "cuda":
            _warm_libraries(dev)
        setup["libraries_s"] = process_age_s() - sum(setup.values())
        run.warm_up()
        setup["warm_up_s"] = process_age_s() - sum(setup.values())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        # set-up's objects stay out of the window's garbage collections
        gc.collect()
        gc.freeze()
        setup_s = process_age_s()
        faulthandler.dump_traceback_later(AFTER_OPEN_WATCHDOG_S, exit=True)
        prof = None
        if trace:
            tracer.clear()
            tracer.enable(None)
            prof = DeviceTrace(dev)
            prof.start()
        t_open, t_close = run.window(float(seconds))
        if prof is not None:
            prof.stop()
            tracer.disable()
        run.latency_drain()
    finally:
        run.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    recs = run.records
    window_kfs = sorted(recs.window_kfs)
    failed = [k for k in window_kfs if k not in recs.covered] \
        if run.latency else []
    latencies = [recs.covered[k] - recs.feeds[k] for k in window_kfs
                 if k in recs.covered] if run.latency else []
    profile = spans = None
    t_reduce = time.perf_counter()
    if prof is not None:
        events = host_spans(tracer)
        import threading
        profile = prof.reduce(events, threading.main_thread().ident)
        spans = tracer.totals()
    ctx = Context(cell=cell, run=run, records=recs, seconds=float(seconds),
                  window_s=t_close - t_open, t_open=t_open, t_close=t_close,
                  keyframes=len(window_kfs), latencies=latencies,
                  failed=len(failed), setup_s=setup_s, spans=spans,
                  profile=profile, device=dev)
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell.metrics(kind):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    from swarmbench import compare
    values = compare.numbers(run)
    limits = cell.config.get("limits", {})
    correct, rows = compare.judge(values, limits)
    extra = {"setup": setup, "warm_up": run.warm_times,
             "passes": recs.passes, "window_s": t_close - t_open,
             "keyframes": len(window_kfs), "solves": len(recs.solves),
             "selections": len(recs.selections),
             "searches": len(recs.searches),
             "registrations": len(recs.registrations),
             "latency_samples": len(latencies),
             "check_s": time.perf_counter() - t_check,
             "reduce_s": t_check - t_reduce,
             "device_events": profile["events"] if profile else None}
    if control:
        extra["control"] = compare.numbers(run, control=True)
    left = leftover_threads()
    if left:
        raise RuntimeError(f"threads left running: {left}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(window_kfs),
              "failed": len(failed), "metrics": metrics,
              "device": device_info}
    if profile is not None:
        device_info["busy_s"] = profile["busy_s"]
        device_info["window_s"] = profile["window_s"]
        top = sorted(profile["ops"].items(), key=lambda x: -x[1])[:10]
        idle = sorted(profile["idle"].items(), key=lambda x: -x[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:NAME_CHARS], s]
                                              for n, s in top],
                               "idle_gaps": [[n, s] for n, s in idle]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return result, rows, extra


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(SETUP_WATCHDOG_S, exit=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("swarmbench: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, rows, extra = run_cell(_ROOT, args.workload, args.seed,
                                   args.seconds, trace=bool(args.trace),
                                   control=bool(args.control))
    faulthandler.cancel_dump_traceback_later()
    found = forbidden_modules()
    if found:
        print(f"swarmbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps({"extra": extra}), file=sys.stderr)
    print(json.dumps(result))
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
