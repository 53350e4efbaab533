"""The window: a recorded mission replayed through the port's swarm.

One `SwarmNode` per robot, each with its sensor handler, on one
`InProcessRouter` and `ManualClock`, built by the configuration's
front-end (`frontends/<front_end>.py`). The recording is fed in a closed
loop: at step s every robot's next keyframe (or frame) is fed as soon as
the swarm has taken the previous one, and mission time is s * dt, the
recording's rate. Before each step the node timers that fall due fire in
mission-time order (ties in `TIMER_ORDER`), with the configuration's
periods. The solve runs on the back-end's own worker thread, started by
`tick_optimization_start`; `tick_optimization_loop` picks its result up.

A keyframe is covered when the robot that took it adopts a shared
estimate containing it.

A pass replays the recording from its start on a fresh swarm. When a pass
ends inside the window the swarm finishes its map, on the window's
clock: for cells that report map latency, mission time runs on without
new keyframes until every keyframe of the pass is in an estimate its
robot holds; otherwise until the solve in flight has ended. Then the
next pass starts. Once `seconds` have gone by, the window closes at the
first pass end or, while no pass has ended inside it, at the first
detection-period boundary (before the next inter-robot detection round
would fire): a recording whose pass fits in the window is measured over
whole passes, the same work on every seed, and a longer one over whole
detection periods. Then the solve in flight is waited for. For map
latency the mission goes on (keyframes fed after the close are no
samples) until every keyframe fed in the window is covered, or the
drain's limits pass.

Every solve future is waited on with a timeout, every node and handler
is closed, also on failure, and recorders (`Records`) keep what the timed
path produced for the comparison with the plain reference.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path
from typing import Dict, List

from cslam_tpu_torch.comm.bus import InProcessBus
from cslam_tpu_torch.runtime.tracing import tracer

# a solve that takes longer is a stall: its future raises TimeoutError
SOLVE_TIMEOUT_S = 120.0
# order of timers due at the same mission time
TIMER_ORDER = ("heartbeat", "detection_publication", "inter_robot_detection",
               "optimization_start", "optimization_loop")
TICKS = {"heartbeat": "tick_heartbeat",
         "detection_publication": "tick_detection_publication",
         "inter_robot_detection": "tick_inter_robot_detection",
         "optimization_start": "tick_optimization_start",
         "optimization_loop": "tick_optimization_loop"}
SPIN_ROUNDS = 2000


def bench_dir(root) -> Path:
    return Path(root) / "swarmbench"


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the harness by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "swarmbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads, with its configuration,
    traffic and front-end found by name under `root`."""

    def __init__(self, root, workload: str):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        d = bench_dir(root)
        self.config = load_json(d / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(d / "workloads" /
                                 f"{self.entry['traffic']}.json")
        fe = self.config["front_end"]
        self.frontend = load_module(d / "frontends" / f"{fe}.py", fe)

    def metrics(self, kind: str) -> List[Dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, name: str):
        return load_module(bench_dir(self.root) / "metrics" / f"{name}.py",
                           name)


class Records:
    """What the timed path produced, kept for the comparison and the
    metrics. Lists of tuples and dicts; appends are atomic, so the
    solver thread may add to `solves`."""

    def __init__(self):
        self.feeds = {}          # (pass, robot, kf) -> feed wall time
        self.window_kfs = set()  # (pass, robot, kf) fed inside the window
        self.covered = {}        # (pass, robot, kf) -> first cover time
        self.searches = []       # (pass, owner, db robot, n, q_robot,
        #                           q_kf, item, sim)
        self.db_items = {}       # (pass, owner, db robot) -> items dict
        self.selections = []     # (pass, budget, pool keys, selected)
        self.solves = []         # dicts: pass, robot, fg, R0, t0, result
        self.adoptions = []      # (pass, robot, time, {key: pose}, solves)
        self.registrations = []  # dicts from the front-end
        self.frames = {}         # (pass, robot, kf) -> recording index
        self.passes = 0
        self.knn_ingest_ms = 0.0  # detectors' gossip ingestion, closed passes
        self.knn_ingest_window_ms = 0.0  # ... up to the window's close
        self.search_window = (0, 0)  # searches[lo:hi] ran in the window


def edge_tuple(e):
    """Endpoints of an inter-robot edge, in a canonical order."""
    a = (int(e.robot0_id), int(e.robot0_keyframe_id))
    b = (int(e.robot1_id), int(e.robot1_keyframe_id))
    return (a, b) if a <= b else (b, a)


class Pass:
    """One replay of the recording on a fresh swarm."""

    def __init__(self, run, index: int):
        self.run = run
        self.index = index
        self.swarm = run.cell.frontend.build_swarm(
            run.cell.config, run.cell.traffic, run.rec, run.device)
        try:
            self.step = 0
            periods = run.cell.config["periods_s"]
            self.periods = {k: float(periods[k]) for k in TIMER_ORDER}
            self.due = dict(self.periods)
            self._instrument()
        except BaseException:
            self.close()
            raise

    # -- instrumentation -------------------------------------------------
    def _instrument(self):
        rec, p = self.run.records, self.index
        for rid, node in self.swarm.nodes.items():
            lcm = node.detection.lcm
            self._wrap_matcher(lcm, rid)
            self._wrap_select(lcm)
            self._wrap_solver(node.backend, rid)
            bus = InProcessBus(self.swarm.router, rid)
            bus.subscribe("cslam/optimized_estimates",
                          self._on_estimates(rid))
        hook = getattr(self.run.cell.frontend, "instrument", None)
        if hook is not None:
            hook(self.swarm, rec, p)

    def _wrap_matcher(self, lcm, me):
        rec, p = self.run.records, self.index
        query = [None]
        add_local = lcm.add_local_global_descriptor
        add_other = lcm.add_other_robot_global_descriptor

        def local(embedding, keyframe_id):
            query[0] = (me, int(keyframe_id))
            with tracer.span("bench.knn_local", robot=me):
                return add_local(embedding, keyframe_id)

        def other(msg):
            query[0] = (int(msg.robot_id), int(msg.keyframe_id))
            return add_other(msg)

        lcm.add_local_global_descriptor = local
        lcm.add_other_robot_global_descriptor = other
        dbs = dict(lcm.other_robots_nnsm)
        dbs[me] = lcm.local_nnsm
        for dbr, db in dbs.items():
            rec.db_items[p, me, dbr] = db.items
            search_best = db.search_best

            def searched(q, _db=db, _dbr=dbr, _search=search_best):
                n = len(_db)
                item, sim = _search(q)
                if item is not None:
                    rec.searches.append((p, me, _dbr, n, query[0][0],
                                         query[0][1], int(item), float(sim)))
                return item, sim
            db.search_best = searched

    def _wrap_select(self, lcm):
        rec, p = self.run.records, self.index
        select = lcm.select_candidates

        def selected(number, in_range, greedy=True):
            pool = [edge_tuple(e) for e in
                    lcm.candidate_selector.candidate_edges.values()]
            out = select(number, in_range, greedy)
            rec.selections.append((p, int(number), pool,
                                   [edge_tuple(e) for e in out]))
            return out
        lcm.select_candidates = selected

    def _wrap_solver(self, backend, rid):
        rec, p = self.run.records, self.index
        solver = backend.solver

        def solve(fg, cfg):
            R0, t0 = list(fg.R), list(fg.t)
            result = solver(fg, cfg)
            rec.solves.append({"pass": p, "robot": rid, "fg": fg, "R0": R0,
                               "t0": t0, "result": result})
            return result
        backend.solver = solve

    def _on_estimates(self, rid):
        rec, p = self.run.records, self.index

        def adopted(msg):
            now = time.perf_counter()
            poses = {(v.robot_id, v.keyframe_id): v.pose
                     for v in msg.estimates}
            rec.adoptions.append((p, rid, now, poses, len(rec.solves)))
            for (r, k) in poses:
                key = (p, r, k)
                if r == rid and key in rec.feeds and key not in rec.covered:
                    rec.covered[key] = now
        return adopted

    # -- mission time ------------------------------------------------------
    def fire_until(self, t: float):
        """Fire every timer due at or before mission time t, in order."""
        sw = self.swarm
        while True:
            name = min(TIMER_ORDER,
                       key=lambda k: (self.due[k], TIMER_ORDER.index(k)))
            due = self.due[name]
            if due > t:
                break
            sw.clock.advance(due - sw.clock.now())
            for node in sw.nodes.values():
                getattr(node, TICKS[name])()
            # the messages a tick sent are handled here, outside its span
            with tracer.span("bench.deliver." + name):
                sw.router.spin_until_idle(max_rounds=SPIN_ROUNDS)
            self.due[name] = due + self.periods[name]
        if t > sw.clock.now():
            sw.clock.advance(t - sw.clock.now())

    def round_due(self) -> bool:
        """Whether the next step would fire an inter-robot detection
        round (a detection period ends here)."""
        return self.due["inter_robot_detection"] <= self.step * \
            self.run.rec.dt

    @property
    def done(self) -> bool:
        return self.step >= self.run.rec.n_steps

    def feed_next(self, in_window: bool):
        """Fire due timers, then feed step `step` to every robot."""
        run = self.run
        self.fire_until(self.step * run.rec.dt)
        with tracer.span("bench.feed", step=self.step):
            taken = self.swarm.feed(self.step)
        now = time.perf_counter()
        for rid, kf, frame in taken:
            key = (self.index, rid, kf)
            run.records.feeds[key] = now
            run.records.frames[key] = frame
            if in_window:
                run.records.window_kfs.add(key)
        self.step += 1
        return len(taken)

    def idle_step(self):
        """One recording period of mission time with nothing fed; blocks
        on a solve in flight instead of spinning through mission time."""
        self.wait_solves()
        self.step += 1
        self.fire_until(self.step * self.run.rec.dt)

    def solving(self):
        return [n.backend._optimization_future
                for n in self.swarm.nodes.values()
                if n.backend._optimization_future is not None]

    def wait_solves(self):
        for fut in self.solving():
            fut.result(timeout=SOLVE_TIMEOUT_S)

    def finish_solves(self):
        """Wait for the solves in flight and let loop ticks at the current
        mission time pick them up; no new solve starts."""
        futures = self.solving()
        for fut in futures:
            fut.result(timeout=SOLVE_TIMEOUT_S)
        for _ in range(10):
            if not any(f in futures for f in self.solving()):
                return
            for node in self.swarm.nodes.values():
                node.tick_optimization_loop()
            self.swarm.router.spin_until_idle(max_rounds=SPIN_ROUNDS)
        raise RuntimeError("a finished solve was never picked up")

    def knn_ingest_ms(self) -> float:
        return sum(n.detection.tick_phase_ms["knn_ingest"]
                   for n in self.swarm.nodes.values())

    def close(self):
        sw = getattr(self, "swarm", None)
        if sw is not None:
            if sw.nodes and self.index >= 0:
                self.run.records.knn_ingest_ms += self.knn_ingest_ms()
            sw.close()
            self.swarm = None


class Run:
    """One cell run: the recording, the warm-up and the window."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.rec = cell.frontend.make_recording(cell.config, cell.traffic,
                                                seed)
        self.records = Records()
        self.latency = bool(cell.traffic.get("map_latency", False))
        self.warm_times = {}

    def pending(self, keys):
        rec = self.records
        return [k for k in keys if k not in rec.covered]

    def warm_up(self):
        """The first `warmup_steps` of the recording on a throwaway swarm,
        then its solve in flight; nothing it records is kept."""
        steps = int(self.cell.traffic["warmup_steps"])
        keep, self.records = self.records, Records()
        t = [time.perf_counter()]
        marks = self.warm_times = {}

        def mark(name):
            t.append(time.perf_counter())
            marks[name] = t[-1] - t[-2]
        p = Pass(self, -1)
        try:
            mark("swarm_s")
            while p.step < min(steps, self.rec.n_steps):
                p.feed_next(False)
            mark("steps_s")
            p.finish_solves()
            mark("solve_s")
            hook = getattr(self.cell.frontend, "warm_up", None)
            if hook is not None:
                hook(p.swarm, self.rec, self.device)
            mark("hook_s")
        finally:
            p.close()
            self.records = keep

    def drain(self, p: Pass, keys, deadline: float, feed: bool):
        """Mission time runs on until every key is covered, the wall
        deadline passes, or the recording has ended `drain_mission_s` of
        mission time ago; with `feed`, the recording goes on being fed."""
        end = (self.rec.n_steps + float(self.cell.traffic["drain_mission_s"])
               / self.rec.dt)
        while self.pending(keys) and time.perf_counter() < deadline \
                and p.step < end:
            if feed and not p.done:
                p.feed_next(False)
            else:
                p.idle_step()

    def window(self, seconds: float):
        """Feed passes until `seconds` have gone by; returns (open, close)
        wall times. Leaves the last pass open for the latency drain."""
        t_open = time.perf_counter()
        deadline = t_open + seconds
        self.last = None
        recs = self.records
        lo = len(recs.searches)
        ended = False  # a pass has ended inside the window

        def closed():
            recs.search_window = (lo, len(recs.searches))
            recs.knn_ingest_window_ms = recs.knn_ingest_ms + (
                self.last.knn_ingest_ms() if self.last else 0.0)
            return t_open, time.perf_counter()

        while True:
            p = Pass(self, recs.passes)
            recs.passes += 1
            self.last = p
            while not p.done:
                if not ended and p.round_due() and \
                        time.perf_counter() >= deadline:
                    return closed()
                p.feed_next(True)
            try:
                if self.latency:
                    keys = [k for k in recs.window_kfs if k[0] == p.index]
                    self.drain(p, keys, time.perf_counter() +
                               float(self.cell.traffic["drain_timeout_s"]),
                               feed=False)
                p.finish_solves()
            finally:
                p.close()
                self.last = None
            ended = True
            if time.perf_counter() >= deadline:
                return closed()

    def latency_drain(self):
        """After the close: wait for the solve in flight and, for map
        latency, run the open pass on until every keyframe fed in the
        window is covered; then close the pass."""
        p = self.last
        if p is None:
            return
        try:
            if self.latency:
                keys = [k for k in self.records.window_kfs
                        if k[0] == p.index]
                self.drain(p, keys, time.perf_counter() +
                           float(self.cell.traffic["drain_timeout_s"]),
                           feed=True)
            p.finish_solves()
        finally:
            p.close()
            self.last = None

    def close(self):
        if getattr(self, "last", None) is not None:
            self.last.close()
            self.last = None


def leftover_threads():
    """Non-daemon threads other than the main one."""
    return [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon
            and t.is_alive()]
