"""The port's span tracer (cslam_tpu_torch/runtime/tracing.py) and the
spans and counters inside the port that the benchmark reads: the
disabled path, counter totals, exact drop counts, the rule that a
thread's outermost span decides for everything inside it, and, on the
CPU, the matching (`knn_add`, `knn_search`, `match_local`,
`gossip_ingest`), selection (`mac_prepare`, `mac_fw`, counter `mac`) and
back-end (`pgo_arrays`, counter `pgo`) instrumentation."""

import atexit
import sys
import threading

import numpy as np
import pytest
import torch

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.factor_graph import (BetweenFactor, FactorGraph,
                                                  diag_sqrt_info)
from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.frontend.loop_closure_detection import \
    GlobalDescriptorLoopClosureDetection
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.ops import se3
from cslam_tpu_torch.runtime.tracing import Tracer, tracer
from cslam_tpu_torch.sparsification import mac as tmac
from cslam_tpu_torch.sparsification.acm import \
    AlgebraicConnectivityMaximization
from cslam_tpu_torch.utils.edges import Edge, EdgeInterRobot

torch.set_num_threads(1)


@pytest.fixture
def traced():
    """The process-wide tracer, on and empty; off and empty after."""
    tracer.clear()
    tracer.enable(None)
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.clear()


def _spans(tr, name):
    return [e for e in tr._events if e["ph"] == "X" and e["name"] == name]


# ----------------------------------------------------------------------
# The tracer
# ----------------------------------------------------------------------
def test_disabled_span_is_one_shared_object_and_records_nothing():
    tr = Tracer()
    a = tr.span("a", robot=1)
    assert tr.span("b") is a
    with tr.span("outer"):
        assert tr.span("inner") is a
        with tr.span("inner"):
            tr.instant("i")
            tr.counter("c", v=1)
    assert len(tr._events) == 0 and tr.n_dropped == 0
    assert tr.totals() == {} and tr.counter_totals() == {}


def test_counter_totals_sum_per_key():
    tr = Tracer()
    tr.enable(None)
    tr.counter("c", a=1, b=2)
    with tr.span("s"):
        tr.counter("c", a=3)
    tr.counter("d", x=1.5)
    tr.counter("d", x=0.25)
    assert tr.counter_totals() == {"c": {"a": 4, "b": 2}, "d": {"x": 1.75}}
    assert tr.totals()["s"]["count"] == 1


def test_drops_are_counted_once_per_event():
    tr = Tracer(capacity=4)
    tr.enable(None)
    for i in range(3):
        with tr.span("s"):
            pass
        tr.instant("i")
        tr.counter("c", v=i)
    assert len(tr._events) == 4
    assert tr.n_dropped == 9 - 4
    tr.clear()
    assert tr.n_dropped == 0 and len(tr._events) == 0


def test_drops_are_counted_exactly_under_threads():
    """More threads than cores, a short switch interval: every event is
    either in the ring or counted as dropped."""
    tr = Tracer(capacity=64)
    tr.enable(None)
    n_threads, per_thread = 16, 300
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=30)
        for i in range(per_thread):
            with tr.span("s"):
                tr.counter("c", v=1)
            tr.instant("i")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(tr._events) == 64
    assert len(tr._events) + tr.n_dropped == 3 * n_threads * per_thread


def test_enable_registers_its_exit_hook_once(monkeypatch):
    hooks = []
    monkeypatch.setattr(atexit, "register", hooks.append)
    tr = Tracer()
    for _ in range(3):
        tr.enable(None)
        tr.disable()
    assert len(hooks) == 1


@pytest.mark.parametrize("on_at_entry", [False, True])
def test_outermost_span_decides_for_what_it_holds(on_at_entry):
    """Spans and counters inside an outermost span are recorded iff it
    is, whatever enable/disable do meanwhile; outside any span the
    tracer's state decides. Each thread decides for itself."""
    tr = Tracer()
    if on_at_entry:
        tr.enable(None)
    with tr.span("outer"):
        if on_at_entry:
            tr.disable()
        else:
            tr.enable(None)
        with tr.span("inner"):
            tr.counter("c", v=1)
        tr.instant("i")
        other = []

        def elsewhere():
            with tr.span("other"):
                tr.counter("o", v=1)
            other.append(True)
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(timeout=30)
        assert other
    names = [e["name"] for e in tr._events]
    if on_at_entry:
        # the other thread opened its span with the tracer off
        assert names == ["c", "inner", "i", "outer"]
        assert tr.counter_totals() == {"c": {"v": 1}}
    else:
        # the other thread opened its span with the tracer on
        assert names == ["o", "other"]
        assert tr.counter_totals() == {"o": {"v": 1}}
    # a span that opens now sees the current state
    tr.counter("after", v=1)
    assert ("after" in tr.counter_totals()) == (not on_at_entry)


def test_timed_span_reads_the_clock_when_not_recorded():
    tr = Tracer()
    with tr.timed("t", n=0) as t:
        t.args["n"] = 3
    assert t.seconds >= 0.0 and len(tr._events) == 0
    tr.enable(None)
    with tr.timed("t", n=0) as t:
        t.args["n"] = 3
    (e,) = tr._events
    assert e["args"] == {"n": 3}
    assert e["dur"] == pytest.approx(t.seconds * 1e6, rel=1e-12)


# ----------------------------------------------------------------------
# Matching
# ----------------------------------------------------------------------
def _unit_rows(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_descriptor_database_spans(traced):
    rng = np.random.default_rng(0)
    db = DescriptorDatabase(capacity=4, device="cpu")
    assert db.search_best(_unit_rows(rng, 1, 16)[0]) == (None, None)
    rows = _unit_rows(rng, 9, 16)   # grows the capacity twice
    for i, r in enumerate(rows):
        db.add_item(r, i)
    db.search_best(rows[3])
    db.search(rows[4], 3)
    db.batch_search(rows[:5], 2)
    adds, searches = _spans(traced, "knn_add"), _spans(traced, "knn_search")
    assert [e["args"]["rows"] for e in adds] == list(range(9))
    # the search of the empty database is no search
    assert [e["args"] for e in searches] == [
        {"rows": 9, "batch": 1, "k": 1}, {"rows": 9, "batch": 1, "k": 3},
        {"rows": 9, "batch": 5, "k": 2}]
    # on the CPU every search takes torch ops; both growths and the first
    # search upload the staged rows
    assert traced.counter_totals()["knn"] == {
        "fallback_searches": 3, "flushes": 3, "flushed_rows": 9}


def test_descriptor_database_counters(traced):
    """Adds staged between CPU searches: every search is a fallback, and
    there is one upload per search that follows adds, of those adds."""
    rng = np.random.default_rng(1)
    db = DescriptorDatabase(capacity=64, device="cpu")
    plan = [3, 0, 1, 5, 0, 0, 2]  # adds before each search
    for adds in plan:
        for r in _unit_rows(rng, adds, 16):
            db.add_item(r, db.n)
        db.search_best(_unit_rows(rng, 1, 16)[0])
    assert len(_spans(traced, "knn_add")) == sum(plan)
    assert len(_spans(traced, "knn_search")) == len(plan)
    assert traced.counter_totals()["knn"] == {
        "fallback_searches": len(plan),
        "flushes": sum(a > 0 for a in plan), "flushed_rows": sum(plan)}


def _gossip_params(robot_id):
    return {
        "robot_id": robot_id,
        "max_nb_robots": 2,
        "frontend.similarity_threshold": 0.8,
        "frontend.global_descriptor_technique": "cosplace",
        "frontend.nb_best_matches": 5,
        "frontend.intra_loop_min_inbetween_keyframes": 2,
        "frontend.enable_intra_robot_loop_closures": False,
        "frontend.detection_publication_max_elems_per_msg": 10,
        "frontend.gossip_descriptor_quantization": "none",
        "frontend.enable_sparsification": True,
        "frontend.inter_robot_loop_closure_budget": 5,
        "frontend.use_vertex_cover_selection": True,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
    }


class _NoModel:
    """Descriptors are added directly: no model is needed."""


def test_gossip_ingestion_span_and_phase_time(traced):
    rng = np.random.default_rng(7)
    router, clock = InProcessRouter(), ManualClock()
    dets = [GlobalDescriptorLoopClosureDetection(
        _gossip_params(r), InProcessBus(router, r), clock,
        descriptor_model=_NoModel(), device="cpu") for r in (0, 1)]
    for r in (0, 1):
        for kf, d in enumerate(_unit_rows(rng, 3, 64)):
            dets[r].add_global_descriptor_to_map(d, kf)
    assert len(_spans(traced, "match_local")) == 6
    sent = []
    dets[1].global_descriptor_publisher.publish = sent.append
    dets[1].global_descriptors_timer_callback()
    traced.clear()
    dets[0].global_descriptor_callback(sent[0])
    # already known: ingests nothing, still a span
    dets[0].global_descriptor_callback(sent[0])
    ingest = _spans(traced, "gossip_ingest")
    assert [e["args"] for e in ingest] == [{"sender": 1, "n": 3},
                                          {"sender": 1, "n": 0}]
    assert len(_spans(traced, "knn_add")) == 3
    assert len(_spans(traced, "knn_search")) == 3
    assert dets[0].tick_phase_ms["knn_ingest"] == pytest.approx(
        sum(e["dur"] for e in ingest) / 1e3, rel=1e-9)


# ----------------------------------------------------------------------
# Selection
# ----------------------------------------------------------------------
def _chain_with_candidates(rng, n_poses, n_cand):
    fixed = [Edge(i, i + 1, 1.0) for i in range(n_poses - 1)]
    cand, seen = [], set()
    while len(cand) < n_cand:
        i, j = sorted(rng.integers(0, n_poses, 2).tolist())
        if j - i < 2 or (i, j) in seen:
            continue
        seen.add((i, j))
        cand.append(Edge(i, j, float(rng.random()) + 0.1))
    return fixed, cand


@pytest.mark.parametrize("max_iters", [1, 4, 20])
def test_mac_fw_span_and_iterations(traced, monkeypatch, max_iters):
    """On the exact path each Frank-Wolfe iteration makes one eigh: the
    counter equals the number of eigh calls."""
    rng = np.random.default_rng(3)
    fixed, cand = _chain_with_candidates(rng, 60, 24)
    mac = tmac.MAC(fixed, cand, 60, device="cpu")
    mac.fiedler_method = "eigh"
    w0 = np.zeros(len(cand), np.float32)
    w0[np.argsort([e.weight for e in cand])[-5:]] = 1.0
    eighs = []
    real = torch.linalg.eigh

    def counted(a, *args, **kw):
        eighs.append(1)
        return real(a, *args, **kw)
    monkeypatch.setattr(torch.linalg, "eigh", counted)
    mac.fw_subset(w0, 5, max_iters=max_iters)
    assert 1 <= len(eighs) <= max_iters
    assert traced.counter_totals() == {"mac": {"fw_iters": len(eighs)}}
    (span,) = _spans(traced, "mac_fw")
    assert span["args"] == {"m": 24, "k": 5, "nodes": 60}


def test_selection_round_spans_and_counters(traced):
    """A broker's selection with MAC: one `mac_prepare` and one `mac_fw`
    span, and the solve's iterations counted."""
    fixed = [EdgeInterRobot(r, k, r, k + 1, 1.0)
             for r in range(2) for k in range(19)]
    fixed.append(EdgeInterRobot(0, 0, 1, 0, 1.0))
    rng = np.random.default_rng(5)
    cand = [EdgeInterRobot(0, int(i), 1, int(j), float(rng.random()))
            for i, j in zip(rng.integers(0, 20, 12), rng.integers(0, 20, 12))]
    acm = AlgebraicConnectivityMaximization(robot_id=0, max_nb_robots=2,
                                            device="cpu")
    acm.set_graph(fixed, cand)
    selected = acm.select_candidates(4, {0: True, 1: True}, True)
    assert len(selected) == 4
    assert len(_spans(traced, "mac_prepare")) == 1
    assert len(_spans(traced, "mac_fw")) == 1
    totals = traced.counter_totals()["mac"]
    assert set(totals) == {"fw_iters"} and totals["fw_iters"] >= 1


# ----------------------------------------------------------------------
# Back-end
# ----------------------------------------------------------------------
def _graph(seed, n=24, loops=((0, 12), (4, 20), (2, 18))):
    """A noisy chain with loop closures and perturbed initial poses."""
    rng = np.random.default_rng(seed)
    xi = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    xi[:, :3] *= 0.3
    Rs, ts = se3.se3_exp(xi)
    Rs, ts = Rs.numpy(), ts.numpy()

    def rel(i, j):
        return Rs[i].T @ Rs[j], Rs[i].T @ (ts[j] - ts[i])
    fg = FactorGraph()
    sq = diag_sqrt_info([0.01] * 3 + [0.05] * 3)
    for k in range(n - 1):
        fg.add_between(BetweenFactor((0, k), (0, k + 1), *rel(k, k + 1), sq))
    for i, j in loops:
        fg.add_between(BetweenFactor((0, i), (0, j), *rel(i, j), sq,
                                     is_loop=True))
    fg.set_prior((0, 0), Rs[0], ts[0], weight=1e3)
    noise = torch.from_numpy(
        rng.standard_normal((n, 6)).astype(np.float32) * 0.05)
    dR, dt = se3.se3_exp(noise)
    for k in range(n):
        R, t = (Rs[k], ts[k]) if k == 0 else (Rs[k] @ dR[k].numpy(),
                                               ts[k] + dt[k].numpy())
        fg.add_node((0, k), R, t)
    return fg


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pgo_counters_equal_the_solvers_stats(solver):
    cfg = pgo.PGOConfig(linear_solver=solver)
    tracer.clear()
    off = pgo.optimize(_graph(11), cfg, device="cpu")
    assert tracer.counter_totals() == {}
    stats = pgo.gnc_optimize_core(_graph(11).to_arrays(device="cpu"), cfg,
                                  count_iters=True)[1]
    tracer.enable(None)
    try:
        on = pgo.optimize(_graph(11), cfg, device="cpu")
        totals = tracer.counter_totals()["pgo"]
        arrays = _spans(tracer, "pgo_arrays")
    finally:
        tracer.disable()
        tracer.clear()
    phases = ("init", "gnc", "polish")
    assert totals == {
        "lm_steps": sum(stats["lm_" + p] for p in phases),
        "cg_iters": sum(stats["cg_" + p] for p in phases),
        "gnc_rounds": stats["gnc_rounds"], "pcg": int(solver == "pcg")}
    assert totals["lm_steps"] > 0
    assert (totals["cg_iters"] > 0) == (solver == "pcg")
    assert len(arrays) == 1 and arrays[0]["args"]["n_factors"] == 26
    assert torch.equal(on.R, off.R) and torch.equal(on.t, off.t)
    assert torch.equal(on.weights, off.weights)
    assert on.gnc_iters == off.gnc_iters
