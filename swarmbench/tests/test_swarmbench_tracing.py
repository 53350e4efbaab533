"""The per-layer metrics read from the program's own spans and counters
(matching, selection, back-end) in a tiny traced run on the CPU, and
their readers where the program records none."""

import pytest

from cslam_tpu_torch.runtime.tracing import Tracer, tracer
from swarmbench.harness import Cell
from swarmbench.run import Context, run_cell

PROGRAM_METRICS = ["knn_searches_per_kf", "knn_search_us", "knn_add_us",
                   "mac_fw_ms", "mac_fw_iters", "lm_steps_per_solve",
                   "cg_iters_per_solve"]


def test_traced_run_reports_the_program_metrics(root):
    result, _, extra = run_cell(root, "sim5r.revisit", 2**31 + 5, 10.0,
                                trace=True, device="cpu")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(PROGRAM_METRICS) <= set(m)
    for name in PROGRAM_METRICS:
        assert m[name] > 0, name
    # own keyframe: one search per other robot; gossip: one per receiver
    assert m["knn_searches_per_kf"] <= 2 * 4
    assert m["mac_fw_ms"] <= m["mac_select_ms"]
    assert m["mac_fw_iters"] >= 1 and m["lm_steps_per_solve"] >= 1
    assert tracer.n_dropped == 0
    assert result["correct"] and extra["solves"] > 0


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_readers_return_nothing_without_records(root, monkeypatch, name):
    """Untraced (no spans), traced with nothing recorded, and a program
    whose tracer keeps no counter totals: no value, no error."""
    reader = Cell(root, "sim5r.revisit").reader(name)
    assert reader.read(Context(spans=None, keyframes=10)) is None
    assert reader.read(Context(spans={}, keyframes=10)) is None
    monkeypatch.delattr(Tracer, "counter_totals")
    spans = {n: {"count": 3, "seconds": 0.0}
             for n in ("sparsification_select", "pgo_solve")}
    value = reader.read(Context(spans=spans, keyframes=10))
    assert value is None
