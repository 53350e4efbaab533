"""The harness on the CPU at tiny sizes: the last line, data found by
name, the recording from the seed, agreement with the plain reference,
and no JAX in a run."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from swarmbench.run import run_cell

from .conftest import REPO, tiny_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,end_to_end", [
    ("sim5r.revisit", {"keyframes_per_s", "setup_s", "map_latency_p95_s"}),
    ("lidar2r.revisit", {"keyframes_per_s", "setup_s"})])
def test_last_line_keys(root, workload, end_to_end):
    result, rows, _ = run_cell(root, workload, 2**31 + 17, 4.0,
                               device="cpu")
    assert list(result)[:5] == KEYS
    assert list(result)[-1] == "checks"
    json.dumps(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == end_to_end
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert [r[0] for r in rows] == list(result["checks"])


def test_traced_line_has_per_layer_metrics(root):
    result, _, _ = run_cell(root, "sim5r.revisit", 5, 3.0, trace=True,
                            device="cpu")
    assert {"detection_round_ms", "mac_select_ms", "knn_ms_per_kf",
            "solve_s"} <= set(result["metrics"])
    assert "keyframes_per_s" not in result["metrics"]
    dev = result["device"]
    assert dev["busy_s"] > 0 and dev["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())


def test_explore_reports_no_latency(root):
    result, rows, extra = run_cell(root, "sim5r.explore", 3, 2.0,
                                   device="cpu")
    assert "map_latency_p95_s" not in result["metrics"]
    assert extra["selections"] > 0
    assert "selection_faults" not in dict((r[0], r) for r in rows)


def test_found_by_name(root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with new entries in BENCHMARK.json, run without an edit to
    any file that was there."""
    d = root / "swarmbench"
    cfg = json.loads((d / "configs" / "kitti00-5r-sim512.json").read_text())
    cfg.update(name="kitti00-3r-sim512", robots=3)
    (d / "configs" / "kitti00-3r-sim512.json").write_text(json.dumps(cfg))
    traffic = json.loads((d / "workloads" / "sim5r.revisit.json").read_text())
    (d / "workloads" / "sim3r.revisit.json").write_text(json.dumps(traffic))
    (d / "metrics" / "solves_per_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records.solves)) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="kitti00-3r-sim512",
                                 file="swarmbench/configs/"
                                      "kitti00-3r-sim512.json"))
    bench["workloads"].append({"name": "sim3r.revisit",
                               "config": "kitti00-3r-sim512",
                               "traffic": "sim3r.revisit", "chips": 1,
                               "why": "three robots"})
    bench["end_to_end"].append({"name": "solves_per_window", "unit": "1",
                                "better": "higher", "bound": 0.25,
                                "source": "program_counter",
                                "workloads": ["sim3r.revisit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _, extra = run_cell(root, "sim3r.revisit", 9, 2.0, device="cpu")
    assert result["metrics"]["solves_per_window"]["value"] == extra["solves"]
    assert result["correct"]


@pytest.mark.parametrize("name", ["sim", "lidar"])
def test_recording_from_seed(root, name):
    from swarmbench.harness import Cell
    cell = Cell(root, f"{name}{5 if name == 'sim' else 2}r.revisit")
    fe = cell.frontend
    a = fe.make_recording(cell.config, cell.traffic, 2**31 + 5)
    b = fe.make_recording(cell.config, cell.traffic, 2**31 + 5)
    c = fe.make_recording(cell.config, cell.traffic, 2**31 + 6)
    for r in range(a.n_robots):
        np.testing.assert_array_equal(a.odom[r][1], b.odom[r][1])
        assert not np.array_equal(a.odom[r][1], c.odom[r][1])
    if name == "sim":
        np.testing.assert_array_equal(a.desc[1], b.desc[1])
        assert not np.array_equal(a.desc[1], c.desc[1])
    else:
        np.testing.assert_array_equal(a.scan(1, 7), b.scan(1, 7))
        assert not np.array_equal(a.scan(1, 7), c.scan(1, 7))
        assert len(a.scan(1, 7)) > 8192


@pytest.mark.parametrize("workload", ["sim5r.revisit", "lidar2r.revisit",
                                      "lidar2r.explore"])
def test_reference_agrees(root, workload):
    result, rows, _ = run_cell(root, workload, 77, 3.0, device="cpu")
    assert result["correct"], rows
    assert rows


def test_no_cuda_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run([sys.executable, "-m", "swarmbench.run",
                        "--workload", "sim5r.revisit", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_no_jax_in_a_run(tmp_path):
    """A fresh process that imports the harness and runs a tiny cell
    holds no module whose top-level name is jax, jaxlib, flax or
    cslam_tpu (whole names: cslam_tpu_torch is the port)."""
    root = tiny_root(tmp_path)
    code = (
        "import sys, json\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from swarmbench.run import run_cell, forbidden_modules\n"
        f"res, _, _ = run_cell({str(root)!r}, 'sim5r.revisit', 3, 1.0,"
        " device='cpu')\n"
        "print(json.dumps({'found': forbidden_modules(),"
        " 'port': 'cslam_tpu_torch' in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"found": [], "port": True}


def test_only_whole_names_are_forbidden(monkeypatch):
    from swarmbench import run
    monkeypatch.setitem(sys.modules, "cslam_tpu_torch_probe", sys)
    assert "cslam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_benchmark_file_shape():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "swarmbench" / "workloads" /
                f"{w['traffic']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (REPO / "swarmbench" / "metrics" / f"{m['name']}.py").exists()
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
