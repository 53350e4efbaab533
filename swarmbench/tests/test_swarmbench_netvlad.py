"""The NetVLAD stereo front-end on the CPU at a tiny size: a run that reads
correct, the control that does not, a descriptor from the wrong
projection that turns `correct` false, the drawn projection, and the
cell's readers.

The tiny cell keeps the configuration's networks (shipped SuperPoint,
VGG-16 and NetVLAD layer, LightGlue at 9 layers on random weights) and
cuts the frame to 241 x 96, the keypoints to 128, the crop to 96, the
projection to 256 rows, the loops to 600 m and the detection period to
1 s, so a window of a few seconds holds searches and solves."""

import json

import numpy as np
import pytest
import torch

from cslam_tpu_torch.runtime.tracing import Tracer, tracer
from swarmbench import compare
from swarmbench.harness import Cell, Run, leftover_threads
from swarmbench.run import Context, run_cell

from .conftest import tiny_root

CELL = "netvlad2r.revisit"
CONFIG = "kitti00-2r-stereo-netvlad"
TINY = {"route_length_m": 600.0, "start_offset_m": [120.0, 0.0],
        "frames_rendered": 120, "max_keypoints": 128, "descriptor_dim": 256,
        "camera": {"width": 241, "height": 96, "fx": 139.6, "fy": 139.6,
                   "cx": 117.9, "cy": 47.3, "baseline_m": 0.5372,
                   "height_m": 1.65}}
TINY_SETTINGS = {"frontend.image_crop_size": 96,
                 "frontend.global_descriptor_dim": 256,
                 "frontend.stereo_max_disparity": 32}
READERS = ["netvlad_ms_per_kf", "netvlad_roofline", "mfu_visual_netvlad",
           "feature_extract_ms", "stereo_depth_ms", "knn_searches_per_kf",
           "knn_search_us", "knn_add_us"]
NEW_CHECKS = ["netvlad_err", "netvlad_pca_err"]


@pytest.fixture
def nroot(tmp_path):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    path = root / "swarmbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    cfg["settings"].update(TINY_SETTINGS)
    cfg["periods_s"]["inter_robot_detection"] = 1.0
    path.write_text(json.dumps(cfg))
    path = root / "swarmbench" / "workloads" / f"{CELL}.json"
    traffic = json.loads(path.read_text())
    traffic["warmup_steps"] = 10
    traffic["check_images"] = 16
    path.write_text(json.dumps(traffic))
    return root


def _window(root, seed, seconds=4.0):
    cell = Cell(root, CELL)
    run = Run(cell, seed, torch.device("cpu"))
    try:
        run.warm_up()
        run.window(seconds)
        run.latency_drain()
    finally:
        run.close()
    return cell, run


def test_projection_completes_the_shipped_rows(nroot):
    """The shipped mean and 128 components, completed to the configured
    rows: orthonormal, the same draw from the same `pca_seed`."""
    cell = Cell(nroot, CELL)
    fe = cell.frontend
    mean, rows = fe.draw_projection(cell.config, torch.device("cpu"))
    with np.load(fe.WEIGHTS / "netvlad_pca_synth.npz") as z:
        np.testing.assert_array_equal(mean, z["mean"])
        np.testing.assert_array_equal(rows[:128], z["components"])
    assert rows.shape == (256, 64 * 512) and rows.dtype == np.float32
    gram = rows.astype(np.float64) @ rows.T.astype(np.float64)
    assert np.abs(gram - np.eye(256)).max() < 1e-5
    np.testing.assert_array_equal(
        rows, fe.draw_projection(cell.config, torch.device("cpu"))[1])
    cell.config["pca_seed"] += 1
    assert not np.array_equal(
        rows[128:], fe.draw_projection(cell.config, torch.device("cpu"))[1][
            128:])


def test_tiny_run_is_correct_and_the_control_is_not(nroot):
    cell, run = _window(nroot, 2**31 + 11)
    limits = cell.config["limits"]
    sound = compare.numbers(run)
    ok, rows = compare.judge(sound, limits)
    assert ok, rows
    assert set(NEW_CHECKS) | {"topk_err", "superpoint_err"} <= set(sound)
    assert "cosplace_err" not in sound
    # every frame a keyframe, each published at the projection's width
    assert len(run.records.feeds) == 2 * max(
        k[2] for k in run.records.feeds) + 2
    assert {len(d) for d in run.rec.kf_desc.values()} == {256}
    ctl = compare.numbers(run, control=True)
    for name in NEW_CHECKS:
        assert ctl[name] > limits[name] > sound[name], name
    assert not compare.judge(ctl, limits)[0]


def _wrong_projection(monkeypatch):
    """Every published descriptor from a projection whose first two rows
    are swapped."""
    from cslam_tpu_torch.models.netvlad import NetVLAD
    check = NetVLAD._check_projection

    def swapped(self):
        check(self)
        self.pca_components = self.pca_components[[1, 0] + list(
            range(2, self.pca_components.shape[0]))]
    monkeypatch.setattr(NetVLAD, "_check_projection", swapped)


def test_wrong_projection_is_not_correct(nroot, monkeypatch):
    _wrong_projection(monkeypatch)
    cell, run = _window(nroot, 2**31 + 29, seconds=2.0)
    values = compare.numbers(run)
    limits = cell.config["limits"]
    for name in NEW_CHECKS:
        assert values[name] > limits[name], values
    assert not compare.judge(values, limits)[0]


def test_traced_tiny_run_reports_the_netvlad_metrics(nroot):
    result, rows, extra = run_cell(nroot, CELL, 2**31 + 3, 4.0, trace=True,
                                   device="cpu")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(m), sorted(m)
    assert 0 < m["netvlad_roofline"] < 100
    assert 0 < m["mfu_visual_netvlad"] < 100
    assert m["netvlad_ms_per_kf"] > 0
    assert result["correct"], rows
    assert not leftover_threads()


@pytest.mark.parametrize("name", ["netvlad_ms_per_kf", "netvlad_roofline",
                                  "mfu_visual_netvlad"])
def test_readers_return_nothing_without_records(nroot, monkeypatch, name):
    """Untraced (no spans), traced with nothing recorded, and a program
    whose tracer keeps no counter totals and whose spans carry no shape
    (the parent's NetVLAD): no value, no error."""
    tracer.clear()
    cell = Cell(nroot, CELL)
    reader = cell.reader(name)
    assert reader.read(Context(cell=cell, spans=None, keyframes=10,
                               window_s=5.0)) is None
    assert reader.read(Context(cell=cell, spans={}, keyframes=10,
                               window_s=5.0)) is None
    monkeypatch.delattr(Tracer, "counter_totals")
    tracer.enable(None)
    try:
        with tracer.span("descriptor_forward", images=8):
            pass
    finally:
        tracer.disable()
    spans = {"descriptor_forward": {"count": 1, "seconds": 0.01},
             "descriptor_preprocess": {"count": 1, "seconds": 0.01}}
    assert reader.read(Context(cell=cell, spans=spans, keyframes=10,
                               window_s=5.0)) is None
    tracer.clear()
