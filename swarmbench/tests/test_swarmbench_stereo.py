"""The stereo front-end on the CPU at a tiny size: the recording from the
seed, a run that reads correct, the control and planted faults that do
not, and the stereo cell's readers.

The tiny cell keeps the configuration's networks (shipped SuperPoint and
CosPlace, LightGlue at 9 layers on random weights) and cuts the frame to
241 x 96 (a width of 8k + 1), the keypoints to 128, the crop to 96, the
loops to 300 m and the detection period to 1 s, so a window of a few
seconds holds searches, a selection and solves."""

import json

import numpy as np
import pytest
import torch

from cslam_tpu_torch.runtime.tracing import Tracer, tracer
from swarmbench import compare
from swarmbench.harness import Cell, Run, leftover_threads
from swarmbench.run import Context, run_cell

from .conftest import tiny_root

CELL = "stereo2r.revisit"
TINY = {"route_length_m": 600.0, "start_offset_m": [120.0, 0.0],
        "frames_rendered": 120, "max_keypoints": 128,
        "camera": {"width": 241, "height": 96, "fx": 139.6, "fy": 139.6,
                   "cx": 117.9, "cy": 47.3, "baseline_m": 0.5372,
                   "height_m": 1.65}}
TINY_SETTINGS = {"frontend.image_crop_size": 96,
                 "frontend.stereo_max_disparity": 32}
READERS = ["feature_extract_ms", "stereo_depth_ms", "lightglue_ms",
           "lightglue_pairs_per_kf", "ransac_ms", "descriptor_ms_per_kf",
           "mfu_visual", "lightglue_mfu"]
NEW_CHECKS = ["superpoint_err", "superpoint_missed", "lightglue_err",
              "cosplace_err"]


@pytest.fixture
def sroot(tmp_path):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    path = root / "swarmbench" / "configs" / "kitti00-2r-stereo-learned.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    cfg["settings"].update(TINY_SETTINGS)
    cfg["periods_s"]["inter_robot_detection"] = 1.0
    path.write_text(json.dumps(cfg))
    path = root / "swarmbench" / "workloads" / f"{CELL}.json"
    traffic = json.loads(path.read_text())
    traffic["warmup_steps"] = 10
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


def test_recording_from_seed(sroot):
    cell = Cell(sroot, CELL)
    cell.config["frames_rendered"] = 12
    fe = cell.frontend
    a = fe.make_recording(cell.config, cell.traffic, 2**31 + 5)
    b = fe.make_recording(cell.config, cell.traffic, 2**31 + 5)
    c = fe.make_recording(cell.config, cell.traffic, 2**31 + 6)
    assert a.n_steps == 12 and a.left[1].shape == (12, 96, 241)
    assert a.left[0].dtype == np.uint8
    for r in range(a.n_robots):
        np.testing.assert_array_equal(a.left[r], b.left[r])
        np.testing.assert_array_equal(a.right[r], b.right[r])
        np.testing.assert_array_equal(a.odom[r][1], b.odom[r][1])
        assert not np.array_equal(a.left[r], c.left[r])
        assert not np.array_equal(a.odom[r][1], c.odom[r][1])
    # the world is the seed's noise apart: the same pixels up to it
    diff = np.abs(a.left[0].astype(int) - c.left[0].astype(int))
    assert np.median(diff) <= 2 and a.left[0].std() > 20


def test_tiny_run_is_correct_and_the_control_is_not(sroot):
    cell, run = _window(sroot, 2**31 + 11)
    limits = cell.config["limits"]
    sound = compare.numbers(run)
    ok, rows = compare.judge(sound, limits)
    assert ok, rows
    assert set(NEW_CHECKS) <= set(sound)
    assert run.records.solves
    ctl = compare.numbers(run, control=True)
    for name in NEW_CHECKS:
        assert ctl[name] > limits[name] > sound[name], name
    assert not compare.judge(ctl, limits)[0]


def _shifted_scores(monkeypatch):
    from cslam_tpu_torch.models.lightglue import LightGlue
    scores = LightGlue.scores

    def altered(self, *a, **k):
        return scores(self, *a, **k) + 0.1
    monkeypatch.setattr(LightGlue, "scores", altered)


def _perturbed_keypoint_descriptors(monkeypatch):
    from cslam_tpu_torch.models.superpoint import SuperPoint
    extract = SuperPoint.extract_features

    def altered(self, *a, **k):
        xy, desc, scores, mask = extract(self, *a, **k)
        desc = desc.clone()
        desc[:, 0] += 0.2 * mask
        return xy, desc, scores, mask
    monkeypatch.setattr(SuperPoint, "extract_features", altered)


def _half_the_keypoints(monkeypatch):
    """The highest-scored half of the keypoints kept, the rest masked."""
    from cslam_tpu_torch.models.superpoint import SuperPoint
    extract = SuperPoint.extract_features

    def altered(self, *a, **k):
        xy, desc, scores, mask = extract(self, *a, **k)
        valid = torch.nonzero(mask > 0)[:, 0]
        valid = valid[torch.argsort(scores[valid], descending=True)]
        mask = mask.clone()
        mask[valid[len(valid) // 2:]] = 0.0
        return xy, desc, scores, mask
    monkeypatch.setattr(SuperPoint, "extract_features", altered)


def _perturbed_place_descriptors(monkeypatch):
    from cslam_tpu_torch.models.cosplace import CosPlace
    embed = CosPlace.compute_embeddings_batch

    def altered(self, images):
        out = embed(self, images)
        out[:, :2] = out[:, 1::-1]
        return out
    monkeypatch.setattr(CosPlace, "compute_embeddings_batch", altered)


def _decoded_with_the_image_width(monkeypatch):
    """The decode before its repair: the heatmap's flat indices read with
    the image's width, which is one more than the heatmap's here."""
    from cslam_tpu_torch.models.superpoint import SuperPoint
    extract = SuperPoint.extract_features

    def altered(self, image, *a, **k):
        xy, desc, scores, mask = extract(self, image, *a, **k)
        width = image.shape[1]
        flat = xy[:, 1].long() * (width // 8 * 8) + xy[:, 0].long()
        xy = torch.stack([flat % width, flat // width], 1).to(xy.dtype)
        return xy, desc, scores, mask
    monkeypatch.setattr(SuperPoint, "extract_features", altered)


def test_set_up_ends_a_run_whose_keypoints_are_misplaced(sroot,
                                                         monkeypatch):
    cell = Cell(sroot, CELL)
    cell.config["frames_rendered"] = 4
    fe = cell.frontend
    rec = fe.make_recording(cell.config, cell.traffic, 2**31 + 41)
    dev = torch.device("cpu")
    swarm = fe.build_swarm(cell.config, cell.traffic, rec, dev)
    try:
        assert fe.check_keypoint_positions(swarm, rec, dev) < 0.1
        _decoded_with_the_image_width(monkeypatch)
        with pytest.raises(RuntimeError, match="cannot run this config"):
            fe.check_keypoint_positions(swarm, rec, dev)
    finally:
        swarm.close()
    with pytest.raises(RuntimeError, match="cannot run this config"):
        run_cell(sroot, CELL, 2**31 + 41, 2.0, device="cpu")
    assert not leftover_threads()


@pytest.mark.parametrize("fault,number", [
    (_shifted_scores, "lightglue_err"),
    (_perturbed_keypoint_descriptors, "superpoint_err"),
    (_half_the_keypoints, "superpoint_missed"),
    (_perturbed_place_descriptors, "cosplace_err")])
def test_planted_fault_is_not_correct(sroot, monkeypatch, fault, number):
    fault(monkeypatch)
    cell, run = _window(sroot, 2**31 + 29, seconds=2.0)
    values = compare.numbers(run)
    assert values[number] > cell.config["limits"][number], values
    assert not compare.judge(values, cell.config["limits"])[0]


def test_traced_tiny_run_reports_the_stereo_metrics(sroot):
    result, rows, extra = run_cell(sroot, CELL, 2**31 + 3, 4.0, trace=True,
                                   device="cpu")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(m), sorted(m)
    assert 0 < m["mfu_visual"] < 100 and 0 < m["lightglue_mfu"] < 100
    assert m["lightglue_pairs_per_kf"] > 0.5
    assert result["correct"], rows


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_records(sroot, monkeypatch, name):
    """Untraced (no spans), traced with nothing recorded, and, for the
    readers of counters and span args, a program whose tracer keeps no
    counter totals and whose spans carry no args: no value, no error."""
    tracer.clear()
    cell = Cell(sroot, CELL)
    reader = cell.reader(name)
    assert reader.read(Context(cell=cell, spans=None, keyframes=10,
                               window_s=5.0)) is None
    assert reader.read(Context(cell=cell, spans={}, keyframes=10,
                               window_s=5.0)) is None
    if name.endswith("_ms") and name != "descriptor_ms_per_kf":
        return
    monkeypatch.delattr(Tracer, "counter_totals")
    spans = {n: {"count": 3, "seconds": 0.0}
             for n in ("lightglue_match", "feature_extract")}
    assert reader.read(Context(cell=cell, spans=spans, keyframes=10,
                               window_s=5.0)) is None
