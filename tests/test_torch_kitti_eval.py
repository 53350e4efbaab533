"""Port parity, kitti_eval: `python -m cslam_tpu_torch.tools.kitti_eval
--cpu` at tests/test_eval_artifacts.py::test_kitti_eval_one_command's
arguments, held to that test's gates and to the reference CLI's JSON on
the same fixture.

Both runs are deterministic (the same seeds and settings), and the
port's solve follows the reference's: the keyframes per robot, verified
loop closures, gossip bytes and optimization count are identical and
every ATE within 1e-4 relative (measured 2.7e-6: f32 solves rounded in
another order). The CNN path (--images on the checked-in real frames,
the shipped CosPlace on the CPU) is held to the same gates.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

ARGS = ["--robots", "2", "--kf-distance", "3.0", "--drift", "0.04",
        "--rounds", "4"]
EXACT = ("n_robots", "keyframes_per_robot", "verified_loop_closures",
         "gossip_comm_bytes", "optimizations")
ATES = ("ate_rmse_merged_odometry_m", "ate_rmse_merged_optimized_m",
        "ate_merged_improvement", "ate_rmse_odometry_m",
        "ate_rmse_optimized_m", "ate_improvement")


def _run(cmd, out):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd + ["--out", out], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.load(open(out))


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eval") / "poses.txt")
    chip_smoke.fixture_poses(path)
    return path


def _gates(res):
    assert res["n_robots"] == 2
    assert res["optimizations"] >= 1
    assert res["verified_loop_closures"] >= 1
    assert res["ate_rmse_merged_optimized_m"] is not None
    assert res["ate_merged_improvement"] > 1.0
    assert res["gossip_comm_bytes"] > 0
    assert res["platform"] == "cpu"


def test_kitti_eval_one_command_matches_reference(poses, tmp_path):
    port = _run([sys.executable, "-u", "-m",
                 "cslam_tpu_torch.tools.kitti_eval", "--data", poses,
                 *ARGS, "--cpu"], str(tmp_path / "port.json"))
    _gates(port)
    ref = _run([sys.executable, "-u",
                os.path.join(REPO, "benchmarks", "kitti_eval.py"),
                "--data", poses, *ARGS], str(tmp_path / "ref.json"))
    for k in EXACT:
        assert port[k] == ref[k], k
    for k in ATES:
        assert abs(port[k] - ref[k]) <= 1e-4 * abs(ref[k]), k
    assert set(ref) | {"platform", "knn_launches"} == set(port)


def test_kitti_eval_cnn_path_and_default_output(poses, tmp_path):
    res = _run([sys.executable, "-u", "-m",
                "cslam_tpu_torch.tools.kitti_eval", "--data", poses, *ARGS,
                "--images", str(chip_smoke.REAL_SEQ), "--model", "shipped",
                "--cpu"],
               str(tmp_path / "cnn.json"))
    _gates(res)
    from cslam_tpu_torch.tools import kitti_eval
    assert not kitti_eval.DEFAULT_OUT.startswith(
        os.path.join(REPO, "benchmarks"))
    assert kitti_eval.DEFAULT_OUT.startswith(
        os.path.join(REPO, "cslam_tpu_torch", "_build"))
