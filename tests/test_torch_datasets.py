"""Port parity, dataset tooling: cslam_tpu_torch's utils/datasets.py,
utils/visualization.py and utils/image_sequence.py against cslam_tpu's
on the CPU.

Tolerances:
- KITTI pose files: written by either package, read by the other to
  the same arrays (f32, exact); the files' text identical.
- TUM trajectories across packages: stamps within 1e-6, t within 1e-5,
  R within 1e-4 (the reference test's round-trip bounds; the quaternions
  go through each package's f32 rot_to_quat / quat_to_rot, whose last
  printed digits may differ as the g2o text does, ROADMAP queue 3).
- split_trajectory, to_keyframe_stream, the visualization helpers, and
  every reader's frames, stamps, intrinsics, poses, calibration and the
  TUM association: identical.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import se3 as jse3
from cslam_tpu.utils import datasets as jds
from cslam_tpu.utils import image_sequence as jis
from cslam_tpu.utils import visualization as jvis
from cslam_tpu_torch.utils import datasets as tds
from cslam_tpu_torch.utils import image_sequence as tis
from cslam_tpu_torch.utils import visualization as tvis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")
REAL_SEQ = os.path.join(DATA, "real_seq")


@pytest.fixture(scope="module")
def traj():
    rng = np.random.default_rng(0)
    Rs = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, dtype=np.float32)]
    for _ in range(49):
        xi = rng.standard_normal(6).astype(np.float32) * 0.2
        dR, dt = jse3.se3_exp(jnp.asarray(xi))
        Rs.append(Rs[-1] @ np.asarray(dR))
        ts.append(Rs[-2] @ np.asarray(dt) + ts[-1])
    return np.stack(Rs), np.stack(ts)


def test_kitti_poses_cross_packages(tmp_path, traj):
    R, t = traj
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    jds.save_kitti_poses(a, R, t)
    tds.save_kitti_poses(b, R, t)
    assert open(a).read() == open(b).read()
    for x, y in zip(tds.load_kitti_poses(a), jds.load_kitti_poses(a)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_tum_trajectory_cross_packages(tmp_path, traj):
    R, t = traj
    stamps = np.arange(len(t)) * 0.1
    for writer, reader in ((tds, jds), (jds, tds), (tds, tds)):
        path = str(tmp_path / f"{writer.__name__}.txt")
        writer.save_tum_trajectory(path, stamps, R, t)
        s2, R2, t2 = reader.load_tum_trajectory(path)
        np.testing.assert_allclose(s2, stamps, atol=1e-6)
        np.testing.assert_allclose(t2, t, atol=1e-5)
        np.testing.assert_allclose(R2, R, atol=1e-4)
    path = str(tmp_path / "ref.txt")
    jds.save_tum_trajectory(path, stamps, R, t)
    for x, y in zip(tds.load_tum_trajectory(path),
                    jds.load_tum_trajectory(path)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_robots", [1, 3, 4])
def test_split_trajectory_is_identical(traj, n_robots):
    a = jds.split_trajectory(*traj, n_robots)
    b = tds.split_trajectory(*traj, n_robots)
    assert len(a) == len(b) == n_robots
    for (Ra, ta), (Rb, tb) in zip(a, b):
        assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)


def test_keyframe_stream_is_identical(traj):
    a = jds.to_keyframe_stream(*traj, min_distance=1.0)
    b = tds.to_keyframe_stream(*traj, min_distance=1.0)
    assert [k.id for k in a] == [k.id for k in b]
    assert all(np.array_equal(x.pose[1], y.pose[1]) for x, y in zip(a, b))
    assert a[0].to_bytes() == b[0].to_bytes()


def test_visualization_helpers_are_identical(tmp_path):
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 4000, (12, 16)).astype(np.uint16)
    color = rng.integers(0, 255, (12, 16, 3)).astype(np.uint8)
    for d in (depth, depth.astype(np.float32) / 1000.0):
        assert np.array_equal(
            tvis.depth_to_colored_pointcloud(d, color, 50, 50, 8, 6),
            jvis.depth_to_colored_pointcloud(d, color, 50, 50, 8, 6))
    est = {(r, k): (np.eye(3), rng.standard_normal(3))
           for r in range(3) for k in range(4)}
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    jvis.pose_graph_to_ply(est, a)
    tvis.pose_graph_to_ply(est, b)
    assert open(a).read() == open(b).read()


def _same_intrinsics(a, b):
    assert (a.fx, a.fy, a.cx, a.cy, a.baseline) == \
        (b.fx, b.fy, b.cx, b.cy, b.baseline)


@pytest.mark.parametrize("grayscale", [False, True])
def test_kitti_reader_frames_are_identical(grayscale):
    for seq_dir in (REAL_SEQ, os.path.join(DATA, "real_seq_b")):
        a = jis.KittiOdometrySequence(seq_dir, grayscale=grayscale)
        b = tis.KittiOdometrySequence(seq_dir, grayscale=grayscale)
        assert len(a) == len(b) and a.camera == b.camera
        assert np.array_equal(a.times, b.times)
        assert a.calib.keys() == b.calib.keys()
        for k in a.calib:
            assert np.array_equal(a.calib[k], b.calib[k])
        for x, y in zip(a.poses, b.poses):
            assert np.array_equal(x, y)
        _same_intrinsics(a.intrinsics(), b.intrinsics())
        for i in range(len(a)):
            assert np.array_equal(a.frame(i), b.frame(i))
            assert a.stamp(i) == b.stamp(i)
        assert a.right_frame(0) is None and b.right_frame(0) is None


def test_glob_reader_and_dispatch_are_identical(tmp_path):
    a = jis.GlobImageSequence(os.path.join(REAL_SEQ, "image_2"), fps=5.0)
    b = tis.GlobImageSequence(os.path.join(REAL_SEQ, "image_2"), fps=5.0)
    assert a.files == b.files and np.array_equal(a.times, b.times)
    _same_intrinsics(a.intrinsics(), b.intrinsics())
    assert np.array_equal(a.frame(3), b.frame(3))
    pattern = os.path.join(REAL_SEQ, "image_2", "00000*.jpg")
    a = jis.GlobImageSequence(pattern, stamps_from_names=True)
    b = tis.GlobImageSequence(pattern, stamps_from_names=True)
    assert np.array_equal(a.times, b.times)
    assert type(tis.open_sequence(REAL_SEQ)).__name__ == \
        type(jis.open_sequence(REAL_SEQ)).__name__ == "KittiOdometrySequence"
    with pytest.raises(FileNotFoundError):
        tis.GlobImageSequence(str(tmp_path / "*.png"))
    calib = tmp_path / "calib.txt"
    calib.write_text(" ".join(["1"] * 12) + "\n" + " ".join(["2"] * 12) +
                     "\nP3: " + " ".join(["3"] * 12) + "\nTr: 1 2 3\n")
    pa, pb = jis.parse_kitti_calib(str(calib)), tis.parse_kitti_calib(
        str(calib))
    assert pa.keys() == pb.keys() == {"P0", "P1", "P3"}
    for k in pa:
        assert np.array_equal(pa[k], pb[k])


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """real_seq as a TUM RGB-D directory, depth stamped 8 ms off."""
    import chip_smoke
    return chip_smoke.write_tum_dir(tmp_path_factory.mktemp("tum") / "seq")


def test_tum_reader_matches_reference(tum_dir):
    for max_dt in (0.02, 0.010):
        a = jis.TumRgbdSequence(tum_dir, max_dt=max_dt)
        b = tis.TumRgbdSequence(tum_dir, max_dt=max_dt)
        assert a._pairs == b._pairs and len(b) == 16
    assert type(tis.open_sequence(tum_dir)).__name__ == "TumRgbdSequence"
    for i in (0, 7):
        assert np.array_equal(a.frame(i), b.frame(i))
        assert np.array_equal(a.depth(i), b.depth(i))
    _same_intrinsics(a.intrinsics(), b.intrinsics())
    for x, y in zip(a.trajectory, b.trajectory):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tis.TumRgbdSequence(tum_dir, max_dt=0.005)
