"""Real image-sequence ingestion: KITTI odometry layout, TUM RGB-D
layout, and a glob fallback.

Port of cslam_tpu/utils/image_sequence.py. Outside ROS, a dataset
directory stands in for the reference's camera topics: these readers
turn a KITTI odometry sequence directory, a TUM RGB-D directory, or any
directory of images into the (stamp, image, intrinsics) stream the
sensor handlers ingest (frontend/rgbd_handler.py add_sensor_data /
add_stereo_pair).

KITTI odometry sequence layout:

    <seq>/
      image_0/ image_1/   grayscale left/right (PNG)
      image_2/ image_3/   color left/right (PNG)
      times.txt           one stamp (s) per frame
      calib.txt           P0..P3 3x4 projection matrices (+ optional Tr)
      poses.txt | <seq>.txt   optional ground truth [R|t] rows

Decoding is host work, done with PIL as in the reference, so every
frame is the same uint8 array wherever the port runs; the consumers (SuperPoint, CosPlace, the handlers) move it to
their device. Images load lazily (one PIL read per `frame` call).
"""

import glob
import os
import re
from typing import Optional, Tuple

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".pgm", ".bmp")


def _load_image(path: str, grayscale: bool) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    return np.asarray(img, dtype=np.uint8)


def _intrinsics_from_projection(P: np.ndarray):
    """(fx, fy, cx, cy, tx) from a KITTI 3x4 projection matrix.
    tx = -fx * baseline for the right camera of a rectified pair."""
    return (float(P[0, 0]), float(P[1, 1]), float(P[0, 2]),
            float(P[1, 2]), float(P[0, 3]))


def parse_kitti_calib(path: str) -> dict:
    """{'P0': (3,4), ...} from a KITTI calib.txt (labels optional:
    unlabeled rows are assigned P0..P3 in order)."""
    out = {}
    unlabeled = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                label, rest = line.split(":", 1)
            else:
                label, rest = f"P{unlabeled}", line
                unlabeled += 1
            vals = np.fromstring(rest, sep=" ")
            if vals.size == 12:
                out[label.strip()] = vals.reshape(3, 4)
    return out


class GlobImageSequence:
    """Any directory/glob of images as a timed mono sequence.

    Frames are sorted by natural filename order; stamps come from
    `times` (array/list), a `fps`, or filename-embedded numbers when
    `stamps_from_names` (e.g. TUM rgb/<epoch>.png).
    """

    def __init__(self, pattern: str, fps: float = 10.0, times=None,
                 stamps_from_names: bool = False, intrinsics=None,
                 grayscale: bool = False):
        if os.path.isdir(pattern):
            files = [os.path.join(pattern, f) for f in os.listdir(pattern)
                     if f.lower().endswith(IMAGE_EXTS)]
        else:
            files = [f for f in glob.glob(pattern)
                     if f.lower().endswith(IMAGE_EXTS)]
        if not files:
            raise FileNotFoundError(f"no images match {pattern!r}")

        def natural(f):
            parts = re.split(r"(\d+)", os.path.basename(f))
            return [int(p) if p.isdigit() else p for p in parts]

        self.files = sorted(files, key=natural)
        if times is not None:
            self.times = np.asarray(times, dtype=np.float64)
        elif stamps_from_names:
            stamps = []
            for f in self.files:
                m = re.search(r"(\d+(?:\.\d+)?)",
                              os.path.basename(f))
                stamps.append(float(m.group(1)) if m else len(stamps) / fps)
            self.times = np.asarray(stamps)
        else:
            self.times = np.arange(len(self.files)) / float(fps)
        self.grayscale = grayscale
        self._intrinsics = intrinsics

    def __len__(self):
        return len(self.files)

    def stamp(self, i: int) -> float:
        return float(self.times[i])

    def frame(self, i: int) -> np.ndarray:
        return _load_image(self.files[i], self.grayscale)

    def intrinsics(self):
        """User-provided intrinsics, or a pinhole guess from the first
        frame (fx = fy = 0.9 w — a typical consumer-camera FoV; fine
        for matching/VPR, replace with calibration for metric use)."""
        if self._intrinsics is None:
            from cslam_tpu_torch.frontend.rgbd_handler import CameraIntrinsics
            h, w = self.frame(0).shape[:2]
            f = 0.9 * w
            self._intrinsics = CameraIntrinsics(fx=f, fy=f, cx=w / 2.0,
                                                cy=h / 2.0)
        return self._intrinsics


class KittiOdometrySequence:
    """A KITTI odometry sequence directory (image_2 by default).

    `frame(i)` returns the uint8 image; `right_frame(i)` the rectified
    right image when the paired camera dir exists (image_3 for image_2,
    image_1 for image_0) — feeding StereoHandler.add_stereo_pair.
    `poses` carries ground truth ((N,3,3), (N,3)) when a poses file is
    present. Intrinsics come from calib.txt's projection matrices,
    including the stereo baseline from the right camera's tx.
    """

    PAIRS = {"image_2": "image_3", "image_0": "image_1"}

    def __init__(self, seq_dir: str, camera: str = "image_2",
                 grayscale: bool = False):
        self.seq_dir = seq_dir
        self.camera = camera
        img_dir = os.path.join(seq_dir, camera)
        if not os.path.isdir(img_dir):
            available = [d for d in os.listdir(seq_dir)
                         if d.startswith("image_")] \
                if os.path.isdir(seq_dir) else []
            if available:
                img_dir = os.path.join(seq_dir, sorted(available)[0])
                self.camera = os.path.basename(img_dir)
            else:
                raise FileNotFoundError(
                    f"{seq_dir} has no image_N directory")
        self.files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith(IMAGE_EXTS))
        if not self.files:
            raise FileNotFoundError(f"no images in {img_dir}")
        self.grayscale = grayscale

        times_path = os.path.join(seq_dir, "times.txt")
        if os.path.exists(times_path):
            self.times = np.loadtxt(times_path, dtype=np.float64).reshape(-1)
        else:
            self.times = np.arange(len(self.files)) / 10.0

        self.calib = {}
        calib_path = os.path.join(seq_dir, "calib.txt")
        if os.path.exists(calib_path):
            self.calib = parse_kitti_calib(calib_path)

        self.poses: Optional[Tuple[np.ndarray, np.ndarray]] = None
        for cand in ("poses.txt",
                     os.path.basename(os.path.normpath(seq_dir)) + ".txt"):
            p = os.path.join(seq_dir, cand)
            if os.path.exists(p):
                from cslam_tpu_torch.utils.datasets import load_kitti_poses
                self.poses = load_kitti_poses(p)
                break

        right_cam = self.PAIRS.get(self.camera)
        self.right_dir = os.path.join(seq_dir, right_cam) \
            if right_cam else None
        if self.right_dir and not os.path.isdir(self.right_dir):
            self.right_dir = None

    def __len__(self):
        return len(self.files)

    def stamp(self, i: int) -> float:
        return float(self.times[i])

    def frame(self, i: int) -> np.ndarray:
        return _load_image(self.files[i], self.grayscale)

    def right_frame(self, i: int) -> Optional[np.ndarray]:
        if self.right_dir is None:
            return None
        path = os.path.join(self.right_dir,
                            os.path.basename(self.files[i]))
        return _load_image(path, self.grayscale) \
            if os.path.exists(path) else None

    def intrinsics(self):
        from cslam_tpu_torch.frontend.rgbd_handler import CameraIntrinsics
        label = {"image_0": "P0", "image_1": "P1",
                 "image_2": "P2", "image_3": "P3"}.get(self.camera, "P2")
        P = self.calib.get(label)
        if P is None and self.calib:
            P = next(iter(self.calib.values()))
        if P is None:
            h, w = self.frame(0).shape[:2]
            return _default_intrinsics(h, w)
        fx, fy, cx, cy, _ = _intrinsics_from_projection(P)
        baseline = 0.0
        pair = self.PAIRS.get(self.camera)
        right_label = {"image_3": "P3", "image_1": "P1"}.get(pair)
        if right_label in self.calib:
            tx = self.calib[right_label][0, 3]
            baseline = float(-tx / fx) if fx else 0.0
        return CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy,
                                baseline=baseline)


def _parse_tum_file_list(path: str):
    """[(stamp, relative_path)] from a TUM rgb.txt / depth.txt listing
    ('# comment' lines, then 'stamp filename' rows)."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                entries.append((float(parts[0]), parts[1]))
    return entries


class TumRgbdSequence:
    """A TUM RGB-D sequence directory: real color + real metric depth.

    This is the dataset form of what Swarm-SLAM's RGBDHandler consumes
    over ROS (an image+depth ApproximateTimeSynchronizer): rgb/ and
    depth/ PNG streams with independent stamps, associated here by
    nearest-stamp within `max_dt` (unmatched rgb frames are dropped, the
    sync's behavior). Layout:

        <seq>/
          rgb.txt   depth.txt      '# comments' then 'stamp file' rows
          rgb/*.png                uint8 color
          depth/*.png              uint16, meters = value / depth_scale
          groundtruth.txt          optional 'stamp tx ty tz qx qy qz qw'

    `frame(i)` -> uint8 RGB; `depth(i)` -> float32 meters (0 = invalid,
    TUM's convention). Default intrinsics are the TUM Freiburg pinhole
    (fx=fy=525, cx=319.5, cy=239.5) — pass `intrinsics` for calibrated
    use. `depth_scale` defaults to TUM's 5000 units/meter.
    """

    def __init__(self, seq_dir: str, max_dt: float = 0.02,
                 depth_scale: float = 5000.0, intrinsics=None):
        self.seq_dir = seq_dir
        rgb_list = os.path.join(seq_dir, "rgb.txt")
        depth_list = os.path.join(seq_dir, "depth.txt")
        if os.path.exists(rgb_list):
            rgb = _parse_tum_file_list(rgb_list)
        else:  # listing-free dumps: stamps are the filenames
            rgb_dir = os.path.join(seq_dir, "rgb")
            rgb = sorted(
                (float(os.path.splitext(f)[0]), os.path.join("rgb", f))
                for f in os.listdir(rgb_dir)
                if f.lower().endswith(IMAGE_EXTS))
        if os.path.exists(depth_list):
            depth = _parse_tum_file_list(depth_list)
        else:
            depth_dir = os.path.join(seq_dir, "depth")
            depth = sorted(
                (float(os.path.splitext(f)[0]), os.path.join("depth", f))
                for f in os.listdir(depth_dir)
                if f.lower().endswith(IMAGE_EXTS))
        if not rgb or not depth:
            raise FileNotFoundError(f"{seq_dir}: empty rgb or depth stream")

        # nearest-stamp association (two sorted streams, one pass)
        depth_stamps = np.asarray([s for s, _ in depth])
        self._pairs = []  # (stamp, rgb_path, depth_path)
        for stamp, rgb_path in rgb:
            j = int(np.searchsorted(depth_stamps, stamp))
            best, best_dt = None, max_dt
            for cand in (j - 1, j):
                if 0 <= cand < len(depth):
                    dt = abs(depth_stamps[cand] - stamp)
                    if dt <= best_dt:
                        best, best_dt = cand, dt
            if best is not None:
                self._pairs.append((stamp, rgb_path, depth[best][1]))
        if not self._pairs:
            raise ValueError(
                f"{seq_dir}: no rgb/depth pairs within {max_dt}s")

        self.depth_scale = float(depth_scale)
        self._intrinsics = intrinsics

        self.trajectory = None  # (stamps, R, t) ground truth if shipped
        gt = os.path.join(seq_dir, "groundtruth.txt")
        if os.path.exists(gt):
            from cslam_tpu_torch.utils.datasets import load_tum_trajectory
            self.trajectory = load_tum_trajectory(gt)

    def __len__(self):
        return len(self._pairs)

    def stamp(self, i: int) -> float:
        return self._pairs[i][0]

    def frame(self, i: int) -> np.ndarray:
        return _load_image(os.path.join(self.seq_dir, self._pairs[i][1]),
                           grayscale=False)

    def depth(self, i: int) -> np.ndarray:
        from PIL import Image
        raw = np.asarray(
            Image.open(os.path.join(self.seq_dir, self._pairs[i][2])))
        return raw.astype(np.float32) / self.depth_scale

    def intrinsics(self):
        if self._intrinsics is None:
            from cslam_tpu_torch.frontend.rgbd_handler import CameraIntrinsics
            self._intrinsics = CameraIntrinsics(fx=525.0, fy=525.0,
                                                cx=319.5, cy=239.5)
        return self._intrinsics


def _default_intrinsics(h, w):
    from cslam_tpu_torch.frontend.rgbd_handler import CameraIntrinsics
    f = 0.9 * w
    return CameraIntrinsics(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)


def open_sequence(path: str, **kwargs):
    """KittiOdometrySequence when `path` looks like a KITTI sequence dir
    (has image_N/), TumRgbdSequence when it has rgb/ + depth/, else
    GlobImageSequence."""
    if os.path.isdir(path):
        entries = os.listdir(path)
        if any(d.startswith("image_") and
               os.path.isdir(os.path.join(path, d)) for d in entries):
            return KittiOdometrySequence(path, **kwargs)
        if all(os.path.isdir(os.path.join(path, d))
               for d in ("rgb", "depth")):
            return TumRgbdSequence(path, **kwargs)
    return GlobImageSequence(path, **kwargs)
