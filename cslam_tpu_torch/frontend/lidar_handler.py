"""Lidar sensor handler: keyframe selection, Scan Context descriptors,
registration-based loop-closure verification.

Port of cslam_tpu/frontend/lidar_handler.py (the Swarm-SLAM reference's
lidar_handler_node.py): odometry-distance keyframe gating, voxel
downsampling, publication of KeyframePointCloud + KeyframeOdom, the
local-descriptor request/response, and verification of each candidate
by GNC-ICP from two seeds (the Scan Context yaw, and FPFH
correspondences through 3D-3D RANSAC), publishing Intra- and
InterRobotLoopClosure results.

Device: the voxel grid, Scan Contexts, FPFH, RANSAC and ICP run on
`device` (None = the CUDA card; raises without one). As in the
reference, keyframe clouds are kept and sent as numpy; `_register` pads
both clouds to the next power of two and brings each ICP result back to
the host in one copy. Host spans (`runtime/tracing.span`), each ending
in a copy back or a device synchronize, time the stages:
voxel_downsample, scancontext (the yaw seed; the place model's
embeddings are scancontext_embedding), fpfh, ransac_3d3d, gnc_icp.

`_pad_cloud` keeps the first `capacity` points of a larger scan, not
the nearest, as the reference does.
"""

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.device import DeviceLike, resolve_device, sync
from cslam_tpu_torch.frontend.rgbd_handler import host_result
from cslam_tpu_torch.ops import fpfh as fpfh_ops
from cslam_tpu_torch.ops import registration, scancontext as sc_ops
from cslam_tpu_torch.ops.matching2d import ransac_rigid3d
from cslam_tpu_torch.ops.registration import RegistrationResult
from cslam_tpu_torch.runtime.tracing import span


@dataclass
class KeyframePointCloud:
    id: int
    points: np.ndarray  # (N, 3)


def _to_device(x, device):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)


class ScanContextModel:
    """compute_embedding(points) -> flattened (20 * 60,) Scan Context
    (the reference's lidar_pr/scancontext.py), computed on `device`."""

    def __init__(self, params: Optional[Dict] = None,
                 device: DeviceLike = None):
        self.params = params or {}
        self.device = resolve_device(device)
        self.shape = (20, 60)
        self.max_length = 80.0

    def compute_embedding(self, points: np.ndarray) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        with span("scancontext_embedding"):
            sc = sc_ops.pointcloud_to_scancontext(
                _to_device(pts, self.device),
                torch.ones(len(pts), dtype=torch.float32,
                           device=self.device),
                num_ring=self.shape[0], num_sector=self.shape[1],
                max_length=self.max_length)
            return sc.cpu().numpy().flatten()


def _pad_cloud(points: np.ndarray, capacity: int):
    n = min(len(points), capacity)
    out = np.zeros((capacity, 3), dtype=np.float32)
    out[:n] = points[:n]
    mask = np.zeros(capacity, dtype=np.float32)
    mask[:n] = 1.0
    return out, mask


class LidarHandler:
    """Host-side front-end: feed (pointcloud, odom) pairs; emits keyframes
    and verified loop closures over the bus."""

    def __init__(self, params: Dict, bus, clock, capacity: int = 8192,
                 device: DeviceLike = None):
        self.params = params
        self.bus = bus
        self.clock = clock
        self.capacity = capacity
        self.device = resolve_device(device)
        self.robot_id = params["robot_id"]
        self.nb_local_keyframes = 0
        self.previous_keyframe_pose: Optional[Tuple[np.ndarray,
                                                    np.ndarray]] = None
        self.local_keyframes: Dict[int, np.ndarray] = {}
        self.received_data: List[Tuple[np.ndarray, Tuple]] = []
        # registrations, their outcomes by kind ("intra" / "inter",
        # success), the padded size of each, and the ICP iterations (each
        # one host sync) they ran
        self.log_verifications = 0
        self.log_outcomes: Counter = Counter()
        self.log_register_caps: Counter = Counter()
        self.log_icp_iterations = 0

        self.keyframe_publisher = bus.create_publisher("cslam/keyframe_data")
        self.odom_publisher = bus.create_publisher("cslam/keyframe_odom")
        self.intra_lc_publisher = bus.create_publisher(
            "cslam/intra_robot_loop_closure")
        self.inter_lc_publisher = bus.create_publisher(
            "/cslam/inter_robot_loop_closure")
        self.pointcloud_publisher = bus.create_publisher(
            "/cslam/local_descriptors")
        bus.subscribe("cslam/local_descriptors_request",
                      self.publish_local_descriptors)
        bus.subscribe("/cslam/local_descriptors",
                      self.receive_local_descriptors)
        bus.subscribe("cslam/local_keyframe_match",
                      self.receive_local_keyframe_match)

        self.kf_threshold = params.get(
            "frontend.kf_distance_threshold",
            params.get("frontend.keyframe_generation_ratio_threshold", 1.0))
        self.voxel_size = params.get("frontend.voxel_size", 0.5)
        # ICP iteration cap per GNC level: each level only needs to
        # track the weighted optimum toward the next basin
        self.icp_iters_per_level = params.get(
            "frontend.icp_max_iters_per_level", 5)
        # cap of the final step-gated refinement at the hardest mu
        self.icp_max_iters = params.get("frontend.icp_max_iters", 12)

    # ------------------------------------------------------------------
    def add_sensor_data(self, points: np.ndarray,
                        pose: Tuple[np.ndarray, np.ndarray]):
        """One synced (pointcloud, odometry) sample; buffered for the
        processing tick."""
        self.received_data.append((np.asarray(points, dtype=np.float32),
                                   (np.asarray(pose[0], dtype=np.float32),
                                    np.asarray(pose[1], dtype=np.float32))))

    def generate_new_keyframe(self, pose) -> bool:
        """Keyframe when odometry moved far enough."""
        if self.previous_keyframe_pose is None:
            return True
        dt = pose[1] - self.previous_keyframe_pose[1]
        return float(np.dot(dt, dt)) > self.kf_threshold ** 2

    def process_new_sensor_data(self):
        """Processing tick: gate, voxel-downsample, publish."""
        if not self.received_data:
            return None
        points, pose = self.received_data.pop(0)
        if not self.generate_new_keyframe(pose):
            return None
        padded, mask = _pad_cloud(points, self.capacity)
        with span("voxel_downsample", robot=self.robot_id):
            ds_points, ds_mask = registration.voxel_downsample(
                _to_device(padded, self.device),
                _to_device(mask, self.device), self.voxel_size)
            host = torch.cat([ds_points, ds_mask[:, None]], dim=1).cpu(
                ).numpy()
        cloud = np.ascontiguousarray(host[host[:, 3] > 0, :3])
        kf_id = self.nb_local_keyframes
        self.local_keyframes[kf_id] = cloud
        self.previous_keyframe_pose = pose
        self.nb_local_keyframes += 1
        self.keyframe_publisher.publish(KeyframePointCloud(kf_id, cloud))
        self.odom_publisher.publish(msgs.KeyframeOdom(id=kf_id, pose=pose))
        return kf_id

    # ------------------------------------------------------------------
    def publish_local_descriptors(self, request):
        """Answer a LocalDescriptorsRequest with the keyframe cloud."""
        kf_id = request.keyframe_id
        if kf_id not in self.local_keyframes:
            return
        self.pointcloud_publisher.publish(
            msgs.LocalPointCloudDescriptors(
                robot_id=self.robot_id, keyframe_id=kf_id,
                matches_robot_id=list(request.matches_robot_id),
                matches_keyframe_id=list(request.matches_keyframe_id),
                points=self.local_keyframes[kf_id]))

    def _register(self, src_cloud: np.ndarray,
                  dst_cloud: np.ndarray) -> RegistrationResult:
        """Robust registration (the reference's TEASER++ + ICP): GNC-ICP
        from two independent seeds, the Scan Context yaw and FPFH mutual
        correspondences through RANSAC; the better fit (inlier fraction,
        then -RMSE) wins. Returns it as numpy."""
        cap = 1
        target = max(len(src_cloud), len(dst_cloud), 1)
        while cap < target:
            cap *= 2
        self.log_verifications += 1
        self.log_register_caps[cap] += 1
        src, src_mask = (_to_device(a, self.device)
                         for a in _pad_cloud(src_cloud, cap))
        dst, dst_mask = (_to_device(a, self.device)
                         for a in _pad_cloud(dst_cloud, cap))

        seeds = []
        with span("scancontext", robot=self.robot_id):
            sc_src = sc_ops.pointcloud_to_scancontext(src, src_mask)
            sc_dst = sc_ops.pointcloud_to_scancontext(dst, dst_mask)
            _, yaws = sc_ops.scancontext_distances(sc_dst, sc_src[None])
            # -yaw * 2 pi / 60 in f64, then f32: the reference's host
            # float, without a copy back
            yaw = (-yaws[0].to(torch.float64) * (2.0 * np.pi / 60.0)).to(
                torch.float32)
            sync(self.device)  # the span times its device work
        seeds.append((registration.yaw_rotation(yaw),
                      torch.zeros(3, dtype=torch.float32, device=self.device)))
        with span("fpfh", robot=self.robot_id):
            fa = fpfh_ops.fpfh(src, src_mask)
            fb = fpfh_ops.fpfh(dst, dst_mask)
            idx, valid = fpfh_ops.fpfh_correspondences(fa, src_mask, fb,
                                                       dst_mask)
            sync(self.device)
        with span("ransac_3d3d", robot=self.robot_id):
            coarse = ransac_rigid3d(src, dst[idx], valid,
                                    inlier_threshold=4.0 * self.voxel_size,
                                    min_inliers=3)
            seeds.append((coarse.R, coarse.t))
            sync(self.device)

        best = None
        for R0, t0 in seeds:
            with span("gnc_icp", robot=self.robot_id):
                result = host_result(registration.gnc_icp(
                    src, src_mask, dst, dst_mask, R0, t0,
                    max_corr_dist=2.0 * self.voxel_size,
                    max_iters=self.icp_max_iters,
                    iters_per_level=self.icp_iters_per_level))
            self.log_icp_iterations += result.iterations
            if best is None or \
                    (float(result.inlier_frac), -float(result.rmse)) > \
                    (float(best.inlier_frac), -float(best.rmse)):
                best = result
        return best

    def receive_local_descriptors(self, msg: msgs.LocalPointCloudDescriptors):
        """Register the received cloud against each of my matched
        keyframes; publish InterRobotLoopClosures."""
        for rid, kid in zip(msg.matches_robot_id, msg.matches_keyframe_id):
            if rid != self.robot_id:
                continue
            if kid not in self.local_keyframes:
                continue
            result = self._register(msg.points, self.local_keyframes[kid])
            self.log_outcomes["inter", bool(result.success)] += 1
            # _register(src=sender, dst=mine) estimates T mapping sender
            # points into MY frame: T = X_mine^-1 X_sender. The wire
            # convention is pose = X_robot0^-1 X_robot1 with
            # robot0 < robot1
            R, t = result.R, result.t
            if msg.robot_id < self.robot_id:
                # robot0 = sender: need X_sender^-1 X_mine = T^-1
                pose = (R.T, (-R.T @ t).astype(np.float32))
                r0, k0, r1, k1 = msg.robot_id, msg.keyframe_id, rid, kid
            else:
                # robot0 = me: need X_mine^-1 X_sender = T
                pose = (R, t)
                r0, k0, r1, k1 = rid, kid, msg.robot_id, msg.keyframe_id
            self.inter_lc_publisher.publish(
                msgs.InterRobotLoopClosure(
                    robot0_id=r0, robot0_keyframe_id=k0,
                    robot1_id=r1, robot1_keyframe_id=k1,
                    success=bool(result.success),
                    pose=pose,
                    covariance_diag=np.asarray(result.cov_diag,
                                               dtype=np.float32)))

    def receive_local_keyframe_match(self, msg: msgs.LocalKeyframeMatch):
        """Intra-robot match verification."""
        k0, k1 = msg.keyframe0_id, msg.keyframe1_id
        if k0 not in self.local_keyframes or k1 not in self.local_keyframes:
            return
        result = self._register(self.local_keyframes[k0],
                                self.local_keyframes[k1])
        self.log_outcomes["intra", bool(result.success)] += 1
        # _register(src=k0, dst=k1) estimates T = X_1^-1 X_0; the
        # between measurement is X_0^-1 X_1 = T^-1
        R, t = result.R, result.t
        self.intra_lc_publisher.publish(
            msgs.IntraRobotLoopClosure(
                keyframe0_id=k0, keyframe1_id=k1,
                success=bool(result.success),
                pose=(R.T, (-R.T @ t).astype(np.float32)),
                covariance_diag=np.asarray(result.cov_diag,
                                           dtype=np.float32)))
