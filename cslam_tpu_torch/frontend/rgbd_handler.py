"""RGBD/stereo sensor handler: keyframe gating, local features, visual
loop-closure verification.

Port of cslam_tpu/frontend/rgbd_handler.py (the reference RGBDHandler /
StereoHandler): synced-sample queue, local descriptors per frame
(classical corners + patches, or SuperPoint with
`frontend.features: learned`, which loads the shipped weights when no
checkpoint is configured), depth backprojection, keyframe gating,
keyframe + odometry publication, the fp16 LocalImageDescriptors
exchange, and intra/inter-robot verification through mutual matching or
LightGlue, then 3D-3D Kabsch RANSAC or 2D-3D PnP RANSAC
(`frontend.verification_mode`). The time-stamped inputs go through the
C++ approximate-time synchronizer (`runtime/native.NativeSensorSync`).

Device: the feature extraction, the networks, matching and RANSAC run
on `device` (None = the CUDA card; raises without one). As in the
reference, every frame's keypoints, descriptors and 3D points are kept
on the host as numpy (they travel in messages), and each verification's
result comes back to the host: `log_host_copies` counts the
device-to-host copies this costs (one per feature extraction, per
LightGlue match, per RANSAC sample draw and per RANSAC result; each
copies one tensor; the stereo path copies its features and its depths
apart). Host spans (`runtime/tracing.span`) time the stages:
feature_extract (SuperPoint's `superpoint_forward` and
`keypoint_select` inside it), stereo_depth, lightglue_match (args: the
valid and padded keypoint counts of both sides and the layers),
ransac_3d3d, ransac_pnp. Each ends in its host copy, so it holds its
device time. The counter `visual` adds `frames` and `keypoints` (the
detector's valid ones) per frame and `lightglue_pairs` per match.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.ops import features, matching2d, pnp
from cslam_tpu_torch.ops.matching2d import RansacResult
from cslam_tpu_torch.runtime.tracing import span, tracer


@dataclass
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float = 0.0  # stereo only


@dataclass
class LocalKeyframe:
    id: int
    keypoints: np.ndarray    # (K, 2)
    descriptors: np.ndarray  # (K, D)
    points3d: np.ndarray     # (K, 3) camera frame
    mask: np.ndarray         # (K,) detector AND depth validity
    pose: Tuple[np.ndarray, np.ndarray]  # odometry pose at keyframe
    # detector-only validity (keypoints usable as 2D observations even
    # without depth, the PnP mode's query side); None falls back to mask
    feat_mask: Optional[np.ndarray] = None


def host_result(result):
    """A result NamedTuple (RansacResult, RegistrationResult) with its
    tensor fields as numpy arrays, brought over in one copy; other
    fields pass through."""
    tensors = [x for x in result if torch.is_tensor(x)]
    arr = torch.cat([x.reshape(-1).to(torch.float32)
                     for x in tensors]).cpu().numpy()
    out, at = [], 0
    for x in result:
        if torch.is_tensor(x):
            part = arr[at:at + x.numel()].reshape(tuple(x.shape))
            at += x.numel()
            x = part.astype(bool) if x.dtype == torch.bool else part
        out.append(x)
    return type(result)(*out)


class RGBDHandler:

    def __init__(self, params: Dict, bus, clock, max_keypoints: int = 256,
                 device: DeviceLike = None):
        self.params = params
        self.bus = bus
        self.clock = clock
        self.device = resolve_device(device)
        self.robot_id = params["robot_id"]
        self.max_keypoints = max_keypoints
        self.max_queue_size = params.get("frontend.max_queue_size", 10)
        self.keyframe_ratio = params.get(
            "frontend.keyframe_generation_ratio_threshold", 1.0)
        self.min_inliers = params.get("frontend.pnp_min_inliers", 6)
        # "3d3d" | "pnp" | "auto": auto uses 2D-3D PnP RANSAC when the
        # query frame's depth is sparse
        self.verification_mode = params.get(
            "frontend.verification_mode", "auto")
        self.pnp_reproj_px = float(params.get(
            "frontend.pnp_reprojection_error_px", 5.0))
        # "classical" = corners + patch descriptors (ops/features.py);
        # "learned" = SuperPoint extraction + LightGlue matching
        self.features_mode = params.get("frontend.features", "classical")
        self.superpoint = None
        self.lightglue = None
        if self.features_mode == "learned":
            from cslam_tpu_torch.models import zoo
            from cslam_tpu_torch.models.lightglue import LightGlue
            from cslam_tpu_torch.models.superpoint import SuperPoint
            # no explicit checkpoint -> the shipped self-trained weights
            shipped_lg = zoo.shipped_checkpoint("lightglue_synth.npz")
            sp_ckpt = params.get("frontend.superpoint_checkpoint", "") or \
                zoo.shipped_checkpoint("superpoint_synth.npz")
            lg_ckpt = params.get("frontend.lightglue_checkpoint", "") or \
                shipped_lg
            lg_layers = params.get("frontend.lightglue_layers", 0) or (
                zoo.SHIPPED_LIGHTGLUE_LAYERS
                if lg_ckpt == shipped_lg and lg_ckpt else 9)
            self.superpoint = SuperPoint(checkpoint=sp_ckpt,
                                         max_keypoints=max_keypoints,
                                         device=self.device)
            self.lightglue = LightGlue(
                checkpoint=lg_ckpt, num_layers=lg_layers,
                score_threshold=params.get(
                    "frontend.lightglue_score_threshold", 0.1),
                device=self.device)
        self.nb_local_keyframes = 0
        self.local_keyframes: Dict[int, LocalKeyframe] = {}
        self.previous_keyframe: Optional[LocalKeyframe] = None
        self.received_queue: List[Tuple] = []
        self.log_local_descriptors_cumulative_communication = 0
        self.log_host_copies = 0
        self.log_verifications = 0

        self.keyframe_publisher = bus.create_publisher("cslam/keyframe_data")
        self.odom_publisher = bus.create_publisher("cslam/keyframe_odom")
        self.intra_lc_publisher = bus.create_publisher(
            "cslam/intra_robot_loop_closure")
        self.inter_lc_publisher = bus.create_publisher(
            "/cslam/inter_robot_loop_closure")
        self.local_descriptors_publisher = bus.create_publisher(
            "/cslam/local_descriptors")
        bus.subscribe("cslam/local_descriptors_request",
                      self.local_descriptors_request)
        bus.subscribe("/cslam/local_descriptors",
                      self.receive_local_image_descriptors)
        bus.subscribe("cslam/local_keyframe_match",
                      self.receive_local_keyframe_match)

    # -- device helpers --------------------------------------------------
    def _dev(self, x):
        """An f32 host array as a tensor on the handler's device."""
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x), dtype=np.float32)).to(self.device)

    def _host_result(self, result: RansacResult) -> RansacResult:
        # the RANSAC's sample draw copied its validity mask over too
        self.log_host_copies += 2
        return host_result(result)

    # ------------------------------------------------------------------
    def add_sensor_data(self, image: np.ndarray, depth: np.ndarray,
                        intrinsics: CameraIntrinsics,
                        pose: Tuple[np.ndarray, np.ndarray]):
        """Queue one synced (image, depth, odom) sample; drops the oldest
        beyond max_queue_size."""
        self.received_queue.append((image, depth, intrinsics, pose))
        while len(self.received_queue) > self.max_queue_size:
            self.received_queue.pop(0)

    # -- time-stamped path through the C++ synchronizer -----------------
    def _ensure_sync(self, n_streams: int = 2):
        if not hasattr(self, "_sync"):
            from cslam_tpu_torch.runtime.native import NativeSensorSync
            self._sync = NativeSensorSync(
                n_streams=n_streams, slop=0.02,
                max_queue=self.max_queue_size, odom_slop=0.03)
            self._payloads = {}
            self._next_payload = 1

    def close(self):
        """Free the synchronizer (when the time-stamped path made one)."""
        if hasattr(self, "_sync"):
            self._sync.close()

    def _store_payload(self, obj) -> int:
        self._payloads[self._next_payload] = obj
        self._next_payload += 1
        return self._next_payload - 1

    def add_image(self, stamp: float, image: np.ndarray,
                  intrinsics: CameraIntrinsics):
        """Unsynced image stream (approximate-time sync)."""
        self._ensure_sync()
        self._sync.push(0, stamp, self._store_payload((image, intrinsics)))
        self._drain_sync()

    def add_depth(self, stamp: float, depth: np.ndarray):
        self._ensure_sync()
        self._sync.push(1, stamp, self._store_payload(depth))
        self._drain_sync()

    def add_odometry(self, stamp: float,
                     pose: Tuple[np.ndarray, np.ndarray]):
        """Odometry cache for frame alignment."""
        self._ensure_sync()
        self._sync.push_odom(stamp, self._store_payload(pose))

    def _drain_sync(self):
        """Move synchronized (image, depth) pairs with aligned odometry
        into the processing queue."""
        while True:
            taken = self._sync.take()
            if taken is None:
                return
            stamp, (img_id, depth_id) = taken
            image, intrinsics = self._payloads.pop(img_id)
            depth = self._payloads.pop(depth_id)
            odom = self._sync.lookup_odom(stamp)
            if odom is None:
                continue  # no odometry within 30 ms: drop
            pose = self._payloads[odom[0]]
            self.add_sensor_data(image, depth, intrinsics, pose)

    def add_stereo_data(self, left: np.ndarray, disparity: np.ndarray,
                        intrinsics: CameraIntrinsics,
                        pose: Tuple[np.ndarray, np.ndarray]):
        """Stereo path: depth = fx * baseline / disparity."""
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(disparity > 0.1,
                             intrinsics.fx * intrinsics.baseline /
                             np.maximum(disparity, 0.1), 0.0)
        self.add_sensor_data(left, depth.astype(np.float32), intrinsics,
                             pose)

    def _image(self, image):
        """(H, W) f32 image tensor on the device; records (W, H) for
        LightGlue's keypoint normalization (the training convention:
        center at size/2, scale by max/2)."""
        a = np.asarray(image)
        a = a.astype(np.float32) / 255.0 if a.dtype == np.uint8 \
            else a.astype(np.float32)
        img = torch.from_numpy(a).to(self.device)
        if img.ndim == 3:
            img = torch.mean(img, dim=-1)
        self._image_size = (int(img.shape[1]), int(img.shape[0]))
        return img

    def _extract(self, img):
        """(xy, desc, mask) as host numpy from one device image."""
        with span("feature_extract", robot=self.robot_id):
            if self.superpoint is not None:
                xy, desc, _, mask = self.superpoint.extract_features(
                    img, max_keypoints=self.max_keypoints)
            else:
                xy, desc, _, mask = features.extract_features(
                    img, max_keypoints=self.max_keypoints)
            host = torch.cat([xy, desc, mask[:, None]], dim=1).cpu().numpy()
        self.log_host_copies += 1
        tracer.counter("visual", frames=1, keypoints=int(host[:, -1].sum()))
        return (np.ascontiguousarray(host[:, :2]),
                np.ascontiguousarray(host[:, 2:-1]),
                np.ascontiguousarray(host[:, -1]))

    @staticmethod
    def _backproject(xy, z, intrinsics):
        """f32 backprojection on the host (the reference's arithmetic)."""
        return features.backproject(
            torch.from_numpy(xy), torch.from_numpy(z), intrinsics.fx,
            intrinsics.fy, intrinsics.cx, intrinsics.cy).numpy()

    def compute_local_descriptors(self, image, depth,
                                  intrinsics: CameraIntrinsics):
        """Keypoints + descriptors + 3D backprojection."""
        xy, desc, mask = self._extract(self._image(image))
        xs = np.clip(xy[:, 0].astype(np.int32), 0, depth.shape[1] - 1)
        ys = np.clip(xy[:, 1].astype(np.int32), 0, depth.shape[0] - 1)
        z = np.asarray(depth)[ys, xs].astype(np.float32)
        valid_depth = (z > 0.05) & np.isfinite(z)
        feat_mask = mask.astype(np.float32).copy()
        mask = mask * valid_depth
        pts3d = self._backproject(xy, z, intrinsics)
        return xy, desc, pts3d, mask.astype(np.float32), feat_mask

    def _use_pnp(self, mask_b, feat_mask_b, intr_b):
        """"3d3d" never, "pnp" whenever intrinsics are known, "auto" when
        the query side's depth covers less than half its keypoints."""
        mode = self.verification_mode
        if mode == "3d3d" or intr_b is None or float(intr_b[0]) <= 0:
            return False
        if mode == "pnp":
            return True
        denom = max(float(np.sum(feat_mask_b)) if feat_mask_b is not None
                    else float(len(mask_b)), 1.0)
        return float(np.sum(mask_b)) / denom < 0.5

    def _match_learned(self, kf_a: LocalKeyframe, desc_b, xy_b, mask_b):
        with span("lightglue_match", robot=self.robot_id,
                  k0=len(kf_a.mask), k1=len(mask_b),
                  valid0=int(np.count_nonzero(kf_a.mask)),
                  valid1=int(np.count_nonzero(mask_b)),
                  layers=self.lightglue.model.num_layers):
            tracer.counter("visual", lightglue_pairs=1)
            idx1, valid = self.lightglue.match(
                kf_a.descriptors, kf_a.keypoints, kf_a.mask,
                desc_b, xy_b, mask_b,
                size=getattr(self, "_image_size", None))
        self.log_host_copies += 1
        return idx1, valid

    def _verify(self, kf_a: LocalKeyframe, desc_b, pts_b, mask_b, seed=0,
                xy_b=None, feat_mask_b=None, intr_b=None):
        """Match + robust pose estimation; returns (RansacResult as
        numpy, n_matches). The pose maps frame-a points into frame b.
        Matching is LightGlue (learned) or mutual-NN + ratio test;
        alignment is 3D-3D Kabsch RANSAC, or 2D-3D PnP RANSAC when the
        query frame's depth is sparse."""
        self.log_verifications += 1
        use_pnp = xy_b is not None and self._use_pnp(mask_b, feat_mask_b,
                                                    intr_b)
        if use_pnp:
            rays_b = pnp.normalize_keypoints(xy_b, intr_b)
            m2 = feat_mask_b if feat_mask_b is not None else mask_b
            thr = self.pnp_reproj_px / max(float(intr_b[0]), 1e-6)
            if self.lightglue is not None:
                idx1, valid = self._match_learned(kf_a, desc_b, xy_b, m2)
                with span("ransac_pnp", robot=self.robot_id):
                    result = self._host_result(pnp.ransac_pnp(
                        self._dev(kf_a.points3d), self._dev(rays_b[idx1]),
                        self._dev(valid * kf_a.mask), inlier_threshold=thr,
                        min_inliers=self.min_inliers, seed=seed))
                return result, float(valid.sum())
            with span("ransac_pnp", robot=self.robot_id):
                result, n = pnp.verify_keyframe_pair_pnp(
                    self._dev(kf_a.descriptors), self._dev(kf_a.points3d),
                    self._dev(kf_a.mask), self._dev(desc_b),
                    self._dev(rays_b), self._dev(m2), inlier_threshold=thr,
                    min_inliers=self.min_inliers, seed=seed)
                return self._host_result(result), float(n)
        if self.lightglue is not None and xy_b is not None:
            idx1, valid = self._match_learned(kf_a, desc_b, xy_b, mask_b)
            matched = np.asarray(pts_b)[idx1]
            with span("ransac_3d3d", robot=self.robot_id):
                result = self._host_result(matching2d.ransac_rigid3d(
                    self._dev(kf_a.points3d), self._dev(matched),
                    self._dev(valid * kf_a.mask),
                    min_inliers=self.min_inliers, seed=seed))
            return result, float(valid.sum())
        with span("ransac_3d3d", robot=self.robot_id):
            result, n = matching2d.verify_keyframe_pair(
                self._dev(kf_a.descriptors), self._dev(kf_a.points3d),
                self._dev(kf_a.mask), self._dev(desc_b), self._dev(pts_b),
                self._dev(mask_b), min_inliers=self.min_inliers, seed=seed)
            return self._host_result(result), float(n)

    def generate_new_keyframe(self, candidate: LocalKeyframe) -> bool:
        """Keyframe when tracking against the previous keyframe is weak."""
        if self.keyframe_ratio >= 1.0 or self.previous_keyframe is None:
            return True
        result, _ = self._verify(self.previous_keyframe,
                                 candidate.descriptors,
                                 candidate.points3d, candidate.mask,
                                 xy_b=candidate.keypoints,
                                 feat_mask_b=candidate.feat_mask,
                                 intr_b=getattr(self, "_intrinsics", None))
        n_valid = max(float(np.asarray(candidate.mask).sum()), 1.0)
        return float(result.num_inliers) / n_valid < self.keyframe_ratio

    def process_new_sensor_data(self):
        """Processing tick: newest frame wins, stale ones drop."""
        if not self.received_queue:
            return None
        image, depth, intrinsics, pose = self.received_queue.pop()
        self.received_queue.clear()
        xy, desc, pts3d, mask, feat_mask = self.compute_local_descriptors(
            image, depth, intrinsics)
        # camera parameters ride along with local descriptors so
        # receivers can run depth-free PnP verification
        self._intrinsics = (float(intrinsics.fx), float(intrinsics.fy),
                            float(intrinsics.cx), float(intrinsics.cy))
        candidate = LocalKeyframe(self.nb_local_keyframes, xy, desc, pts3d,
                                  mask, pose, feat_mask=feat_mask)
        if not self.generate_new_keyframe(candidate):
            return None
        self.local_keyframes[candidate.id] = candidate
        self.previous_keyframe = candidate
        self.nb_local_keyframes += 1
        self.send_keyframe(candidate, image)
        return candidate.id

    def send_keyframe(self, kf: LocalKeyframe, image):
        """Publish keyframe image + odometry."""
        self.keyframe_publisher.publish(
            msgs.KeyframeRGB.from_image(kf.id, np.asarray(image)))
        self.odom_publisher.publish(
            msgs.KeyframeOdom(id=kf.id, pose=kf.pose))

    # ------------------------------------------------------------------
    def local_descriptors_request(self, request):
        """Broadcast fp16 local descriptors."""
        kf = self.local_keyframes.get(request.keyframe_id)
        if kf is None:
            return
        msg = msgs.LocalImageDescriptors(
            robot_id=self.robot_id, keyframe_id=kf.id,
            matches_robot_id=list(request.matches_robot_id),
            matches_keyframe_id=list(request.matches_keyframe_id),
            keypoints=kf.keypoints,
            descriptors=kf.descriptors.astype(np.float16),
            points3d=kf.points3d,
            valid3d=np.asarray(kf.mask, dtype=np.float32),
            valid2d=np.asarray(
                kf.feat_mask if kf.feat_mask is not None else kf.mask,
                dtype=np.float32),
            intrinsics=getattr(self, "_intrinsics", (0.0, 0.0, 0.0, 0.0)))
        self.local_descriptors_publisher.publish(msg)
        # comm accounting (28 B/kpt + 12 B/pt + 2 B/descriptor value)
        self.log_local_descriptors_cumulative_communication += (
            28 * len(kf.keypoints) + 12 * len(kf.points3d) +
            kf.descriptors.size * 2)

    def receive_local_image_descriptors(self,
                                        msg: msgs.LocalImageDescriptors):
        """Verify candidates addressed to me. With classical features all
        targeted keyframes go through one batched pipeline; the learned
        path (LightGlue) is per pair."""
        if msg.robot_id == self.robot_id:
            return
        targets = [(kid, self.local_keyframes[kid])
                   for rid, kid in zip(msg.matches_robot_id,
                                       msg.matches_keyframe_id)
                   if rid == self.robot_id and kid in self.local_keyframes]
        if not targets:
            return
        K = len(msg.points3d)
        mask_b = (np.asarray(msg.valid3d, dtype=np.float32)
                  if len(msg.valid3d) == K
                  else np.ones(K, dtype=np.float32))
        feat_mask_b = (np.asarray(msg.valid2d, dtype=np.float32)
                       if len(msg.valid2d) == K else mask_b)
        intr_b = msg.intrinsics
        desc_b = msg.descriptors.astype(np.float32)
        use_pnp = self._use_pnp(mask_b, feat_mask_b, intr_b)
        if self.lightglue is None and len(targets) > 1:
            self.log_verifications += len(targets)
            stack = [self._dev(np.stack([getattr(kf, f) for _, kf in
                                         targets]))
                     for f in ("descriptors", "points3d", "mask")]
            if use_pnp:
                rays_b = pnp.normalize_keypoints(msg.keypoints, intr_b)
                thr = self.pnp_reproj_px / max(float(intr_b[0]), 1e-6)
                with span("ransac_pnp", robot=self.robot_id):
                    batch_res, _ = pnp.verify_keyframe_pairs_pnp(
                        *stack, self._dev(desc_b), self._dev(rays_b),
                        self._dev(feat_mask_b), inlier_threshold=thr,
                        min_inliers=self.min_inliers)
                    batch_res = self._host_result(batch_res)
            else:
                with span("ransac_3d3d", robot=self.robot_id):
                    batch_res, _ = matching2d.verify_keyframe_pairs(
                        *stack, self._dev(desc_b), self._dev(msg.points3d),
                        self._dev(mask_b), min_inliers=self.min_inliers)
                    batch_res = self._host_result(batch_res)
            results = [RansacResult(*(x[b] for x in batch_res))
                       for b in range(len(targets))]
        else:
            results = []
            for _, kf in targets:
                result, _ = self._verify(kf, desc_b, msg.points3d, mask_b,
                                         xy_b=msg.keypoints,
                                         feat_mask_b=feat_mask_b,
                                         intr_b=intr_b)
                results.append(result)
        for (kid, kf), result in zip(targets, results):
            # the estimated T maps my points into the sender's frame:
            # T = X_sender^-1 X_mine
            R_mine_to_sender = np.asarray(result.R)
            t_mine_to_sender = np.asarray(result.t)
            if msg.robot_id < self.robot_id:
                # robot0 = sender: X_sender^-1 X_mine = T
                pose = (R_mine_to_sender, t_mine_to_sender)
                r0, k0, r1, k1 = msg.robot_id, msg.keyframe_id, \
                    self.robot_id, kid
            else:
                # robot0 = me: X_mine^-1 X_sender = T^-1
                pose = (R_mine_to_sender.T,
                        (-R_mine_to_sender.T @ t_mine_to_sender).astype(
                            np.float32))
                r0, k0, r1, k1 = self.robot_id, kid, msg.robot_id, \
                    msg.keyframe_id
            self.inter_lc_publisher.publish(
                msgs.InterRobotLoopClosure(
                    robot0_id=r0, robot0_keyframe_id=k0, robot1_id=r1,
                    robot1_keyframe_id=k1, success=bool(result.success),
                    pose=pose,
                    # the registration covariance rides to the back-end;
                    # its diagonal is kept as-is under inversion
                    covariance_diag=np.asarray(result.cov_diag,
                                               dtype=np.float32)))

    def receive_local_keyframe_match(self, msg: msgs.LocalKeyframeMatch):
        """Intra-robot verification."""
        kf0 = self.local_keyframes.get(msg.keyframe0_id)
        kf1 = self.local_keyframes.get(msg.keyframe1_id)
        if kf0 is None or kf1 is None:
            return
        result, _ = self._verify(kf0, kf1.descriptors, kf1.points3d,
                                 kf1.mask, xy_b=kf1.keypoints,
                                 feat_mask_b=kf1.feat_mask,
                                 intr_b=getattr(self, "_intrinsics", None))
        # T maps kf0 camera points into kf1's frame: T = X_1^-1 X_0; the
        # between measurement X_0^-1 X_1 = T^-1
        R = np.asarray(result.R)
        t = np.asarray(result.t)
        self.intra_lc_publisher.publish(
            msgs.IntraRobotLoopClosure(
                keyframe0_id=msg.keyframe0_id,
                keyframe1_id=msg.keyframe1_id,
                success=bool(result.success),
                pose=(R.T, (-R.T @ t).astype(np.float32)),
                covariance_diag=np.asarray(result.cov_diag,
                                           dtype=np.float32)))


class _RightImage:
    """Marker wrapper distinguishing a rectified right image from a
    dense depth map in the shared processing queue."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data


@dataclass
class CameraInfo:
    """Projection-matrix view of a camera info message: fx..cy from K,
    tx = P(0,3) (the right camera of a rectified pair carries the
    baseline as -tx/fx)."""
    fx: float
    fy: float
    cx: float
    cy: float
    tx: float = 0.0
    width: int = 0
    height: int = 0


class StereoHandler(RGBDHandler):
    """Stereo variant: 4-way approximate-time sync of left/right images
    and camera infos through the same C++ synchronizer; the stereo
    camera model with the reference's checks (baseline = -P_right(0,3) /
    P_right(0,0), a configured fallback when Tx is unset, an error on a
    non-positive baseline, a once-only warning above 10 m); encoding
    validation; keypoint depth from batched scan-line ZNCC
    (ops/stereo.py) instead of a dense depth image."""

    def __init__(self, params: Dict, bus, clock, max_keypoints: int = 256,
                 device: DeviceLike = None):
        super().__init__(params, bus, clock, max_keypoints=max_keypoints,
                         device=device)
        self.camera_model: Optional[CameraIntrinsics] = None
        self.max_disparity = int(params.get(
            "frontend.stereo_max_disparity", 64))
        self.min_zncc = params.get("frontend.stereo_min_zncc", 0.6)
        self._warned_large_baseline = False
        self._warned_fallback_baseline = False
        self.log_dropped_frames = 0

    # -- camera model ---------------------------------------------------
    def stereo_camera_model(self, left: CameraInfo,
                            right: CameraInfo) -> Optional[CameraIntrinsics]:
        """Build and validate the stereo camera model."""
        baseline = -right.tx / right.fx if right.fx else 0.0
        if baseline == 0.0:
            fallback = float(self.params.get(
                "frontend.stereo_baseline_fallback", 0.0))
            if fallback > 0.0:
                if not self._warned_fallback_baseline:
                    self._log_warn(
                        "Right camera info doesn't have Tx set; using the "
                        f"configured fallback baseline ({fallback} m). It is "
                        "preferred to feed a valid right camera info. This "
                        "message is only printed once...")
                    self._warned_fallback_baseline = True
                baseline = fallback
        if baseline <= 0.0:
            self._log_error(
                f"The stereo baseline ({baseline}) should be positive "
                "(baseline=-Tx/fx). We assume a horizontal left/right "
                "stereo setup where the Tx (or P(0,3)) is negative in the "
                "right camera info msg.")
            return None
        if baseline > 10.0 and not self._warned_large_baseline:
            self._log_warn(
                f"Detected baseline ({baseline} m) is quite large! Is your "
                "right camera_info P(0,3) correctly set? Note that "
                "baseline=-P(0,3)/P(0,0). This warning is printed only "
                "once.")
            self._warned_large_baseline = True
        return CameraIntrinsics(fx=left.fx, fy=left.fy, cx=left.cx,
                                cy=left.cy, baseline=baseline)

    def _log_warn(self, text):
        print(f"[stereo_handler r{self.robot_id}] WARN: {text}")

    def _log_error(self, text):
        print(f"[stereo_handler r{self.robot_id}] ERROR: {text}")

    @staticmethod
    def _validate_image(img) -> Optional[np.ndarray]:
        """Accepted encodings: mono/rgb/rgba (2-D, or 3-D with 1/3/4
        channels), u8/u16/float. Returns a mono float32 [0, 1] image or
        None."""
        a = np.asarray(img)
        if a.ndim == 3 and a.shape[2] in (1, 3, 4):
            a = a[..., :3].mean(axis=2) if a.shape[2] >= 3 else a[..., 0]
        elif a.ndim != 2:
            return None
        if a.dtype == np.uint8:
            return a.astype(np.float32) / 255.0
        if a.dtype == np.uint16:
            return a.astype(np.float32) / 65535.0
        if np.issubdtype(a.dtype, np.floating):
            return a.astype(np.float32)
        return None

    # -- 4-way synchronized streams ------------------------------------
    _STREAM_LEFT, _STREAM_RIGHT, _STREAM_LINFO, _STREAM_RINFO = range(4)

    def _ensure_sync(self, n_streams: int = 4):
        super()._ensure_sync(n_streams=4)

    def _push(self, stream, stamp, obj):
        self._ensure_sync()
        self._sync.push(stream, stamp, self._store_payload(obj))
        self._drain_sync()

    def add_left_image(self, stamp: float, image: np.ndarray):
        self._push(self._STREAM_LEFT, stamp, image)

    def add_right_image(self, stamp: float, image: np.ndarray):
        self._push(self._STREAM_RIGHT, stamp, image)

    def add_camera_info_left(self, stamp: float, info: CameraInfo):
        self._push(self._STREAM_LINFO, stamp, info)

    def add_camera_info_right(self, stamp: float, info: CameraInfo):
        self._push(self._STREAM_RINFO, stamp, info)

    def _drain_sync(self):
        """4-tuple (left, right, left_info, right_info) + aligned
        odometry -> processing queue."""
        while True:
            taken = self._sync.take()
            if taken is None:
                return
            stamp, ids = taken
            left = self._payloads.pop(ids[self._STREAM_LEFT])
            right = self._payloads.pop(ids[self._STREAM_RIGHT])
            linfo = self._payloads.pop(ids[self._STREAM_LINFO])
            rinfo = self._payloads.pop(ids[self._STREAM_RINFO])
            odom = self._sync.lookup_odom(stamp)
            if odom is None:
                continue
            pose = self._payloads[odom[0]]
            self.add_stereo_pair(left, right, pose, left_info=linfo,
                                 right_info=rinfo)

    # -- direct (pre-synced) entry -------------------------------------
    def add_stereo_pair(self, left: np.ndarray, right: np.ndarray,
                        pose: Tuple[np.ndarray, np.ndarray],
                        left_info: Optional[CameraInfo] = None,
                        right_info: Optional[CameraInfo] = None):
        """One rectified pair. The camera model is built from the first
        valid info pair and reused afterwards."""
        lm = self._validate_image(left)
        rm = self._validate_image(right)
        if lm is None or rm is None:
            self._log_error(
                "Input type must be image=mono8,mono16,rgb8,bgr8,rgba8,"
                f"bgra8 (mono8 recommended), received shapes "
                f"{np.shape(left)} / {np.shape(right)}")
            self.log_dropped_frames += 1
            return
        if self.camera_model is None and left_info is not None \
                and right_info is not None:
            self.camera_model = self.stereo_camera_model(left_info,
                                                         right_info)
        if self.camera_model is None:
            self.log_dropped_frames += 1
            return
        self.add_sensor_data(lm, _RightImage(rm), self.camera_model, pose)

    def send_keyframe(self, kf: LocalKeyframe, image):
        """Publish the keyframe with its left image in 8 bits: a validated
        image is float in [0, 1], and KeyframeRGB carries uint8 (a float
        image cast as it is would read 0 everywhere)."""
        img = np.asarray(image)
        if np.issubdtype(img.dtype, np.floating):
            img = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        super().send_keyframe(kf, img)

    # -- keypoint depth from stereo matching ---------------------------
    def compute_local_descriptors(self, image, right,
                                  intrinsics: CameraIntrinsics):
        """Keypoints on the LEFT image; per-keypoint depth from the
        batched scan-line correspondence. Dense-depth samples (the
        precomputed-disparity `add_stereo_data` path) fall through to
        the RGBD pipeline."""
        if not isinstance(right, _RightImage):
            return super().compute_local_descriptors(image, right,
                                                     intrinsics)
        from cslam_tpu_torch.ops import stereo as stereo_ops
        img = self._image(image)
        with span("feature_extract", robot=self.robot_id):
            if self.superpoint is not None:
                xy, desc, _, mask = self.superpoint.extract_features(
                    img, max_keypoints=self.max_keypoints)
            else:
                xy, desc, _, mask = features.extract_features(
                    img, max_keypoints=self.max_keypoints)
            host = torch.cat([xy, desc, mask[:, None]], dim=1).cpu().numpy()
        feat_mask = np.ascontiguousarray(host[:, -1])
        tracer.counter("visual", frames=1,
                       keypoints=int(np.count_nonzero(feat_mask)))
        with span("stereo_depth", robot=self.robot_id):
            disparity, dvalid = stereo_ops.stereo_correspondences(
                img, self._dev(right.data), xy, mask,
                max_disparity=self.max_disparity, min_zncc=self.min_zncc)
            z = stereo_ops.depth_from_disparity(
                disparity, dvalid, intrinsics.fx, intrinsics.baseline)
            depth = torch.stack([dvalid, z], dim=1).cpu().numpy()
        self.log_host_copies += 2
        xy = np.ascontiguousarray(host[:, :2])
        desc = np.ascontiguousarray(host[:, 2:-1])
        mask = feat_mask * depth[:, 0]
        pts3d = self._backproject(xy, np.ascontiguousarray(depth[:, 1]),
                                  intrinsics)
        return xy, desc, pts3d, mask.astype(np.float32), feat_mask
