"""Synthetic swarm world: trajectories, place-dependent descriptors and
a simulated sensor handler for hardware-free runs.

Port of the swarm part of cslam_tpu/frontend/sim.py: `SyntheticWorld`
with the same numpy RNG draw order (one seed gives both packages the
same world), the relative-pose measurement as a plain function
(`measure`), and `SimSensorHandler`, which answers local-descriptor
requests on the bus and verifies candidate loop closures from ground
truth (its per-robot noise stream is `default_rng(robot_id + 7)`, as in
the reference, so noisy measurements match). The world is host-side
numpy; its SE(3) exponentials run on the CPU through the port's se3
ops. `render_corner_scene` renders the corner-rich grey views that the
place-recognition models embed; it makes the reference's RNG draws in
the reference's order, so one seed and pose give the same bytes.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.ops import se3


def _se3_exp_np(xi):
    R, t = se3.se3_exp(torch.as_tensor(np.asarray(xi, np.float32)))
    return R.numpy(), t.numpy()


class SyntheticWorld:
    """Shared ground truth for all robots in a simulated swarm."""

    def __init__(self, n_robots: int, n_poses: int, seed: int = 0,
                 descriptor_dim: int = 32, place_scale: float = 4.0,
                 descriptor_noise: float = 0.05):
        self.n_robots = n_robots
        self.n_poses = n_poses
        self.descriptor_dim = descriptor_dim
        self.place_scale = place_scale
        self.descriptor_noise = descriptor_noise
        rng = np.random.default_rng(seed)
        self._rng = rng
        # random smooth projection from position to descriptor space
        self._proj = rng.standard_normal((3, descriptor_dim)).astype(
            np.float32)
        self._phase = rng.uniform(0, 2 * np.pi, descriptor_dim).astype(
            np.float32)
        self.trajectories: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for rid in range(n_robots):
            self.trajectories[rid] = self._make_trajectory(rid)

    def _make_trajectory(self, rid: int):
        """Overlapping circles, one per robot, offset so they intersect."""
        radius = 8.0 + 0.5 * rid
        center = np.array([2.0 * rid, 1.0 * rid, 0.0])
        ang = 2 * np.pi * np.arange(self.n_poses) / self.n_poses
        pos = center + radius * np.stack(
            [np.cos(ang), np.sin(ang), np.zeros_like(ang)], axis=1)
        yaw = np.stack([np.zeros_like(ang), np.zeros_like(ang),
                        ang + np.pi / 2], axis=1).astype(np.float32)
        Rs = se3.so3_exp(torch.from_numpy(yaw)).numpy().astype(np.float32)
        return Rs, pos.astype(np.float32)

    def descriptor(self, rid: int, kf_id: int) -> np.ndarray:
        """Smooth place-dependent descriptor + per-observation noise."""
        _, ts = self.trajectories[rid]
        pos = ts[kf_id]
        feat = np.sin(pos @ self._proj / self.place_scale + self._phase)
        feat = feat + self._rng.standard_normal(
            self.descriptor_dim).astype(np.float32) * self.descriptor_noise
        return (feat / np.linalg.norm(feat)).astype(np.float32)

    def pose(self, rid: int, kf_id: int):
        Rs, ts = self.trajectories[rid]
        return Rs[kf_id], ts[kf_id]

    def noisy_odometry(self, rid: int, drift: float = 0.0,
                       seed: Optional[int] = None):
        """Integrated odometry with optional per-step drift noise."""
        rng = np.random.default_rng(seed if seed is not None else rid + 100)
        Rs, ts = self.trajectories[rid]
        out_R = [Rs[0]]
        out_t = [ts[0]]
        for k in range(1, len(ts)):
            Rrel = Rs[k - 1].T @ Rs[k]
            trel = Rs[k - 1].T @ (ts[k] - ts[k - 1])
            if drift > 0:
                xi = rng.standard_normal(6).astype(np.float32) * drift
                dR, dt = _se3_exp_np(xi)
                Rrel = Rrel @ dR
                trel = trel + dt
            out_R.append(out_R[-1] @ Rrel)
            out_t.append(out_R[-2] @ trel + out_t[-1])
        return np.stack(out_R), np.stack(out_t)


def measure(world: SyntheticWorld, rid0: int, kf0: int, rid1: int, kf1: int,
            noise: float = 0.0, rng: Optional[np.random.Generator] = None):
    """Ground-truth relative pose of (rid1, kf1) in (rid0, kf0)'s frame,
    with optional tangent-space noise (one 6-vector drawn from `rng`),
    and the true distance between the two — the reference sim handler's
    measurement. Returns (R_rel, t_rel, distance)."""
    R0, t0 = world.pose(rid0, kf0)
    R1, t1 = world.pose(rid1, kf1)
    Rrel = R0.T @ R1
    trel = R0.T @ (t1 - t0)
    if noise > 0:
        xi = rng.standard_normal(6).astype(np.float32) * noise
        dR, dt = _se3_exp_np(xi)
        Rrel = Rrel @ dR
        trel = trel + dt
    dist = float(np.linalg.norm(t1 - t0))
    return Rrel.astype(np.float32), trel.astype(np.float32), dist


class SimSensorHandler:
    """Protocol-level sensor handler for the synthetic world: serves
    local-descriptor requests and verifies loop-closure candidates from
    ground truth (success iff true distance < gate)."""

    def __init__(self, params: Dict, bus, world: SyntheticWorld,
                 verification_gate: float = 5.0,
                 measurement_noise: float = 0.0):
        self.params = params
        self.bus = bus
        self.world = world
        self.robot_id = params["robot_id"]
        self.verification_gate = verification_gate
        self.measurement_noise = measurement_noise
        self._rng = np.random.default_rng(self.robot_id + 7)
        self.local_keyframes: List[int] = []
        # per-verification ground-truth record (this robot verified the
        # pair): success flag + TRUE distance
        self.verification_log: List[Dict] = []

        bus.subscribe("cslam/local_descriptors_request",
                      self.on_local_descriptors_request)
        bus.subscribe("/cslam/sim_local_descriptors",
                      self.on_local_descriptors)
        bus.subscribe("cslam/local_keyframe_match",
                      self.on_local_keyframe_match)
        self.local_descriptors_publisher = bus.create_publisher(
            "/cslam/sim_local_descriptors")
        self.inter_lc_publisher = bus.create_publisher(
            "/cslam/inter_robot_loop_closure")
        self.intra_lc_publisher = bus.create_publisher(
            "cslam/intra_robot_loop_closure")

    def on_local_descriptors_request(self,
                                     req: msgs.LocalDescriptorsRequest):
        """Transmit 'local descriptors' (here: the keyframe id; geometry
        comes from the shared world) to all robots (reference
        rgbd_handler.cpp:561-590)."""
        self.local_descriptors_publisher.publish(
            msgs.LocalDescriptorsRequest(
                keyframe_id=req.keyframe_id * self.world.n_robots +
                self.robot_id,  # encode (rid, kf) in one int
                matches_robot_id=list(req.matches_robot_id),
                matches_keyframe_id=list(req.matches_keyframe_id)))

    def _measure(self, rid0, kf0, rid1, kf1):
        """Ground-truth relative pose with optional noise."""
        return measure(self.world, rid0, kf0, rid1, kf1,
                       self.measurement_noise, self._rng)

    def on_local_descriptors(self, msg: msgs.LocalDescriptorsRequest):
        """Verify each candidate addressed to me (reference
        rgbd_handler.cpp:657-726)."""
        sender_rid = msg.keyframe_id % self.world.n_robots
        sender_kf = msg.keyframe_id // self.world.n_robots
        if sender_rid == self.robot_id:
            return
        for rid, kf in zip(msg.matches_robot_id, msg.matches_keyframe_id):
            if rid != self.robot_id:
                continue
            Rrel, trel, dist = self._measure(sender_rid, sender_kf, rid, kf)
            success = dist < self.verification_gate
            self.verification_log.append(
                {"r0": int(sender_rid), "k0": int(sender_kf),
                 "r1": int(rid), "k1": int(kf),
                 "success": bool(success),
                 "distance": round(float(dist), 3)})
            if sender_rid < rid:
                r0, k0, r1, k1 = sender_rid, sender_kf, rid, kf
                pose = (Rrel, trel)
            else:
                r0, k0, r1, k1 = rid, kf, sender_rid, sender_kf
                pose = (Rrel.T, (-Rrel.T @ trel).astype(np.float32))
            self.inter_lc_publisher.publish(
                msgs.InterRobotLoopClosure(
                    robot0_id=r0, robot0_keyframe_id=k0, robot1_id=r1,
                    robot1_keyframe_id=k1, success=success, pose=pose,
                    covariance_diag=self._measurement_covariance()))

    def on_local_keyframe_match(self, msg: msgs.LocalKeyframeMatch):
        Rrel, trel, dist = self._measure(self.robot_id, msg.keyframe0_id,
                                         self.robot_id, msg.keyframe1_id)
        self.intra_lc_publisher.publish(
            msgs.IntraRobotLoopClosure(
                keyframe0_id=msg.keyframe0_id,
                keyframe1_id=msg.keyframe1_id,
                success=dist < self.verification_gate, pose=(Rrel, trel),
                covariance_diag=self._measurement_covariance()))

    def _measurement_covariance(self):
        """The sim knows its own measurement noise exactly — stamp it as
        the per-factor covariance (the real handlers stamp the
        registration estimate covariance, rgbd_handler.cpp:623/:703)."""
        var = max(self.measurement_noise, 1e-3) ** 2
        return np.full(6, var, dtype=np.float32)


# ----------------------------------------------------------------------
# Visual sim: corner-rich rendered scenes for the learned front-end
# ----------------------------------------------------------------------


def _box_blur3(img):
    out = img.copy()
    out[1:-1, 1:-1] = (
        img[:-2, :-2] + img[:-2, 1:-1] + img[:-2, 2:] +
        img[1:-1, :-2] + img[1:-1, 1:-1] + img[1:-1, 2:] +
        img[2:, :-2] + img[2:, 1:-1] + img[2:, 2:]) / 9.0
    return out


def render_corner_scene(pose, intrinsics, rng, squares_w=None, shades=None,
                        n=36, seed=0, H=120, W=160, square_half_px=8):
    """Render corner-rich squares on the z=5 world plane into the camera
    at `pose` ((R, t) world pose; world->camera = pose^-1), returning
    (uint8 image, float32 depth).

    Mid-gray gradient background, high-contrast axis-aligned squares,
    box blur and sensor noise (the distribution the shipped models were
    trained on). Pass `squares_w`/`shades` ((N, 3) world points at z=5
    and their intensities) to render views of one persistent world;
    otherwise `n` squares are placed from `seed`.
    """
    if squares_w is None:
        blob_rng = np.random.default_rng(seed)
        squares_w = np.stack([blob_rng.uniform(-5.5, 5.5, n),
                              blob_rng.uniform(-4, 4, n),
                              np.full(n, 5.0)], axis=1).astype(np.float32)
        shades = np.where(blob_rng.random(n) < 0.5,
                          blob_rng.uniform(0.0, 0.18, n),
                          blob_rng.uniform(0.82, 1.0, n))
    R, t = pose
    pts_c = (squares_w - t) @ R
    xx, _ = np.meshgrid(np.arange(W), np.arange(H))
    img = (0.5 + 0.1 * (xx / W - 0.5)).astype(np.float32)
    depth = np.full((H, W), 5.0, np.float32)
    order = np.argsort(-pts_c[:, 2])  # paint far to near
    for p, sh in zip(pts_c[order], np.asarray(shades)[order]):
        if p[2] < 0.5:
            continue
        u = int(intrinsics.fx * p[0] / p[2] + intrinsics.cx)
        v = int(intrinsics.fy * p[1] / p[2] + intrinsics.cy)
        h = square_half_px
        if h <= u < W - h and h <= v < H - h:
            img[v - h:v + h, u - h:u + h] = sh
            depth[v - h - 1:v + h + 1, u - h - 1:u + h + 1] = p[2]
    img = _box_blur3(img)
    img += rng.standard_normal((H, W)).astype(np.float32) * 0.02
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), depth
