"""Synthetic swarm world: trajectories, place-dependent descriptors and
simulated loop-closure measurements for hardware-free runs.

Port of the device-free part of cslam_tpu/frontend/sim.py:
`SyntheticWorld` with the same numpy RNG draw order (one seed gives both
packages the same world), and the relative-pose measurement of the
reference's `SimSensorHandler._measure` as a plain function. The bus
handler itself belongs to the protocol layer, which this port does not
hold yet. The world is host-side numpy; its SE(3) exponentials run on
the CPU through the port's se3 ops.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
