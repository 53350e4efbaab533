"""Sim front-end: synthetic place descriptors along the route.

The recording: every robot's true poses along its loop (`route.Route`, a
keyframe every `keyframe_spacing_m`), its drifted odometry, and one
descriptor per keyframe, a smooth function of the position plus
per-observation noise (the synthetic world of the port's sim mission,
at the configured width):

    d = normalize(sin(p @ P / place_scale + phase) + noise * n)

with P (3, D) and the phases drawn once from the seed. Places closer
than about a place scale give similar descriptors; far ones do not.

The swarm: per robot a `SwarmNode` and a `SimSensorHandler`, which
verifies a candidate from the true poses (success iff the true distance
is under the gate). Step s feeds every robot keyframe s: its descriptor
into the node's detector, then its odometry on the bus.
"""

import numpy as np

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.config import default_params
from cslam_tpu_torch.frontend.sim import SimSensorHandler
from cslam_tpu_torch.node import SwarmNode

from swarmbench.route import Route, drifted_odometry


class Recording:
    """Host arrays of one mission, made from the seed."""

    def __init__(self, config, traffic, seed: int):
        n = int(config["robots"])
        spacing = float(config["keyframe_spacing_m"])
        share = float(traffic["revisit_share"])
        self.n_robots = n
        self.route = Route(n, float(config["route_length_m"]) / n,
                           float(traffic["street_share"]), share > 0,
                           spacing, float(config["lane_offset_m"]))
        if share > 0 and share != traffic["street_share"]:
            raise ValueError("revisit_share is 0 or the street share")
        self.n_steps = min(len(t) for t in self.route.t)
        self.dt = spacing / float(config["speed_m_per_s"])
        rng = np.random.default_rng([int(seed), 0x51A])
        dim = int(config["descriptor_dim"])
        self.proj = rng.standard_normal((3, dim))
        self.phase = rng.uniform(0.0, 2.0 * np.pi, dim)
        sr, st = config["odometry_sigma"]
        self.desc, self.odom = [], []
        for r in range(n):
            R, t = self.route.R[r][:self.n_steps], self.route.t[r][:self.n_steps]
            feat = np.sin(t @ self.proj / float(config["place_scale_m"])
                          + self.phase)
            feat += rng.standard_normal(feat.shape) * float(
                config["descriptor_noise"])
            feat /= np.linalg.norm(feat, axis=1, keepdims=True)
            self.desc.append(feat.astype(np.float32))
            oR, ot = drifted_odometry(R, t, float(sr), float(st), rng)
            self.odom.append((oR.astype(np.float32), ot.astype(np.float32)))
        self.true_R = [R[:self.n_steps].astype(np.float32)
                       for R in self.route.R]
        self.true_t = [t[:self.n_steps].astype(np.float32)
                       for t in self.route.t]

    def descriptor(self, robot: int, kf: int) -> np.ndarray:
        return self.desc[robot][kf]


class _World:
    """What SimSensorHandler reads of the world: robot count and true
    poses."""

    def __init__(self, rec: Recording):
        self.rec = rec
        self.n_robots = rec.n_robots

    def pose(self, rid, kf_id):
        return self.rec.true_R[rid][kf_id], self.rec.true_t[rid][kf_id]


class _NoModel:
    """Descriptors come from the recording: the detector needs no model."""

    def compute_embedding(self, _):
        raise RuntimeError("the sim front-end feeds descriptors")


def make_recording(config, traffic, seed):
    return Recording(config, traffic, seed)


def node_params(config, rid):
    params = default_params(robot_id=rid, max_nb_robots=int(config["robots"]))
    params.update(config["settings"])
    return params


class Swarm:
    def __init__(self, config, rec: Recording, device):
        self.rec = rec
        self.router = InProcessRouter()
        self.clock = ManualClock()
        self.nodes, self.handlers = {}, {}
        world = _World(rec)
        try:
            for rid in range(rec.n_robots):
                bus = InProcessBus(self.router, rid)
                params = node_params(config, rid)
                self.nodes[rid] = SwarmNode(params, bus, self.clock,
                                            descriptor_model=_NoModel(),
                                            device=device)
                self.handlers[rid] = SimSensorHandler(
                    params, bus, world,
                    verification_gate=float(config["verification_gate_m"]))
        except BaseException:
            self.close()
            raise

    def feed(self, step: int):
        """Keyframe `step` of every robot: [(robot, kf, recording index)]."""
        rec = self.rec
        for rid, node in self.nodes.items():
            node.detection.add_global_descriptor_to_map(rec.desc[rid][step],
                                                        step)
            node.bus.publish("cslam/keyframe_odom", msgs.KeyframeOdom(
                id=step, pose=(rec.odom[rid][0][step],
                               rec.odom[rid][1][step])))
        self.router.spin_until_idle(max_rounds=2000)
        return [(rid, step, step) for rid in self.nodes]

    def close(self):
        for node in self.nodes.values():
            node.close()


def build_swarm(config, traffic, rec, device):
    return Swarm(config, rec, device)
