"""Lidar front-end: scans of a building world along the route.

The recording: every robot's true poses along its loop (`route.Route`,
a frame every speed / rate metres), its drifted odometry, and a world of
box buildings along every street (the port's lidar mission's
`LidarWorld`, box-like point clusters on the ground, laid along the
route): on each side of a street, every `building_spacing_m`, a box
whose walls carry points, and ground points in a band around the street.
A scan is every world point within `sensor_range_m` of the sensor, in
the sensor frame, with Gaussian noise, in a random order (so the
handler's first `capacity` points are a uniform sample); its noise and
order come from the seed, the robot and the frame, so the reference
regenerates any scan.

The swarm: per robot a `LidarHandler` (keyframe gate, voxel grid,
registration) and a `SwarmNode` with the Scan Context place model. Step
s feeds frame s of every robot to its handler, which keeps it as a
keyframe when the odometry moved far enough.

Numbers compared (`checks`):
- voxel_err: for a sample of keyframes, the largest distance from a
  point of the handler's keyframe cloud to the nearest centroid of the
  reference's voxel grid of the same raw scan, and back.
- reg_inlier_err, reg_rmse_err: for every registration (or a sample),
  how far the inlier fraction (and inlier RMSE, relative) the handler
  reports lies outside the range that the exact fit of the returned
  transform on the reference's own keyframe clouds allows under float32
  evaluation (`reference.fit_error`). The verdict is that fraction over
  0.3, so the fraction's gap judges it too.
- reg_truth_err_m: for every accepted registration of the same sample
  whose two scans are a true revisit (sensors within `revisit_gate_m` of
  each other on the route), the largest distance, over the points of
  the reference's source cloud, between the point moved by the returned
  transform and by the true relative pose of the two scans
  (`reference.truth_error`). Registrations of scans farther apart are
  not judged on it: the handler's verdict is not meant to reject every
  false match (the back-end's GNC rejects what it lets through). TF32
  moves no transform that far, so the control puts the identity in the
  program's place: an ICP that never moved reads the scans' true offset.
"""

import numpy as np

from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.config import default_params
from cslam_tpu_torch.frontend.lidar_handler import LidarHandler, \
    ScanContextModel
from cslam_tpu_torch.node import SwarmNode

from swarmbench import reference as ref
from swarmbench.route import Route, drifted_odometry

TILE_M = 20.0


class World:
    """Building and ground points along the route's streets, bucketed in
    square tiles for range queries."""

    def __init__(self, config, route: Route, rng: np.random.Generator):
        w = config["world"]
        pts = []
        for poly in route.street_polylines():
            pts.append(self._buildings(poly, w, rng))
            pts.append(self._ground(poly, w, rng))
        self.points = np.concatenate(pts).astype(np.float32)
        key = np.floor(self.points[:, :2] / TILE_M).astype(np.int64)
        order = np.lexsort((key[:, 1], key[:, 0]))
        self.points = self.points[order]
        key = key[order]
        self.tiles = {}
        change = np.nonzero(np.any(np.diff(key, axis=0) != 0, axis=1))[0] + 1
        for lo, hi in zip(np.concatenate([[0], change]),
                          np.concatenate([change, [len(key)]])):
            self.tiles[tuple(key[lo])] = (lo, hi)
        self.range = float(config["sensor_range_m"])
        self.height = float(config["sensor_height_m"])
        self.noise = float(config["scan_noise_m"])

    @staticmethod
    def _along(poly, spacing, rng):
        """Points every ~spacing metres along a polyline, with the unit
        direction there."""
        seg = np.linalg.norm(np.diff(poly, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        s = np.arange(spacing / 2, cum[-1], spacing)
        s = s + rng.uniform(-0.2, 0.2, len(s)) * spacing
        s = np.clip(s, 0.0, cum[-1])
        x = np.interp(s, cum, poly[:, 0])
        y = np.interp(s, cum, poly[:, 1])
        dx = np.interp(np.minimum(s + 0.5, cum[-1]), cum, poly[:, 0]) - \
            np.interp(np.maximum(s - 0.5, 0.0), cum, poly[:, 0])
        dy = np.interp(np.minimum(s + 0.5, cum[-1]), cum, poly[:, 1]) - \
            np.interp(np.maximum(s - 0.5, 0.0), cum, poly[:, 1])
        d = np.stack([dx, dy], axis=1)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        return np.stack([x, y], axis=1), d

    def _buildings(self, poly, w, rng):
        centre, d = self._along(poly, float(w["building_spacing_m"]), rng)
        normal = np.stack([-d[:, 1], d[:, 0]], axis=1)
        out = []
        for side in (-1.0, 1.0):
            for c, u, v in zip(centre, d, normal * side):
                if rng.random() >= w["building_presence"]:
                    continue
                off = rng.uniform(*w["building_offset_m"])
                size = rng.uniform(*w["building_size_m"], 2)
                height = rng.uniform(*w["building_height_m"])
                mid = c + v * (off + size[1] / 2)
                per = 2 * (size[0] + size[1])
                n = int(w["wall_density"] * per * height)
                along = rng.uniform(0.0, per, n)
                z = rng.uniform(0.0, height, n)
                a, b = size[0] / 2, size[1] / 2
                # walk the rectangle's perimeter
                p = np.empty((n, 2))
                e1 = along < 2 * a
                e2 = (~e1) & (along < 2 * a + 2 * b)
                e3 = (~e1) & (~e2) & (along < 4 * a + 2 * b)
                e4 = ~(e1 | e2 | e3)
                p[e1] = np.stack([-a + along[e1], np.full(e1.sum(), -b)], 1)
                p[e2] = np.stack([np.full(e2.sum(), a),
                                  -b + along[e2] - 2 * a], 1)
                p[e3] = np.stack([a - (along[e3] - 2 * a - 2 * b),
                                  np.full(e3.sum(), b)], 1)
                p[e4] = np.stack([np.full(e4.sum(), -a),
                                  b - (along[e4] - 4 * a - 2 * b)], 1)
                xy = mid + p[:, :1] * u + p[:, 1:] * v
                out.append(np.concatenate([xy, z[:, None]], axis=1))
        return np.concatenate(out) if out else np.zeros((0, 3))

    def _ground(self, poly, w, rng):
        band = float(w["ground_band_m"])
        seg = np.linalg.norm(np.diff(poly, axis=0), axis=1).sum()
        n = int(w["ground_density"] * seg * 2 * band)
        centre, d = self._along(poly, seg / max(n, 1), rng)
        normal = np.stack([-d[:, 1], d[:, 0]], axis=1)
        lat = rng.uniform(-band, band, len(centre))[:, None]
        xy = centre + normal * lat
        return np.concatenate([xy, np.zeros((len(xy), 1))], axis=1)

    def scan(self, R, t, rng: np.random.Generator) -> np.ndarray:
        """The scan from a sensor at the ground pose (R, t)."""
        lo = np.floor((t[:2] - self.range) / TILE_M).astype(int)
        hi = np.floor((t[:2] + self.range) / TILE_M).astype(int)
        parts = []
        for i in range(lo[0], hi[0] + 1):
            for j in range(lo[1], hi[1] + 1):
                span = self.tiles.get((i, j))
                if span is not None:
                    parts.append(self.points[span[0]:span[1]])
        pts = np.concatenate(parts) if parts else np.zeros((0, 3), np.float32)
        near = np.sum((pts[:, :2] - t[None, :2]) ** 2, axis=1) < \
            self.range ** 2
        pts = pts[near]
        origin = np.array([t[0], t[1], self.height], dtype=np.float32)
        local = (pts - origin) @ R.astype(np.float32)
        local += rng.standard_normal(local.shape, dtype=np.float32) * \
            np.float32(self.noise)
        return local[rng.permutation(len(local))]


class Recording:
    def __init__(self, config, traffic, seed: int):
        n = int(config["robots"])
        spacing = float(config["speed_m_per_s"]) / float(config["frame_rate_hz"])
        share = float(traffic["revisit_share"])
        if share > 0 and share != traffic["street_share"]:
            raise ValueError("revisit_share is 0 or the street share")
        self.n_robots = n
        self.seed = int(seed)
        self.route = Route(n, float(config["route_length_m"]) / n,
                           float(traffic["street_share"]), share > 0,
                           spacing, float(config["lane_offset_m"]),
                           bool(config.get("same_direction", False)),
                           config.get("start_offset_m"))
        self.n_steps = min(len(t) for t in self.route.t)
        self.dt = 1.0 / float(config["frame_rate_hz"])
        self.world = World(config, self.route, np.random.default_rng(
            int(config["world_seed"])))
        rng = np.random.default_rng([self.seed, 0x11DA])
        sr, st = config["odometry_sigma"]
        self.odom = []
        for r in range(n):
            R, t = self.route.R[r], self.route.t[r]
            oR, ot = drifted_odometry(R, t, float(sr), float(st), rng)
            self.odom.append((oR.astype(np.float32), ot.astype(np.float32)))

    def scan(self, robot: int, frame: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 0x5CA7, robot, frame])
        return self.world.scan(self.route.R[robot][frame],
                               self.route.t[robot][frame], rng)

    def sensor_pose(self, robot: int, frame: int):
        """(R, origin) of the scan's sensor frame in the world, float64."""
        t = self.route.t[robot][frame]
        return self.route.R[robot][frame], np.array(
            [t[0], t[1], self.world.height])


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
        self.cloud_keys = {}
        self.records = None
        self.pass_index = None
        cap = int(config["capacity"])
        try:
            for rid in range(rec.n_robots):
                bus = InProcessBus(self.router, rid)
                params = node_params(config, rid)
                self.handlers[rid] = LidarHandler(params, bus, self.clock,
                                                  capacity=cap, device=device)
                self.nodes[rid] = SwarmNode(
                    params, bus, self.clock,
                    descriptor_model=ScanContextModel(device=device),
                    device=device)
        except BaseException:
            self.close()
            raise

    def feed(self, step: int):
        """Frame `step` of every robot: [(robot, kf, frame)] of the
        frames kept as keyframes."""
        rec = self.rec
        taken = []
        for rid, handler in self.handlers.items():
            handler.add_sensor_data(rec.scan(rid, step),
                                    (rec.odom[rid][0][step],
                                     rec.odom[rid][1][step]))
            kf = handler.process_new_sensor_data()
            if kf is not None:
                cloud = handler.local_keyframes[kf]
                self.cloud_keys[id(cloud)] = (rid, kf)
                if self.records is not None:
                    self.records.clouds[self.pass_index, rid, kf] = cloud
                taken.append((rid, kf, step))
        self.router.spin_until_idle(max_rounds=2000)
        return taken

    def close(self):
        for node in self.nodes.values():
            node.close()


def build_swarm(config, traffic, rec, device):
    return Swarm(config, rec, device)


def instrument(swarm: Swarm, records, pass_index):
    """Keep every keyframe cloud and every registration's answer."""
    if not hasattr(records, "clouds"):
        records.clouds = {}
    swarm.records, swarm.pass_index = records, pass_index
    for rid, handler in swarm.handlers.items():
        register = handler._register

        def registered(src, dst, _reg=register):
            res = _reg(src, dst)
            records.registrations.append({
                "pass": pass_index, "src": swarm.cloud_keys.get(id(src)),
                "dst": swarm.cloud_keys.get(id(dst)),
                "R": np.asarray(res.R), "t": np.asarray(res.t),
                "rmse": float(res.rmse), "frac": float(res.inlier_frac),
                "success": bool(res.success)})
            return res
        handler._register = registered


def warm_up(swarm: Swarm, rec, device):
    """One registration of two keyframe clouds, so the registration's
    shapes have run before the window."""
    h = swarm.handlers[0]
    kfs = sorted(h.local_keyframes)
    if len(kfs) >= 2:
        h._register(h.local_keyframes[kfs[-1]], h.local_keyframes[kfs[-2]])


def checks(run, control, rng):
    cfg = run.cell.config
    traffic = run.cell.traffic
    recs = run.records
    voxel = float(cfg["settings"]["frontend.voxel_size"])
    cap = int(cfg["capacity"])
    cache = {}

    def ref_cloud(key, ctl=False):
        if (key, ctl) not in cache:
            p, rid, kf = key
            raw = run.rec.scan(rid, recs.frames[key])
            cache[key, ctl] = ref.voxel_grid(raw, voxel, cap, control=ctl)
        return cache[key, ctl]

    out = {}
    clouds = getattr(recs, "clouds", {})
    keys = sorted(clouds)
    take = int(traffic.get("check_keyframes", 150))
    if len(keys) > take:
        keys = [keys[i] for i in sorted(rng.choice(len(keys), take,
                                                   replace=False))]
    if keys:
        out["voxel_err"] = max(
            ref.cloud_distance(ref_cloud(k, True) if control else clouds[k],
                               ref_cloud(k)) for k in keys)
    regs = [r for r in recs.registrations if r["src"] and r["dst"]]
    take = int(traffic.get("check_registrations", 60))
    if len(regs) > take:
        regs = [regs[i] for i in sorted(rng.choice(len(regs), take,
                                                   replace=False))]
    if regs:
        frac_err = rmse_err = truth_err = 0.0
        revisits = 0
        gate = float(cfg["revisit_gate_m"])
        for r in regs:
            src_key = (r["pass"],) + tuple(r["src"])
            dst_key = (r["pass"],) + tuple(r["dst"])
            src, dst = ref_cloud(src_key), ref_cloud(dst_key)
            truth = ref.relative_pose(
                run.rec.sensor_pose(r["src"][0], recs.frames[src_key]),
                run.rec.sensor_pose(r["dst"][0], recs.frames[dst_key]))
            if r["success"] and np.linalg.norm(truth[1]) < gate:
                revisits += 1
                R, t = (np.eye(3), np.zeros(3)) if control else \
                    (r["R"], r["t"])
                truth_err = max(truth_err, ref.truth_error(src, R, t,
                                                           *truth))
            d2, slack = ref.fit_distances(src, dst, r["R"], r["t"])
            got = (r["frac"], r["rmse"])
            if control:
                got = ref.fit_of(ref.fit_distances(
                    src, dst, r["R"], r["t"], control=True)[0], 2.0 * voxel)
            f_gap, r_gap = ref.fit_error(d2, slack, 2.0 * voxel, *got)
            frac_err = max(frac_err, f_gap)
            rmse_err = max(rmse_err, r_gap)
        out["reg_inlier_err"] = frac_err
        out["reg_rmse_err"] = rmse_err
        if revisits:
            out["reg_truth_err_m"] = truth_err
    return out
