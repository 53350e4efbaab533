"""Stereo front-end: the learned visual front end on rendered frames of
KITTI's size.

The world: vertical facades along both sides of every street of the
route (`route.Route`), `facade_offset_m` from the centre line, and a
ground plane. A facade is a row of buildings (`block_m` long, heights
drawn per building) whose walls carry a grid of windows; the ground
carries a grid of tiles. Every shade is a hash of the world position
(street, side, along-street metre, height; ground metre), so a robot
that drives a street another drove sees the same pixels. Walls farther
than `detail_m` show only their building's shade (no window can be
resolved that far), and the sky is a flat bright shade.

The recording: every robot's true poses along its loop (a frame every
speed / rate metres), its drifted odometry, and for its first
`frames_rendered` frames the left and right grey images (8 bits) of a
rectified stereo pair at KITTI 00's calibration, `camera_height_m`
above the ground, looking along the direction of travel, with sensor
noise drawn from the seed, the robot, the frame and the eye. Images are
ray cast on the device in batches during set-up (per image column one
ray against every facade segment, then per pixel wall, ground or sky)
and kept on the host, where a camera driver delivers them.

The swarm: per robot a `StereoHandler` (`frontend.features: learned`:
SuperPoint, stereo ZNCC depth, LightGlue gating and verification, RANSAC),
a `GlobalDescriptorComponent` and a `SwarmNode`, all robots sharing one
CosPlace, on one `InProcessRouter`. Step s feeds frame s of every robot
(both images, the camera infos and its odometry); the handler keeps it
as a keyframe when tracking against the previous keyframe is weak.
SuperPoint and CosPlace load the shipped weights; LightGlue's weights
(no checkpoint of its published depth is in the repository) are drawn
here from the configuration's `lightglue_weights_seed` (a deployment
runs one checkpoint: the same weights in every run, as the world is the
same) and loaded into every handler's network.

Numbers compared (`checks`), each against the plain float32 reference
(`reference_visual.py`), which reads the shipped weight files itself
and takes LightGlue's drawn arrays as drawn, not from the program:
- superpoint_err: over a sample of frames, for every keypoint the
  program returned, the largest of |its score - the reference heatmap
  there|, |a descriptor component - the reference descriptor map's
  cell there|, and how far the reference heatmap there lies under its
  NMS window's maximum, under the detection threshold, or under the
  reference's `max_keypoints`-th highest local maximum; 1e9 for a
  keypoint off the heatmap.
- superpoint_missed: over the same frames, the largest share of the
  reference's keypoints (its `max_keypoints` highest local maxima above
  the threshold, or all of them where fewer) with no returned keypoint
  within their NMS window: a program that returns too few keypoints, or
  not the highest, reads it; a sound one only where near-equal scores
  at the cut change places.
- lightglue_err: over a sample of LightGlue pairs, with the program's
  own keypoints and descriptors as inputs, the largest |program score -
  reference score| / (1 + |reference score|) over the valid entries;
  1e9 when the two disagree on which entries are valid.
- cosplace_err: over a sample of keyframes, the largest 1 - cosine of
  the program's descriptor and the reference's of the same image.
The control (`--control 1`) puts the reference one precision below the
program in its place: SuperPoint's and CosPlace's convolution inputs
rounded to fp8 (e4m3), LightGlue's products' inputs rounded to TF32.
The descriptor searches (`topk_err`) are judged over the descriptors
the program published. Before the window, `check_keypoint_positions`
ends a run whose program returns its keypoints off the heatmap's
maxima.
"""

from pathlib import Path

import numpy as np
import torch

from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.config import default_params
from cslam_tpu_torch.frontend.global_descriptor_component import \
    GlobalDescriptorComponent
from cslam_tpu_torch.frontend.rgbd_handler import CameraInfo, StereoHandler
from cslam_tpu_torch.models.cosplace import CosPlace
from cslam_tpu_torch.node import SwarmNode

from swarmbench import reference_visual as refv
from swarmbench.route import Route, drifted_odometry

# the shipped weights the program loads, read by the reference too
WEIGHTS = Path(refv.__file__).resolve().parents[1] / "cslam_tpu" / \
    "models" / "weights"
# frames ray cast at once
RENDER_BATCH = 8
# the checks' samples: frames and LightGlue pairs kept, and their draws
SAMPLE_SIZE = 24
SAMPLE_SEED = 0x5EED
SKY = 0.85
# the published superpoint_lightglue model's attention heads
LIGHTGLUE_HEADS = 4
# SuperPoint's published NMS radius and detection threshold
NMS_RADIUS, THRESHOLD = 4, 0.005
# the largest share of keypoints off the reference's maxima that set-up
# lets through: bf16 inputs move a few near-ties, a wrong decode nearly
# every keypoint
MISPLACED_LIMIT = 0.5


def _hash(*keys):
    """Uniform [0, 1) float32 of integer tensors (a 31-bit mix)."""
    h = torch.zeros_like(keys[0], dtype=torch.int64)
    for i, k in enumerate(keys):
        h = (h ^ (k.to(torch.int64) * (0x9E3779B1 + 2 * i + 1))) \
            & 0x7FFFFFFF
        h = ((h ^ (h >> 15)) * 0x2C1B3C6D) & 0x7FFFFFFF
        h = ((h ^ (h >> 12)) * 0x297A2D39) & 0x7FFFFFFF
        h = h ^ (h >> 15)
    return (h & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _vertex_normals(poly):
    d = np.gradient(poly, axis=0)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    return np.stack([-d[:, 1], d[:, 0]], axis=1)


class World:
    """Facade segments along the route's streets, on the device."""

    def __init__(self, config, route: Route, device):
        w = config["world"]
        self.cfg = w
        self.seed = int(config["world_seed"])
        seg_m = float(w["segment_m"])
        offset = float(w["facade_offset_m"])
        polys = []
        for poly in route.street_polylines():
            cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
                np.diff(poly, axis=0), axis=1))])
            pick = np.unique(np.concatenate([
                np.searchsorted(cum, np.arange(0.0, cum[-1], seg_m)),
                [len(poly) - 1]]))
            polys.append((poly[pick], cum[pick]))
        a, b, s0, s1, wid = [], [], [], [], []
        for sid, (poly, cum) in enumerate(polys):
            normal = _vertex_normals(poly)
            others = np.concatenate([p for i, (p, _) in enumerate(polys)
                                     if i != sid])
            for side in (0, 1):
                off = poly + (1.0 if side else -1.0) * offset * normal
                # no facade across another street: junctions stay open
                mid = (off[:-1] + off[1:]) / 2
                gap = np.min(np.linalg.norm(
                    mid[:, None] - others[None], axis=2), axis=1)
                keep = gap > offset - 0.5
                a.append(off[:-1][keep])
                b.append(off[1:][keep])
                s0.append(cum[:-1][keep])
                s1.append(cum[1:][keep])
                wid.append(np.full(int(keep.sum()), 2 * sid + side))
        f32 = dict(dtype=torch.float32, device=device)
        self.a = torch.tensor(np.concatenate(a), **f32)
        self.e = torch.tensor(np.concatenate(b), **f32) - self.a
        self.s0 = torch.tensor(np.concatenate(s0), **f32)
        self.s1 = torch.tensor(np.concatenate(s1), **f32)
        self.wid = torch.tensor(np.concatenate(wid), dtype=torch.int64,
                                device=device)

    def render(self, pos, yaw, cam):
        """(B, H, W) float32 images in [0, 1] of cameras at ground
        positions pos (B, 2), yaws (B,); cam = (H, W, fx, fy, cx, cy,
        height)."""
        H, W, fx, fy, cx, cy, cam_h = cam
        w = self.cfg
        dev = pos.device
        fwd = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=1)
        right = torch.stack([torch.sin(yaw), -torch.cos(yaw)], dim=1)
        u = (torch.arange(W, device=dev, dtype=torch.float32) - cx) / fx
        ray = fwd[:, None, :] + u[None, :, None] * right[:, None, :]
        q = self.a[None] - pos[:, None]                       # (B, S, 2)
        e = self.e

        def cross(x, y):
            return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]

        denom = cross(ray[:, :, None, :], e[None, None])      # (B, W, S)
        safe = torch.where(denom.abs() > 1e-9, denom,
                           torch.ones_like(denom))
        depth = cross(q[:, None], e[None, None]) / safe
        along = cross(q[:, None], ray[:, :, None, :]) / safe
        hit = (denom.abs() > 1e-9) & (depth > 0.1) & (along >= 0) & \
            (along <= 1)
        depth = torch.where(hit, depth, torch.full_like(depth, torch.inf))
        s_wall, seg = torch.min(depth, dim=2)                 # (B, W)
        frac = torch.gather(along, 2, seg[..., None])[..., 0]
        metre = self.s0[seg] + frac * (self.s1[seg] - self.s0[seg])
        wall_id = self.wid[seg]
        block = torch.floor(metre / float(w["block_m"])).to(torch.int64)
        lo, hi = w["building_height_m"]
        height = lo + (hi - lo) * _hash(wall_id, block, torch.full_like(
            block, self.seed))
        shade = 0.3 + 0.35 * _hash(wall_id, block, torch.full_like(
            block, self.seed + 1))
        v = (torch.arange(H, device=dev, dtype=torch.float32) - cy) / fy
        z = cam_h - s_wall[:, None, :] * v[None, :, None]     # (B, H, W)
        wall = (z >= 0) & (z <= height[:, None, :]) & \
            torch.isfinite(s_wall)[:, None, :]
        # windows: a cell grid on the wall, a window in some cells
        cw, ch = float(w["window_cell_m"][0]), float(w["window_cell_m"][1])
        mu = metre[:, None, :] / cw
        mz = torch.clamp(z, min=0.0) / ch
        cu, cz = torch.floor(mu).to(torch.int64), torch.floor(mz).to(
            torch.int64)
        fu, fz = mu - cu, mz - cz
        wid3 = wall_id[:, None, :].expand_as(cu)
        has = _hash(wid3, cu, cz, torch.full_like(cu, self.seed + 2)) < \
            float(w["window_share"])
        inside = (fu > 0.2) & (fu < 0.8) & (fz > 0.25) & (fz < 0.75)
        tone = _hash(wid3, cu, cz, torch.full_like(cu, self.seed + 3))
        glass = torch.where(tone < 0.5, 0.05 + 0.2 * tone,
                            0.6 + 0.4 * tone)
        near = (s_wall < float(w["detail_m"]))[:, None, :]
        wall_shade = torch.where(has & inside & near, glass,
                                 shade[:, None, :].expand_as(glass))
        # ground: tiles of `ground_cell_m`
        down = v > 0
        s_ground = torch.where(down, cam_h / torch.where(
            down, v, torch.ones_like(v)), torch.full_like(v, torch.inf))
        gx = pos[:, None, None, 0] + s_ground[None, :, None] * \
            ray[:, None, :, 0]
        gy = pos[:, None, None, 1] + s_ground[None, :, None] * \
            ray[:, None, :, 1]
        gc = float(w["ground_cell_m"])
        ix = torch.floor(gx / gc).to(torch.int64)
        iy = torch.floor(gy / gc).to(torch.int64)
        g_shade = 0.25 + 0.3 * _hash(ix, iy, torch.full_like(ix,
                                                              self.seed + 4))
        far = (s_ground > float(w["ground_detail_m"]))[None, :, None]
        g_shade = torch.where(far, torch.full_like(g_shade, 0.4), g_shade)
        ground = down[None, :, None] & ~wall
        img = torch.full_like(z, SKY)
        img = torch.where(ground, g_shade, img)
        return torch.where(wall, wall_shade, img)


class Recording:
    """Host arrays of one mission, made from the seed."""

    def __init__(self, config, traffic, seed: int, device=None):
        n = int(config["robots"])
        rate = float(config["frame_rate_hz"])
        spacing = float(config["speed_m_per_s"]) / rate
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
        self.pass_frames = min(len(t) for t in self.route.t)
        self.n_steps = min(self.pass_frames, int(config["frames_rendered"]))
        self.dt = 1.0 / rate
        cam = config["camera"]
        self.size = (int(cam["width"]), int(cam["height"]))
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.baseline = float(cam["baseline_m"])
        rng = np.random.default_rng([self.seed, 0x57E0])
        sr, st = config["odometry_sigma"]
        self.odom = []
        for r in range(n):
            R, t = self.route.R[r], self.route.t[r]
            oR, ot = drifted_odometry(R, t, float(sr), float(st), rng)
            self.odom.append((oR[:self.n_steps].astype(np.float32),
                              ot[:self.n_steps].astype(np.float32)))
        dev = torch.device("cpu") if device is None else device
        world = World(config, self.route, dev)
        self.left, self.right = [], []
        noise = float(config["pixel_noise"])
        geom = (self.size[1], self.size[0], self.fx, self.fy, self.cx,
                self.cy, float(cam["height_m"]))
        for r in range(n):
            eyes = ([], [])
            for lo in range(0, self.n_steps, RENDER_BATCH):
                hi = min(lo + RENDER_BATCH, self.n_steps)
                yaw = np.arctan2(self.route.R[r][lo:hi, 1, 0],
                                 self.route.R[r][lo:hi, 0, 0])
                pos = self.route.t[r][lo:hi, :2]
                right = np.stack([np.sin(yaw), -np.cos(yaw)], axis=1)
                gen = torch.Generator(device=dev).manual_seed(
                    int(np.random.SeedSequence(
                        [self.seed, r, lo]).generate_state(1)[0]))
                for eye, p in enumerate((pos, pos + self.baseline * right)):
                    img = world.render(
                        torch.tensor(p, dtype=torch.float32, device=dev),
                        torch.tensor(yaw, dtype=torch.float32, device=dev),
                        geom)
                    img = img + noise * torch.randn(
                        img.shape, generator=gen, device=dev)
                    eyes[eye].append(torch.clamp(
                        torch.round(img * 255.0), 0, 255).to(
                            torch.uint8).cpu().numpy())
            self.left.append(np.concatenate(eyes[0]))
            self.right.append(np.concatenate(eyes[1]))
        # the program's published global descriptors, (robot, kf) -> row,
        # filled while the swarm runs (`instrument`): the searches' data
        self.kf_desc = {}
        self._desc = None

    @property
    def desc(self):
        """Per robot, its keyframes' descriptors as the program published
        them, one row per keyframe id (rows never published hold ones)."""
        if self._desc is not None and self._desc[0] == len(self.kf_desc):
            return self._desc[1]
        out = {}
        dim = len(next(iter(self.kf_desc.values()))) if self.kf_desc else 1
        for r in range(self.n_robots):
            kfs = [k for (rr, k) in self.kf_desc if rr == r]
            arr = np.ones((max(kfs) + 1 if kfs else 0, dim), np.float32)
            for k in kfs:
                arr[k] = self.kf_desc[r, k]
            out[r] = arr
        self._desc = (len(self.kf_desc), out)
        return out

    def descriptor(self, robot: int, kf: int) -> np.ndarray:
        return self.kf_desc[robot, kf]

    def camera_infos(self):
        left = CameraInfo(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
                          tx=0.0, width=self.size[0], height=self.size[1])
        right = CameraInfo(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
                           tx=-self.fx * self.baseline, width=self.size[0],
                           height=self.size[1])
        return left, right


def make_recording(config, traffic, seed):
    """Rendered on the card where there is one (the harness makes the
    recording before it names the run's device)."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return Recording(config, traffic, seed, dev)


def node_params(config, rid):
    params = default_params(robot_id=rid, max_nb_robots=int(config["robots"]))
    params.update(config["settings"])
    return params


def draw_lightglue(seed, dim, num_layers, num_heads):
    """LightGlue's weights drawn from `seed`, in the published model's
    keys and shapes: matrices normal with variance 1 / fan-in (the
    positional encoding's N(0, 1), as published), biases and LayerNorm
    shifts N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.02^2). (At 0.1 the
    biases of nine layers drown the descriptors: no match survives the
    mutual check and no inter-robot verification is accepted.)"""
    rng = np.random.default_rng([int(seed), 0x1167])
    state = {}
    for key, shape in refv.lightglue_shapes(dim, num_layers,
                                            num_heads).items():
        a = rng.standard_normal(shape)
        if key == "posenc.Wr.weight":
            pass
        elif len(shape) == 2:
            a /= np.sqrt(shape[1])
        elif key.endswith(".1.weight"):
            a = 1.0 + 0.02 * a
        else:
            a *= 0.02
        state[key] = torch.from_numpy(a.astype(np.float32))
    return state


class Swarm:
    def __init__(self, config, rec: Recording, device):
        self.rec, self.config = rec, config
        self.router = InProcessRouter()
        self.clock = ManualClock()
        self.nodes, self.handlers, self.components = {}, {}, {}
        self.infos = rec.camera_infos()
        self.current = None       # (robot, step) being fed
        try:
            self.model = CosPlace(node_params(config, 0), device=device)
            if not self.model.enabled:
                raise FileNotFoundError("no shipped cosplace weights")
            for rid in range(rec.n_robots):
                bus = InProcessBus(self.router, rid)
                params = node_params(config, rid)
                self.handlers[rid] = StereoHandler(
                    params, bus, self.clock,
                    max_keypoints=int(config["max_keypoints"]),
                    device=device)
                self.components[rid] = GlobalDescriptorComponent(
                    params, bus, model=self.model,
                    batch_size=int(config["descriptor_batch"]),
                    device=device)
                self.nodes[rid] = SwarmNode(params, bus, self.clock,
                                            descriptor_model=self.model,
                                            device=device)
            layers = int(config["settings"]["frontend.lightglue_layers"])
            self.lightglue = draw_lightglue(
                int(config["lightglue_weights_seed"]), 256, layers,
                LIGHTGLUE_HEADS)
            for handler in self.handlers.values():
                handler.lightglue.model.load_state_dict(self.lightglue,
                                                        strict=True)
        except BaseException:
            self.close()
            raise

    def feed(self, step: int):
        """Frame `step` of every robot: [(robot, kf, frame)] of the
        frames kept as keyframes."""
        rec = self.rec
        taken = []
        for rid, handler in self.handlers.items():
            self.current = (rid, step)
            handler.add_stereo_pair(rec.left[rid][step], rec.right[rid][step],
                                    (rec.odom[rid][0][step],
                                     rec.odom[rid][1][step]),
                                    left_info=self.infos[0],
                                    right_info=self.infos[1])
            kf = handler.process_new_sensor_data()
            if kf is not None:
                taken.append((rid, kf, step))
        self.router.spin_until_idle(max_rounds=2000)
        return taken

    def close(self):
        for node in self.nodes.values():
            node.close()
        for handler in self.handlers.values():
            handler.close()


def build_swarm(config, traffic, rec, device):
    return Swarm(config, rec, device)


class _Reservoir:
    """A uniform sample of at most `size` items of a stream."""

    def __init__(self, size, rng):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = make()


def instrument(swarm: Swarm, records, pass_index):
    """Keep a sample of the networks' answers and every published global
    descriptor, with the networks' weights."""
    vis = getattr(records, "visual", None)
    if vis is None:
        rng = np.random.default_rng(SAMPLE_SEED)
        vis = records.visual = {
            "sp": _Reservoir(SAMPLE_SIZE, rng),
            "lg": _Reservoir(SAMPLE_SIZE, rng),
            "desc": {}, "state": None}
    if vis["state"] is None:
        config = swarm.config
        settings = config["settings"]
        vis["state"] = {
            "superpoint": refv.superpoint_weights(
                WEIGHTS / "superpoint_synth.npz"),
            "lightglue": swarm.lightglue,
            "layers": int(settings["frontend.lightglue_layers"]),
            "heads": LIGHTGLUE_HEADS,
            "cosplace": refv.cosplace_weights(WEIGHTS / "cosplace_synth.npz"),
            "crop": int(settings["frontend.image_crop_size"]),
            "max_keypoints": int(config["max_keypoints"])}
    for rid, handler in swarm.handlers.items():
        extract = handler.superpoint.extract_features

        def extracted(image, max_keypoints=None, _extract=extract):
            out = _extract(image, max_keypoints=max_keypoints)
            robot, step = swarm.current
            vis["sp"].offer(lambda: (pass_index, robot, step, out))
            return out
        handler.superpoint.extract_features = extracted
        scores = handler.lightglue.scores

        def scored(desc0, xy0, m0, desc1, xy1, m1, size=None,
                   _scores=scores):
            out = _scores(desc0, xy0, m0, desc1, xy1, m1, size=size)
            vis["lg"].offer(lambda: ((desc0, xy0, m0, desc1, xy1, m1,
                                      size), out))
            return out
        handler.lightglue.scores = scored

        def published(msg, _rid=rid):
            d = np.asarray(msg.descriptor, dtype=np.float32)
            vis["desc"][pass_index, _rid, int(msg.keyframe_id)] = d
            swarm.rec.kf_desc[_rid, int(msg.keyframe_id)] = d
        InProcessBus(swarm.router, rid).subscribe(
            "cslam/processed_global_descriptor", published)


def warm_up(swarm: Swarm, rec, device):
    """A partial descriptor batch, so every batch size the window meets
    has run; then `check_keypoint_positions`."""
    for comp in swarm.components.values():
        comp.flush()
    swarm.router.spin_until_idle(max_rounds=2000)
    check_keypoint_positions(swarm, rec, device)


def check_keypoint_positions(swarm: Swarm, rec, device):
    """Set-up's test that the program can run this configuration: on
    robot 0's first frame, at most `MISPLACED_LIMIT` of the keypoints it
    returns may lie off the reference heatmap's NMS maxima above the
    threshold. A program that decodes the heatmap's flat indices with the
    image's width (not the heatmap's, at a width that is not a multiple
    of 8) returns nearly all of them elsewhere; the run then ends here
    with an error, before the window, and does not time a front end that
    tracks the wrong pixels. The float32 switches are put back as they
    were. Returns the share."""
    image = rec.left[0][0]
    with torch.no_grad():
        xy, _, _, mask = swarm.handlers[0].superpoint.extract_features(
            image, max_keypoints=int(swarm.config["max_keypoints"]))
        xy = xy[mask > 0].to(device)
        state = {k: v.to(device) for k, v in refv.superpoint_weights(
            WEIGHTS / "superpoint_synth.npz").items()}
        switches = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        refv.full_precision()
        try:
            heat, _ = refv.superpoint(
                state, torch.from_numpy(image).to(device).float() / 255.0)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = switches
        x, y = xy[:, 0].long(), xy[:, 1].long()
        on = (x >= 0) & (y >= 0) & (x < heat.shape[1]) & (y < heat.shape[0])
        x, y = x[on], y[on]
        at = heat[y, x]
        at_max = (at >= refv.nms_pool(heat, NMS_RADIUS)[y, x]) \
            & (at > THRESHOLD)
        share = float(len(xy) - int(at_max.sum())) / max(len(xy), 1)
    if share > MISPLACED_LIMIT:
        raise RuntimeError(
            f"{share:.3f} of the program's SuperPoint keypoints on the "
            f"first frame lie off the reference heatmap's maxima (limit "
            f"{MISPLACED_LIMIT}): it cannot run this configuration")
    return share


def _tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _superpoint_errs(run, vis, control, dev):
    """(superpoint_err, superpoint_missed) over the sampled frames."""
    state = {k: v.to(dev) for k, v in vis["state"]["superpoint"].items()}
    top = vis["state"]["max_keypoints"]
    err = missed = 0.0
    for p, robot, step, (xy, desc, scores, mask) in vis["sp"].items:
        image = torch.from_numpy(run.rec.left[robot][step]).to(dev).float() \
            / 255.0
        heat, dmap = refv.superpoint(state, image)
        pooled = refv.nms_pool(heat, NMS_RADIUS)
        ref_xy, ref_scores, _ = refv.keypoints(heat, dmap, top, NMS_RADIUS,
                                               THRESHOLD)
        if control:
            heat_c, dmap_c = refv.superpoint(state, image,
                                             conv_round=refv.round_e4m3)
            xy, scores, desc = refv.keypoints(heat_c, dmap_c, top,
                                              NMS_RADIUS, THRESHOLD)
        else:
            keep = mask > 0
            xy, scores, desc = xy[keep], scores[keep], desc[keep]
        x = xy[:, 0].long()
        y = xy[:, 1].long()
        if bool(((x < 0) | (y < 0) | (x >= heat.shape[1])
                 | (y >= heat.shape[0])).any().cpu()):
            return 1e9, 1.0     # a keypoint off the network's heatmap
        # the reference's keypoints with no returned one in their window
        near = torch.zeros_like(heat)
        near[y, x] = 1.0
        near = refv.nms_pool(near, NMS_RADIUS)
        rx, ry = ref_xy[:, 0].long(), ref_xy[:, 1].long()
        if len(ref_xy):
            missed = max(missed, float((near[ry, rx] == 0).sum())
                         / len(ref_xy))
        if not len(xy):
            continue
        at = heat[y, x]
        cell = dmap[y // 8, x // 8]
        cell = cell / torch.linalg.vector_norm(cell, dim=1, keepdim=True)
        floor = ref_scores[-1] if len(ref_scores) == top else THRESHOLD
        err = max(err,
                  float((scores.to(dev) - at).abs().max()),
                  float((desc.to(dev) - cell).abs().max()),
                  float(torch.clamp(pooled[y, x] - at, min=0).max()),
                  float(torch.clamp(floor - at, min=0).max()))
    return err, missed


def _lightglue_err(run, vis, control, dev):
    st = vis["state"]
    state = {k: v.to(dev) for k, v in st["lightglue"].items()}
    worst = 0.0
    for (d0, xy0, m0, d1, xy1, m1, size), got in vis["lg"].items:
        args = [_tensor(a, dev) for a in (d0, xy0, m0, d1, xy1, m1)]
        if size is None:
            size = torch.clamp(torch.amax(torch.cat([args[1], args[4]]),
                                          dim=0), min=1.0)
        ref = refv.lightglue(state, *args, size, st["layers"], st["heads"])
        if control:
            got = refv.lightglue(state, *args, size, st["layers"],
                                 st["heads"], product_round=refv.round_tf32)
        got = got.to(dev)
        fin = torch.isfinite(ref)
        if not torch.equal(fin, torch.isfinite(got)):
            return 1e9
        if fin.any():
            err = (got[fin] - ref[fin]).abs() / (1.0 + ref[fin].abs())
            worst = max(worst, float(err.max()))
    return worst


def _cosplace_err(run, vis, control, dev, rng):
    st = vis["state"]
    recs = run.records
    keys = sorted(k for k in vis["desc"] if k in recs.frames)
    take = int(run.cell.traffic.get("check_images", 64))
    if len(keys) > take:
        keys = [keys[i] for i in sorted(rng.choice(len(keys), take,
                                                   replace=False))]
    if not keys:
        return None
    state = {k: v.to(dev) for k, v in st["cosplace"].items()}
    worst = 0.0
    for lo in range(0, len(keys), 16):
        part = keys[lo:lo + 16]
        images = torch.from_numpy(np.stack(
            [run.rec.left[k[1]][recs.frames[k]] for k in part])).to(dev)
        ref = refv.cosplace(state, images, st["crop"])
        if control:
            got = refv.cosplace(state, images, st["crop"],
                                conv_round=refv.round_e4m3)
        else:
            got = torch.from_numpy(np.stack([vis["desc"][k] for k in part]
                                            )).to(dev)
        got = got / torch.linalg.vector_norm(got, dim=1, keepdim=True)
        worst = max(worst, float((1.0 - (got * ref).sum(dim=1)).max()))
    return worst


def checks(run, control, rng):
    vis = getattr(run.records, "visual", None)
    if vis is None or vis["state"] is None:
        return {}
    dev = run.device
    refv.full_precision()
    out = {}
    with torch.no_grad():
        if vis["sp"].items:
            out["superpoint_err"], out["superpoint_missed"] = \
                _superpoint_errs(run, vis, control, dev)
        if vis["lg"].items:
            out["lightglue_err"] = _lightglue_err(run, vis, control, dev)
        out["cosplace_err"] = _cosplace_err(run, vis, control, dev, rng)
    return out
