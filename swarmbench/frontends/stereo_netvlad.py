"""NetVLAD stereo front-end: the learned stereo front end with NetVLAD place
recognition at its published widths, every frame a keyframe.

The world, the recording and the handlers are `stereo.py`'s: rendered
1241 x 376 stereo pairs of KITTI 00's calibration, per robot a
`StereoHandler` (SuperPoint, stereo ZNCC depth, LightGlue, RANSAC), a
`GlobalDescriptorComponent` and a `SwarmNode`, on one `InProcessRouter`.
The place descriptor is NetVLAD's (`frontend.global_descriptor_technique:
netvlad`): VGG-16 to conv5_3 (512 channels), VLAD pooling over 64
clusters (32,768-d), and a projection to `frontend.global_descriptor_dim`
(4,096-d) rows, one `NetVLAD` shared by every robot and every pass of a
run. With `keyframe_generation_ratio_threshold` 1.0 every frame is a
keyframe, so LightGlue runs only to verify inter-robot candidates.

The projection is drawn here at set-up from the configuration's
`pca_seed` (a deployment runs one projection: the same in every run): the
shipped file's mean, and its 128 components completed to the configured
number of orthonormal rows by a QR of seeded Gaussian rows made
orthogonal to them. It is written to an `npz` (`mean`, `components`)
under a temporary directory, loaded by the program through
`frontend.netvlad.pca_checkpoint`, and the file removed; the reference
takes the drawn arrays as drawn. VGG-16 and the NetVLAD layer load the
shipped weights (`netvlad_synth.npz`), which the reference reads itself.

Numbers compared (`checks`), besides `stereo.py`'s superpoint_err,
superpoint_missed and lightglue_err, each against the plain float32
reference (`reference_netvlad.py`):
- netvlad_err: over `check_images` sampled keyframes, the largest
  1 - cosine of the published descriptor and the reference's descriptor
  of the same image.
- netvlad_pca_err: over a sample of embedded images, the largest L2
  distance between the published descriptor and the reference's
  projection of the 32,768-d VLAD vector the program computed for it.
The control (`--control 1`) puts the reference one precision below the
program in its place: the convolutions' inputs rounded to fp8 (e4m3)
for netvlad_err, the projection's product inputs rounded to TF32 for
netvlad_pca_err (TF32 moves the descriptor's cosine too little for
netvlad_err to see).
"""

import os
import shutil
import tempfile

import numpy as np
import torch

from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.frontend.global_descriptor_component import \
    GlobalDescriptorComponent
from cslam_tpu_torch.frontend.rgbd_handler import StereoHandler
from cslam_tpu_torch.models.netvlad import NetVLAD
from cslam_tpu_torch.node import SwarmNode

from swarmbench import reference_netvlad as refn
from swarmbench import reference_visual as refv
from swarmbench.frontends import stereo
from swarmbench.frontends.stereo import LIGHTGLUE_HEADS, SAMPLE_SIZE, \
    WEIGHTS, _Reservoir, draw_lightglue, node_params

# the checks' sample of VLAD vectors is drawn with its own generator
VLAD_SAMPLE_SEED = 0x71AD


def draw_projection(config, device):
    """(mean, components) float32 host arrays: the shipped projection's
    mean and its components completed to `global_descriptor_dim`
    orthonormal rows (float64 QR on `device`, from `pca_seed`)."""
    with np.load(WEIGHTS / "netvlad_pca_synth.npz") as z:
        mean = np.array(z["mean"], np.float32)
        shipped = np.array(z["components"], np.float32)
    dim = int(config["settings"]["frontend.global_descriptor_dim"])
    gen = torch.Generator(device=device).manual_seed(int(config["pca_seed"]))
    s = torch.from_numpy(shipped).to(device, torch.float64)
    g = torch.randn((dim - len(shipped), s.shape[1]), generator=gen,
                    dtype=torch.float64, device=device)
    g -= (g @ s.T) @ s
    q, _ = torch.linalg.qr(g.T)
    rows = torch.cat([s, q.T]).to(torch.float32).cpu().numpy()
    return mean, rows


def make_recording(config, traffic, seed):
    """`stereo.py`'s recording, with the drawn projection."""
    rec = stereo.make_recording(config, traffic, seed)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rec.projection = draw_projection(config, dev)
    rec.netvlad = None
    return rec


def _capture_vlad(model):
    """Wrap `model`'s batch embedding: each descriptor it returns is
    offered, with the VLAD vector its network computed (a device copy,
    no synchronize), to the sample `model.vlad_sink` (None: none)."""
    last = []
    model.model.register_forward_hook(
        lambda module, inputs, out: last.append(out))
    embed = model.compute_embeddings_batch
    model.vlad_sink = None

    def embedded(images):
        last.clear()
        out = embed(images)
        sink = model.vlad_sink
        if sink is not None and last:
            vlad = last[-1]
            for i in range(len(out)):
                sink.offer(lambda i=i: (vlad[i].clone(), out[i].copy()))
        last.clear()
        return out
    model.compute_embeddings_batch = embedded


def shared_netvlad(config, rec, device):
    """The run's one NetVLAD, built at its first pass (set-up): the drawn
    projection written to a temporary npz, loaded through the wrapper's
    `frontend.netvlad.pca_checkpoint`, then removed."""
    if rec.netvlad is None:
        mean, components = rec.projection
        tmp = tempfile.mkdtemp(prefix="swarmbench_netvlad_")
        try:
            path = os.path.join(tmp, "projection.npz")
            np.savez(path, mean=mean, components=components)
            params = node_params(config, 0)
            params["frontend.netvlad.pca_checkpoint"] = path
            model = NetVLAD(params, device=device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if not model.enabled:
            raise FileNotFoundError("no shipped netvlad weights")
        _capture_vlad(model)
        rec.netvlad = model
    return rec.netvlad


class Swarm(stereo.Swarm):
    """`stereo.Swarm`'s robots, with the shared NetVLAD in CosPlace's
    place."""

    def __init__(self, config, rec, device):
        self.rec, self.config = rec, config
        self.router = InProcessRouter()
        self.clock = ManualClock()
        self.nodes, self.handlers, self.components = {}, {}, {}
        self.infos = rec.camera_infos()
        self.current = None
        try:
            self.model = shared_netvlad(config, rec, device)
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


def build_swarm(config, traffic, rec, device):
    return Swarm(config, rec, device)


def instrument(swarm: Swarm, records, pass_index):
    """`stereo.instrument`'s samples of SuperPoint and LightGlue and every
    published descriptor; the reference's weights are read after the
    window (a state set here keeps `stereo.instrument` from reading
    CosPlace's). The shared model's VLAD vectors go to this run's
    sample."""
    vis = getattr(records, "visual", None)
    if vis is None:
        rng = np.random.default_rng(stereo.SAMPLE_SEED)
        vis = records.visual = {
            "sp": _Reservoir(SAMPLE_SIZE, rng),
            "lg": _Reservoir(SAMPLE_SIZE, rng),
            "vlad": _Reservoir(SAMPLE_SIZE,
                               np.random.default_rng(VLAD_SAMPLE_SEED)),
            "desc": {}, "state": None}
    if vis["state"] is None:
        config = swarm.config
        settings = config["settings"]
        vis["state"] = {
            "lightglue": swarm.lightglue,
            "layers": int(settings["frontend.lightglue_layers"]),
            "heads": LIGHTGLUE_HEADS,
            "crop": int(settings["frontend.image_crop_size"]),
            "max_keypoints": int(config["max_keypoints"])}
    stereo.instrument(swarm, records, pass_index)
    swarm.model.vlad_sink = vis["vlad"]


def warm_up(swarm: Swarm, rec, device):
    """`stereo.warm_up`, then one LightGlue verification of robot 0's last
    two keyframes: every frame is a keyframe, so the warm-up's steps run
    no LightGlue pair, and the window's first inter-robot verification
    would otherwise meet its kernels cold."""
    stereo.warm_up(swarm, rec, device)
    handler = swarm.handlers[0]
    a, b = list(handler.local_keyframes.values())[-2:]
    handler._verify(a, b.descriptors, b.points3d, b.mask, xy_b=b.keypoints,
                    feat_mask_b=b.feat_mask,
                    intr_b=getattr(handler, "_intrinsics", None))
    swarm.model.vlad_sink = None


def one_minus_cos(a, b):
    """1 - cosine of the rows of a and b, in float64 (float32 sums of
    4,096 products of unit vectors round at ~1e-7)."""
    a, b = a.double(), b.double()
    a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    return 1.0 - (a * b).sum(dim=1)


def _reference(run, dev):
    """The reference's weights and the drawn projection on `dev`."""
    state = {k: v.to(dev) for k, v in refn.netvlad_weights(
        WEIGHTS / "netvlad_synth.npz").items()}
    mean, components = run.rec.projection
    return state, torch.from_numpy(mean).to(dev), \
        torch.from_numpy(components).to(dev)


def _netvlad_err(run, vis, control, dev, rng, ref):
    state, mean, components = ref
    recs = run.records
    keys = sorted(k for k in vis["desc"] if k in recs.frames)
    take = int(run.cell.traffic.get("check_images", 64))
    if len(keys) > take:
        keys = [keys[i] for i in sorted(rng.choice(len(keys), take,
                                                   replace=False))]
    if not keys:
        return None
    crop = vis["state"]["crop"]
    worst = 0.0
    for lo in range(0, len(keys), refn.BLOCK):
        part = keys[lo:lo + refn.BLOCK]
        images = torch.from_numpy(np.stack(
            [run.rec.left[k[1]][recs.frames[k]] for k in part])).to(dev)
        want = refn.descriptors(state, images, crop, mean, components)
        if control:
            got = refn.descriptors(state, images, crop, mean, components,
                                   conv_round=refv.round_e4m3)
        else:
            got = torch.from_numpy(np.stack([vis["desc"][k] for k in part]
                                            )).to(dev)
        worst = max(worst, float(one_minus_cos(got, want).max()))
    return worst


def _netvlad_pca_err(run, vis, control, dev, ref):
    _, mean, components = ref
    if not vis["vlad"].items:
        return None
    worst = 0.0
    for vlad, published in vis["vlad"].items:
        v = vlad.to(dev, torch.float32)[None]
        want = refn.project(v, mean, components)
        if control:
            got = refn.project(v, mean, components,
                               product_round=refv.round_tf32)
        else:
            got = torch.from_numpy(published).to(dev)[None]
        worst = max(worst, float(torch.linalg.vector_norm(
            got.double() - want.double())))
    return worst


def checks(run, control, rng):
    vis = getattr(run.records, "visual", None)
    if vis is None or vis["state"] is None:
        return {}
    dev = run.device
    refn.full_precision()
    st = vis["state"]
    if "superpoint" not in st:
        st["superpoint"] = refv.superpoint_weights(
            WEIGHTS / "superpoint_synth.npz")
    out = {}
    with torch.no_grad():
        if vis["sp"].items:
            out["superpoint_err"], out["superpoint_missed"] = \
                stereo._superpoint_errs(run, vis, control, dev)
        if vis["lg"].items:
            out["lightglue_err"] = stereo._lightglue_err(run, vis, control,
                                                         dev)
        ref = _reference(run, dev)
        out["netvlad_err"] = _netvlad_err(run, vis, control, dev, rng, ref)
        out["netvlad_pca_err"] = _netvlad_pca_err(run, vis, control, dev,
                                                  ref)
    return out
