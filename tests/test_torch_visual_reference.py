"""The port's learned visual networks against the plain float32 reference
(`swarmbench/reference_visual.py`, the one the benchmark's checks use),
on the CPU, on seeded random weights and on the shipped weights, and the
learned stereo handler's spans and counters.

The reference is written from the published descriptions and shares no
code with the port; it reads state dicts in the published key names,
and reads the shipped weight files with its own key mapping.

Tolerances, each with its reason:
- SuperPoint, float32 network: heatmap <= 1e-6 and descriptor map
  <= 1e-5 max abs (float32 convolutions summed in another order;
  measured 7e-9 and 3e-7); the keypoints identical to the reference's
  local maxima, with their scores <= 1e-6 and descriptors <= 1e-5.
  On a 48 x 81 image (a width of 8k + 1) this holds the repaired
  decode: the heatmap is 80 wide, and a flat index decoded with the
  image's width 81, as the JAX package decodes it, moves a keypoint of
  row y by y pixels. The JAX package agrees with the port only where
  the width is a multiple of 8, so no parity test covers this width.
- SuperPoint, bfloat16 convolutions (the port's default): heatmap <=
  1e-3 max abs and every descriptor's cosine to the reference's >=
  0.9999 (bf16 inputs carry 8 mantissa bits; measured 1.2e-5 and
  1 - 4e-5 at random init).
- LightGlue, d = 256, 4 heads, 2 layers, K = 48 / 64 with padded
  slots: log-assignment scores within 1e-4 + 2e-6 |score| on valid
  entries (float32 rounding of scores that reach -35; measured 2.3e-5),
  -inf on exactly the entries with a padded side.
- CosPlace, ResNet-18 with a 64-d head on a 64 x 64 crop: 1 - cosine
  <= 1e-6 for the float32 network and <= 1e-4 for the bfloat16 one
  (measured 0 and 8e-6).
- The shipped weights, as the port loads them (its converter) and as the
  reference reads them (its own mapping), through the float32 networks:
  SuperPoint's heatmap <= 1e-6 and descriptor map <= 1e-5, CosPlace's
  1 - cosine <= 1e-6, as on random weights. A weight mapped wrongly
  (a transposed kernel, swapped statistics) moves them by orders more.
- LightGlue with every weight drawn at random (biases and LayerNorm
  affines too, as the benchmark draws them): the same bound as above.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.frontend.rgbd_handler import CameraInfo, StereoHandler
from cslam_tpu_torch.models import zoo
from cslam_tpu_torch.models.cosplace import CosPlace, GeoLocalizationNet, \
    flax_init_, preprocess
from cslam_tpu_torch.models.lightglue import LightGlueNet, \
    normalize_keypoints
from cslam_tpu_torch.models.superpoint import SuperPoint, SuperPointNet, \
    _cell_scores_to_heatmap, extract
from cslam_tpu_torch.runtime.tracing import tracer
from swarmbench import reference_visual as ref

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "swarmbench", "reference_visual.py")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _state(model):
    return {k: v.detach().float() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_superpoint_float32_and_decode_at_width_8k_plus_1(seed):
    gen = torch.Generator().manual_seed(seed)
    net = flax_init_(SuperPointNet(dtype=torch.float32), seed).eval()
    image = torch.rand(48, 81, generator=gen)
    with torch.no_grad():
        det, dmap = net(image[None, :, :, None])
        xy, desc, scores, mask = extract(net, image, max_keypoints=64)
    heat = _cell_scores_to_heatmap(det)[0]
    rheat, rdesc = ref.superpoint(_state(net), image)
    assert heat.shape == rheat.shape == (48, 80)
    assert float((heat - rheat).abs().max()) <= 1e-6
    assert float((dmap[0] - rdesc).abs().max()) <= 1e-5
    keep = mask > 0
    x, y = xy[keep, 0].long(), xy[keep, 1].long()
    assert int(x.max()) < 80 and int(y.max()) > 8
    rxy, rscores, rd = ref.keypoints(rheat, rdesc, 64)
    assert int(keep.sum()) == len(rxy) >= 32
    assert sorted(map(tuple, xy[keep].long().tolist())) == \
        sorted(map(tuple, rxy.long().tolist()))
    assert float((scores[keep] - rheat[y, x]).abs().max()) <= 1e-6
    assert bool(torch.all(rheat[y, x] >= ref.nms_pool(rheat, 4)[y, x]))
    cell = rdesc[y // 8, x // 8]
    cell = cell / cell.norm(dim=1, keepdim=True)
    assert float((desc[keep] - cell).abs().max()) <= 1e-5


def test_superpoint_bfloat16_against_reference():
    gen = torch.Generator().manual_seed(2)
    net = flax_init_(SuperPointNet(), 2).eval()
    image = torch.rand(48, 81, generator=gen)
    with torch.no_grad():
        det, dmap = net(image[None, :, :, None])
    rheat, rdesc = ref.superpoint(_state(net), image)
    heat = _cell_scores_to_heatmap(det)[0]
    assert float((heat - rheat).abs().max()) <= 1e-3
    cos = (dmap[0] * rdesc).sum(-1)
    assert float(cos.min()) >= 0.9999


def test_lightglue_padded_against_reference():
    gen = torch.Generator().manual_seed(3)
    net = flax_init_(LightGlueNet(dim=256, num_layers=2, num_heads=4),
                     3).eval()
    k0, k1, size = 48, 64, (81, 48)
    d0 = torch.nn.functional.normalize(torch.randn(k0, 256, generator=gen),
                                       dim=1)
    d1 = torch.nn.functional.normalize(torch.randn(k1, 256, generator=gen),
                                       dim=1)
    xy0 = torch.rand(k0, 2, generator=gen) * torch.tensor([81.0, 48.0])
    xy1 = torch.rand(k1, 2, generator=gen) * torch.tensor([81.0, 48.0])
    m0 = torch.ones(k0)
    m0[40:] = 0.0
    m0[7] = 0.0
    m1 = torch.ones(k1)
    m1[50:] = 0.0
    with torch.no_grad():
        got = net(d0, normalize_keypoints(xy0, size), m0, d1,
                  normalize_keypoints(xy1, size), m1)
    want = ref.lightglue(_state(net), d0, xy0, m0, d1, xy1, m1, size, 2, 4)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(fin, (m0[:, None] > 0) & (m1[None, :] > 0))
    err = (got[fin] - want[fin]).abs()
    assert bool(torch.all(err <= 1e-4 + 2e-6 * want[fin].abs()))
    # the TF32 control moves the scores well past that
    tf32 = ref.lightglue(_state(net), d0, xy0, m0, d1, xy1, m1, size, 2, 4,
                         product_round=ref.round_tf32)
    assert float((tf32[fin] - want[fin]).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-6),
                                         (torch.bfloat16, 1e-4)])
def test_cosplace_against_reference(dtype, bound):
    gen = torch.Generator().manual_seed(4)
    net = flax_init_(GeoLocalizationNet(64, dtype=dtype), 4).eval()
    images = (torch.rand(3, 64, 64, generator=gen) * 255).to(torch.uint8)
    batch = preprocess(np.broadcast_to(images.numpy()[..., None],
                                       (3, 64, 64, 3)), 64)
    with torch.no_grad():
        got = net(torch.from_numpy(np.asarray(batch, np.float32)))
    want = ref.cosplace(_state(net), images, 64)
    assert float((1.0 - (got * want).sum(1)).max()) <= bound


def test_superpoint_shipped_weights_read_by_the_reference():
    path = zoo.shipped_checkpoint("superpoint_synth.npz")
    net = SuperPointNet(dtype=torch.float32).eval()
    net.load_state_dict(SuperPoint(checkpoint=path,
                                   device="cpu").model.state_dict())
    image = torch.rand(48, 81, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        det, dmap = net(image[None, :, :, None])
    rheat, rdesc = ref.superpoint(ref.superpoint_weights(path), image)
    assert float((_cell_scores_to_heatmap(det)[0] - rheat).abs().max()) \
        <= 1e-6
    assert float((dmap[0] - rdesc).abs().max()) <= 1e-5


def test_cosplace_shipped_weights_read_by_the_reference():
    path = zoo.shipped_checkpoint("cosplace_synth.npz")
    program = CosPlace({"frontend.global_descriptor_dim": 64,
                        "frontend.image_crop_size": 64,
                        "frontend.nn_checkpoint": "shipped"}, device="cpu")
    net = GeoLocalizationNet(64, dtype=torch.float32).eval()
    net.load_state_dict(program.model.state_dict())
    gen = torch.Generator().manual_seed(6)
    images = (torch.rand(3, 64, 96, generator=gen) * 255).to(torch.uint8)
    batch = preprocess(np.broadcast_to(images.numpy()[..., None],
                                       (3, 64, 96, 3)), 64)
    with torch.no_grad():
        got = net(torch.from_numpy(np.asarray(batch, np.float32)))
    want = ref.cosplace(ref.cosplace_weights(path), images, 64)
    assert float((1.0 - (got * want).sum(1)).max()) <= 1e-6


@pytest.mark.parametrize("layers", [2, 9])
def test_lightglue_shapes_are_the_port_state(layers):
    state = LightGlueNet(dim=256, num_layers=layers,
                         num_heads=4).state_dict()
    shapes = ref.lightglue_shapes(256, layers, 4)
    assert {k: tuple(v.shape) for k, v in state.items()} == shapes


def test_lightglue_drawn_weights_against_reference():
    gen = torch.Generator().manual_seed(7)
    state = {}
    for key, shape in ref.lightglue_shapes(256, 2, 4).items():
        a = torch.randn(shape, generator=gen)
        state[key] = a / shape[1] ** 0.5 if len(shape) == 2 else \
            (1.0 if key.endswith(".1.weight") else 0.0) + 0.1 * a
    net = LightGlueNet(dim=256, num_layers=2, num_heads=4).eval()
    net.load_state_dict(state, strict=True)
    k0, k1, size = 40, 56, (81, 48)
    d0 = torch.nn.functional.normalize(torch.randn(k0, 256, generator=gen),
                                       dim=1)
    d1 = torch.nn.functional.normalize(torch.randn(k1, 256, generator=gen),
                                       dim=1)
    xy0 = torch.rand(k0, 2, generator=gen) * torch.tensor([81.0, 48.0])
    xy1 = torch.rand(k1, 2, generator=gen) * torch.tensor([81.0, 48.0])
    m0, m1 = torch.ones(k0), torch.ones(k1)
    m0[33:] = 0.0
    m1[3] = 0.0
    with torch.no_grad():
        got = net(d0, normalize_keypoints(xy0, size), m0, d1,
                  normalize_keypoints(xy1, size), m1)
    want = ref.lightglue(state, d0, xy0, m0, d1, xy1, m1, size, 2, 4)
    fin = torch.isfinite(want)
    assert torch.equal(fin, (m0[:, None] > 0) & (m1[None, :] > 0))
    assert torch.equal(fin, torch.isfinite(got))
    err = (got[fin] - want[fin]).abs()
    assert bool(torch.all(err <= 1e-4 + 2e-6 * want[fin].abs()))


def test_reference_loads_nothing_of_the_packages():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('vm', {REF_PATH!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(top & {'jax', 'jaxlib', 'flax', "
        "'cslam_tpu', 'cslam_tpu_torch'})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd="/")
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def _frame(seed, shift):
    """A textured 64 x 81 left image and its right view `shift` pixels
    to the left (a plane at one depth)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (8, 12)).astype(np.uint8)
    left = np.kron(cells, np.ones((8, 8), np.uint8))[:64, :81 + shift]
    return np.ascontiguousarray(left[:, :81]), \
        np.ascontiguousarray(left[:, shift:shift + 81])


def test_learned_stereo_frame_spans_and_counter():
    """Two frames through a learned StereoHandler (LightGlue gating on
    the second): the new spans nest inside feature_extract, the
    lightglue_match span carries its keypoint counts and layers, the
    counter `visual` counts frames, keypoints and pairs, CosPlace counts
    its images, and the keyframe message carries the left image in 8
    bits."""
    router = InProcessRouter()
    bus = InProcessBus(router, 0)
    params = {"robot_id": 0, "max_nb_robots": 1,
              "frontend.features": "learned",
              "frontend.lightglue_checkpoint": "disable",
              "frontend.lightglue_layers": 2,
              "frontend.keyframe_generation_ratio_threshold": 0.8,
              "frontend.stereo_max_disparity": 16}
    h = StereoHandler(params, bus, ManualClock(), max_keypoints=32,
                      device="cpu")
    kf_msgs = []
    bus.subscribe("cslam/keyframe_data", kf_msgs.append)
    info_l = CameraInfo(fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    info_r = CameraInfo(fx=60.0, fy=60.0, cx=40.0, cy=32.0, tx=-6.0)
    pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    tracer.clear()
    tracer.enable(None)
    try:
        for seed in (0, 0):
            left, right = _frame(seed, 4)
            h.add_stereo_pair(left, right, pose, left_info=info_l,
                              right_info=info_r)
            h.process_new_sensor_data()
        router.spin_until_idle()
        cp = CosPlace({"frontend.global_descriptor_dim": 64,
                       "frontend.image_crop_size": 32,
                       "frontend.nn_checkpoint": "shipped"}, device="cpu")
        cp.compute_embeddings_batch(np.zeros((2, 40, 40, 3), np.uint8))
    finally:
        tracer.disable()
    totals = tracer.totals()
    for name in ("feature_extract", "superpoint_forward", "keypoint_select",
                 "stereo_depth"):
        assert totals[name]["count"] == 2, name
    assert totals["lightglue_match"]["count"] == 1
    counts = tracer.counter_totals()["visual"]
    assert counts["frames"] == 2 and counts["lightglue_pairs"] == 1
    assert 0 < counts["keypoints"] <= 64
    assert counts["cosplace_images"] == 2
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"visual_spans_{os.getpid()}.json")
    try:
        events = json.load(open(tracer.dump(path)))["traceEvents"]
    finally:
        os.unlink(path)
    (lg,) = [e for e in events if e.get("name") == "lightglue_match"]
    assert lg["args"]["k0"] == lg["args"]["k1"] == 32
    assert lg["args"]["layers"] == 2
    assert 0 <= lg["args"]["valid0"] <= 32
    assert 0 < lg["args"]["valid1"] <= 32
    left, _ = _frame(0, 4)
    assert kf_msgs and kf_msgs[0].image.dtype == np.uint8
    np.testing.assert_array_equal(kf_msgs[0].image[..., 0], left)
    tracer.clear()
