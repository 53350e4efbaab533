"""Port parity, the descriptor path: keyframe images -> the global
descriptor model -> published descriptors -> the loop-closure detector,
on both packages, on the CPU, with the shipped weights.

Mirrors test_trained_cosplace.py's config-path and detection tests:
`GlobalDescriptorComponent` built from params (no model object) on each
package publishes the same count of descriptors for the same keyframes,
within the bf16 tolerance of tests/test_torch_models.py (max abs 2e-3,
cosine >= 0.9999: both wrappers run their convs in bf16); and
`GlobalDescriptorLoopClosureDetection` built with no descriptor_model
constructs CosPlace itself and finds the same intra-robot loop closure.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.frontend import global_descriptor_component as jgdc
from cslam_tpu.frontend import loop_closure_detection as jlcd
from cslam_tpu.matching.descriptor_db import \
    DescriptorDatabase as JaxDescriptorDatabase
from cslam_tpu.models.cosplace import CosPlace as JaxCosPlace
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.frontend import global_descriptor_component as tgdc
from cslam_tpu_torch.frontend import loop_closure_detection as tlcd
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.models.cosplace import CosPlace
from cslam_tpu_torch.models.netvlad import NetVLAD
from cslam_tpu_torch.models.train_cosplace import make_world, render_view

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

BF16_TOL = 2e-3
BF16_MIN_COS = 0.9999
JAX = SimpleNamespace(bus=jbus, msgs=jmsgs, gdc=jgdc, lcd=jlcd, kw={})
PORT = SimpleNamespace(bus=tbus, msgs=tmsgs, gdc=tgdc, lcd=tlcd,
                       kw={"device": "cpu"})


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=BF16_TOL)
    assert np.min(np.sum(port * ref, axis=-1)) >= BF16_MIN_COS


def _trajectory():
    """Six distinct places of one world, then a displaced revisit of
    place 0 (test_trained_cosplace.py's detection scene)."""
    world = make_world(555, n=160)
    xys = [(-2.4, -1.8), (-1.2, 0.9), (0.0, -0.6), (1.2, 1.5),
           (2.4, -1.2), (-2.0, 1.8)]
    imgs = [render_view(world, xy, np.random.default_rng(100 + i))
            for i, xy in enumerate(xys)]
    imgs.append(render_view(world, (-2.32, -1.72),
                            np.random.default_rng(7), jitter_t=0.0,
                            jitter_yaw=0.0))
    return imgs


def _publish_keyframes(P, bus, images):
    for kid, im in enumerate(images):
        bus.publish("cslam/keyframe_data", P.msgs.KeyframeRGB.from_image(
            kid, im))


def _component_run(P, technique, images, batch_size):
    router = P.bus.InProcessRouter()
    bus = P.bus.InProcessBus(router, 0)
    got = []
    router.subscribe("/r0/cslam/processed_global_descriptor", got.append)
    gdc = P.gdc.GlobalDescriptorComponent(
        {"robot_id": 0, "max_nb_robots": 1,
         "frontend.global_descriptor_technique": technique,
         "frontend.nn_checkpoint": "shipped"}, bus, batch_size=batch_size,
        **P.kw)
    _publish_keyframes(P, bus, images)
    router.spin_until_idle()
    n_full = len(got)
    assert gdc.tick() == len(images) - n_full  # the partial batch
    router.spin_until_idle()
    return gdc, got, n_full


@pytest.mark.parametrize("technique", ["cosplace", "netvlad"])
def test_global_descriptor_component_config_path(technique):
    """The config-driven construction builds the technique's model with
    the shipped weights on the requested device; full batches publish on
    arrival, the partial one on tick; both packages publish the same
    keyframes with descriptors within the bf16 tolerance."""
    world = make_world(99, n=160)
    rng = np.random.default_rng(0)
    images = [render_view(world, xy, rng)
              for xy in [(-1.0, 0.0), (1.5, 1.0), (0.2, -1.1)]]
    tgdc_, tgot, tfull = _component_run(PORT, technique, images, 2)
    jgdc_, jgot, jfull = _component_run(JAX, technique, images, 2)
    cls = CosPlace if technique == "cosplace" else NetVLAD
    assert isinstance(tgdc_.model, cls) and tgdc_.model.enabled
    assert tgdc_.model.device == torch.device("cpu")
    assert tfull == jfull == 2 and len(tgot) == len(jgot) == 3
    assert [(m.keyframe_id, m.robot_id) for m in tgot] == \
        [(m.keyframe_id, m.robot_id) for m in jgot] == \
        [(0, 0), (1, 0), (2, 0)]
    d = np.stack([np.asarray(m.descriptor) for m in tgot])
    assert d.dtype == np.float32
    assert d.shape == (3, 64 if technique == "cosplace" else 128)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)
    # different places must not collapse to the same descriptor
    assert float(d[0] @ d[1]) < 0.99
    _close(d, np.stack([np.asarray(m.descriptor) for m in jgot]))


class _Recorder:
    """A descriptor model that records what reaches it."""

    def __init__(self, batched):
        self.seen = []
        if batched:
            self.compute_embeddings_batch = self._batch

    def _batch(self, images):
        self.seen.append(np.array(images))
        return np.ones((len(images), 4), np.float32)

    def compute_embedding(self, image):
        self.seen.append(np.array(image))
        return np.ones(4, np.float32)


@pytest.mark.parametrize("batched", [True, False])
def test_grey_keyframes_reach_the_model_as_the_reference(batched):
    """Grey keyframes are broadcast to 3 channels for a batched model;
    a per-image model gets the message's image; both packages alike."""
    rng = np.random.default_rng(1)
    grey = rng.integers(0, 255, (2, 12, 16), dtype=np.uint8)
    rgb = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
    seen = {}
    for name, P in (("port", PORT), ("jax", JAX)):
        router = P.bus.InProcessRouter()
        bus = P.bus.InProcessBus(router, 0)
        model = _Recorder(batched)
        gdc = P.gdc.GlobalDescriptorComponent({"robot_id": 0}, bus,
                                              model=model, batch_size=3)
        _publish_keyframes(P, bus, [grey[0], grey[1], rgb])
        router.spin_until_idle()
        assert gdc.pending == []
        seen[name] = model.seen
    assert len(seen["port"]) == len(seen["jax"])
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    if batched:
        batch = seen["port"][0]
        assert batch.shape == (3, 12, 16, 3)
        np.testing.assert_array_equal(batch[0, ..., 2], grey[0])


def test_loop_closure_detection_with_trained_descriptors():
    """Descriptors from the shipped CNN drive the port's descriptor
    database: the revisit keyframe matches its original keyframe; the
    descriptors agree with the reference's within the bf16 tolerance."""
    imgs = _trajectory()
    batch = np.stack([np.broadcast_to(im[..., None], im.shape + (3,))
                      for im in imgs])
    embs = CosPlace({"frontend.nn_checkpoint": "shipped"},
                    device="cpu").compute_embeddings_batch(batch)
    ref = JaxCosPlace({"frontend.nn_checkpoint":
                       "shipped"}).compute_embeddings_batch(batch)
    _close(embs, ref)
    for db in (DescriptorDatabase(dim=64, method="pallas", device="cpu"),
               DescriptorDatabase(dim=64, method="exact", device="cpu")):
        for i, e in enumerate(embs[:-1]):
            db.add_item(e, (0, i))
        best, sim = db.search_best(embs[-1])
        assert best == (0, 0), f"revisit matched keyframe {best} (sim {sim})"
    jdb = JaxDescriptorDatabase(dim=64)
    for i, e in enumerate(ref[:-1]):
        jdb.add_item(e, (0, i))
    assert jdb.search_best(ref[-1])[0] == (0, 0)


def _detector_params():
    return {
        "robot_id": 0,
        "max_nb_robots": 2,
        "frontend.global_descriptor_technique": "cosplace",
        "frontend.nn_checkpoint": "shipped",
        "frontend.similarity_threshold": 0.8,
        "frontend.nb_best_matches": 5,
        "frontend.intra_loop_min_inbetween_keyframes": 2,
        "frontend.enable_intra_robot_loop_closures": True,
        "frontend.detection_publication_max_elems_per_msg": 10,
        "frontend.enable_sparsification": True,
        "frontend.inter_robot_loop_closure_budget": 5,
        "frontend.use_vertex_cover_selection": True,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
    }


def _detection_run(P):
    router = P.bus.InProcessRouter()
    bus = P.bus.InProcessBus(router, 0)
    det = P.lcd.GlobalDescriptorLoopClosureDetection(
        _detector_params(), bus, P.bus.ManualClock(), **P.kw)
    P.gdc.GlobalDescriptorComponent(_detector_params(), bus, batch_size=7,
                                    model=det.global_descriptor)
    matches = []
    router.subscribe("/r0/cslam/local_keyframe_match", matches.append)
    _publish_keyframes(P, bus, _trajectory())
    router.spin_until_idle()
    return det, [(m.keyframe0_id, m.keyframe1_id) for m in matches]


def test_detector_builds_cosplace_from_params():
    """No descriptor_model: the detector constructs CosPlace from params
    (shipped weights, on the detector's device). Keyframes through the
    component with that model reach the detector as published
    descriptors; the revisit is found as an intra-robot loop closure,
    as on the reference."""
    det, port = _detection_run(PORT)
    model = det.global_descriptor
    assert isinstance(model, CosPlace) and model.enabled
    assert model.device == torch.device("cpu")
    assert next(model.model.parameters()).device == torch.device("cpu")
    assert len(det.lcm.local_nnsm) == 7
    jdet, ref = _detection_run(JAX)
    assert isinstance(jdet.global_descriptor, JaxCosPlace)
    assert port == ref == [(6, 0)]
