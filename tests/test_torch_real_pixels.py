"""Port counterparts of the real-pixel and trained-weight gates, on the
CPU: tests/test_real_pixels.py (the reader on real_seq's KITTI layout,
the shipped SuperPoint firing on real frames, the verified intra-robot
and inter-robot revisits with the reference's pose tolerances, CosPlace
and NetVLAD ranking the revisit), tests/test_tum_sequence.py (the TUM
reader's association and depth, the handler's revisit through the TUM
path), tests/test_trained_netvlad.py's three gates, and the three gates
of tests/test_trained_weights.py that need synthetic_shapes (corner
recall, warp-consistent matching, detector domain breadth).

The real-pixel gates are chip_smoke.py's functions, which its tooling
phase runs on the card; here they run with device="cpu". The
thresholds are the reference tests' own: pose errors below 0.05 rad
and 0.08 m, >= 60 keypoints per real frame, recall@1 >= 0.9, PCA top-1
agreement >= 0.8, corner recall and warp precision >= 0.5, domain
breadth minimum >= 30 / median >= 40 per background, blob scenes >= 40,
real frames >= 100 keypoints.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import chip_smoke  # noqa: E402

from cslam_tpu_torch.models import zoo  # noqa: E402
from cslam_tpu_torch.models.superpoint import SuperPoint  # noqa: E402
from cslam_tpu_torch.models.synthetic_shapes import (  # noqa: E402
    apply_homography, make_pair_sample, render_shapes)

torch.set_num_threads(1)

SP_CKPT = zoo.shipped_checkpoint("superpoint_synth.npz")
needs_weights = pytest.mark.skipif(not SP_CKPT, reason="no shipped weights")
needs_nv = pytest.mark.skipif(
    not zoo.shipped_checkpoint("netvlad_synth.npz"),
    reason="no shipped netvlad weights")


@pytest.fixture(scope="module")
def superpoint():
    return SuperPoint(checkpoint=SP_CKPT, max_keypoints=128, device="cpu")


def test_reader_parses_kitti_layout():
    assert chip_smoke.check_real_reader()["frames"] == 16


@needs_weights
def test_superpoint_fires_on_real_pixels():
    assert min(chip_smoke.check_superpoint_real_pixels("cpu")) >= 60


@needs_weights
def test_intra_robot_revisit_on_real_pixels():
    angle, err = chip_smoke.check_real_intra_revisit("cpu")
    assert angle < 0.05 and err < 0.08


@needs_weights
def test_inter_robot_verified_revisit_on_real_pixels():
    angle, err = chip_smoke.check_real_inter_revisit("cpu")
    assert angle < 0.05 and err < 0.08


@needs_weights
@needs_nv
def test_place_models_separate_revisit_on_real_pixels():
    out = chip_smoke.check_real_place_models("cpu")
    assert out["cosplace"][0] > 0.9


@needs_weights
def test_tum_reader_and_handler_revisit(tmp_path):
    root = chip_smoke.write_tum_dir(tmp_path / "tum")
    angle, err = chip_smoke.check_tum_gates("cpu", root)
    assert angle < 0.05 and err < 0.08


# tests/test_trained_netvlad.py


@pytest.fixture(scope="module")
def netvlad():
    from cslam_tpu_torch.models.netvlad import NetVLAD
    return NetVLAD({"frontend.nn_checkpoint": "shipped"}, device="cpu")


@needs_nv
def test_netvlad_wrapper_resolves_shipped_checkpoint_and_pca(netvlad):
    assert netvlad.enabled
    assert netvlad.checkpoint.endswith("netvlad_synth.npz")
    assert netvlad.pca_components is not None


@needs_nv
def test_netvlad_recall_at_1_on_held_out_world(netvlad):
    from cslam_tpu_torch.models.train_cosplace import make_world, \
        render_view, sample_places
    hits = total = 0
    for w in range(3):
        rng = np.random.default_rng(31337 + w)
        world = make_world(31337 + 17 * w, n=160)
        imgs, labels = [], []
        for pid, xy in enumerate(sample_places(rng, 16)):
            for _ in range(2):
                g = int(rng.integers(2**31))
                im = render_view(world, xy, np.random.default_rng(g),
                                 jitter_t=0.35, jitter_yaw=0.06)
                imgs.append(np.broadcast_to(im[..., None], im.shape + (3,)))
                labels.append(pid)
        emb = netvlad.compute_embeddings_batch(np.stack(imgs))
        labels = np.asarray(labels)
        sim = emb @ emb.T
        np.fill_diagonal(sim, -np.inf)
        hits += int((labels[sim.argmax(axis=1)] == labels).sum())
        total += len(labels)
    assert hits / total >= 0.9, hits / total


@needs_nv
def test_netvlad_pca_preserves_ranking(netvlad):
    from cslam_tpu_torch.models.cosplace import embed
    from cslam_tpu_torch.models.train_cosplace import make_batch, make_world
    rng = np.random.default_rng(777)
    world = make_world(888, n=160)
    batch, _ = make_batch(rng, world, 12, 2, 0.3, 0.05, netvlad.crop_size)
    full = embed(netvlad.model, batch, netvlad.device)
    mean = netvlad.pca_mean.numpy()
    comps = netvlad.pca_components.numpy()
    proj = (full - mean) @ comps.T
    proj = proj / np.maximum(np.linalg.norm(proj, axis=-1, keepdims=True),
                             1e-12)
    top1 = {}
    for name, emb in (("full", full), ("proj", proj)):
        sim = emb @ emb.T
        np.fill_diagonal(sim, -np.inf)
        top1[name] = sim.argmax(axis=1)
    assert float((top1["full"] == top1["proj"]).mean()) >= 0.8


# tests/test_trained_weights.py's gates that need synthetic_shapes


@needs_weights
def test_superpoint_detects_synthetic_corners(superpoint):
    rng = np.random.default_rng(777)  # not a training seed
    hits = total = 0
    for _ in range(6):
        img, corners = render_shapes(rng, 120, 160)
        if len(corners) < 4:
            continue
        xy, _, _, mask = superpoint.extract_features(img)
        xy = xy.numpy()[mask.numpy() > 0]
        d = np.linalg.norm(corners[:, None, :] - xy[None, :, :], axis=-1)
        hits += int((d.min(axis=1) <= 4.0).sum())
        total += len(corners)
    assert total > 20
    assert hits / total >= 0.5, hits / total


@needs_weights
def test_superpoint_descriptors_match_across_warp(superpoint):
    rng = np.random.default_rng(778)
    good = selected = 0
    for _ in range(6):
        s = make_pair_sample(rng, 120, 160)
        xy0, d0, _, m0 = (a.numpy() for a in
                          superpoint.extract_features(s["img0"]))
        xy1, d1, _, m1 = (a.numpy() for a in
                          superpoint.extract_features(s["img1"]))
        v0, v1 = m0 > 0, m1 > 0
        if v0.sum() < 8 or v1.sum() < 8:
            continue
        sim = d0[v0] @ d1[v1].T
        b1 = sim.argmax(axis=1)
        b0 = sim.argmax(axis=0)
        mutual = b0[b1] == np.arange(sim.shape[0])
        warped = apply_homography(s["H"], xy0[v0])
        err = np.linalg.norm(warped - xy1[v1][b1], axis=-1)
        inb = (warped[:, 0] >= 0) & (warped[:, 0] < 160) & \
              (warped[:, 1] >= 0) & (warped[:, 1] < 120)
        sel = mutual & inb
        good += int((err[sel] <= 6.0).sum())
        selected += int(sel.sum())
    assert selected >= 30, selected
    assert good / selected >= 0.5, good / selected


@needs_weights
def test_detector_domain_breadth_gates(superpoint):
    from test_rgbd_handler import make_pose, render_scene
    for bg in ("black", "texture", "photo"):
        counts = []
        for seed in range(8):
            img, _ = render_shapes(np.random.default_rng(seed), 120, 160,
                                   background=bg, n_primitives=4)
            counts.append(int(superpoint.extract_features(img)[3].sum()))
        counts.sort()
        assert counts[0] >= 30, (bg, counts)
        assert counts[len(counts) // 2] >= 40, (bg, counts)
    rng = np.random.default_rng(0)
    blob_counts = []
    for k in range(6):
        img, _ = render_scene(make_pose(0.3 * k), rng)
        gray = np.asarray(img, np.float32)
        if gray.ndim == 3:
            gray = gray.mean(-1)
        if gray.max() > 1.5:
            gray = gray / 255.0
        blob_counts.append(int(superpoint.extract_features(
            gray.astype(np.float32))[3].sum()))
    assert min(blob_counts) >= 40, blob_counts
    for gray in chip_smoke.real_gray_frames((0, 5, 9, 14)):
        assert int(superpoint.extract_features(gray)[3].sum()) >= 100
