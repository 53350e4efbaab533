"""The port on an NVIDIA card: the CUDA kernel against its plain version
(at the slice's 512-d and the descriptor models' 64-d and 128-d), the
kernel behind DescriptorDatabase(method="pallas"), the slice on the
card against the same slice on the CPU, the sim mission through
SwarmNode on the card against the same mission on the CPU, and the
place-recognition models (shipped weights) on the card against the
same models on the CPU, and the visual slice (SuperPoint, LightGlue,
RANSAC, PnP, stereo, the top-k tie rule, the visual mission) and the
lidar slice (voxel grid, Scan Context, FPFH, GNC-ICP, registration at
8192 points, the lidar mission) on the card against the CPU.

Every test here needs a card: marked `cuda`, skipped (in a fixture, not
at import) where there is none. On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: similarities 1e-5 in f32 and 1e-4 in bf16 (same inputs, only
the summation order differs); every returned index must carry the plain
similarity of its slot (ties may pick either row). Model descriptors:
those of tests/test_torch_models.py (f32 max abs 1e-5; bf16 max abs
2e-3 and cosine >= 0.9999: cuDNN and the CPU round bf16 convs at other
places).
"""

import numpy as np
import pytest
import torch

from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.ops import knn_pallas as kp
from cslam_tpu_torch.swarm_slice import run_slice

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_search(idx, val, data, n_valid, queries, k, dtype):
    """The kernel's (idx, val) against the plain version on the same
    inputs: same values within TOL, every index carries its plain
    similarity (ties may pick either row), no repeated or padded row,
    missing slots -3e38 / 0."""
    inv, bias, q_n = kp.prepare_inputs(data, n_valid, queries)
    idx_p, val_p = kp.cosine_topk_plain(data, n_valid, q_n, inv, bias, k)
    torch.cuda.synchronize()
    assert idx.shape == val.shape == (queries.shape[0], k)
    torch.testing.assert_close(val, val_p, rtol=0, atol=TOL[dtype])
    n_eff = min(k, n_valid)
    full = (q_n.float() @ data.float().T) * inv + bias
    got = torch.gather(full, 1, idx[:, :n_eff].long())
    torch.testing.assert_close(got, val[:, :n_eff], rtol=0, atol=TOL[dtype])
    srt = torch.sort(idx[:, :n_eff], dim=1)[0]
    assert not bool((srt[:, 1:] == srt[:, :-1]).any())
    assert bool((idx[:, :n_eff] < n_valid).all())
    assert bool((val[:, n_eff:] == kp.NEG_LARGE).all())
    assert bool((idx[:, n_eff:] == 0).all())


def _search(cuda, n_cap, n_valid, dim, batch, k, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    data = torch.randn((n_cap, dim), generator=gen, device=cuda).to(dtype)
    queries = torch.randn((batch, dim), generator=gen, device=cuda)
    before = sum(kp.cosine_topk_pallas.launches.values())
    idx, val = kp.cosine_topk_pallas(data, n_valid, queries, k)
    assert sum(kp.cosine_topk_pallas.launches.values()) == before + 1
    return data, queries, idx, val


@pytest.mark.parametrize("n_cap,n_valid,dim,batch,k,dtype", [
    (1024, 1, 512, 1, 1, torch.float32),
    (1024, 7, 512, 1, 10, torch.float32),
    (1024, 513, 512, 1, 10, torch.float32),
    (1024, 1000, 512, 1, 1, torch.float32),
    (1024, 5, 512, 3, 10, torch.float32),
    (1024, 5, 512, 3, 10, torch.bfloat16),
    (8192, 8000, 96, 40, 64, torch.float32),
    (16384, 12345, 512, 256, 10, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, n_cap, n_valid, dim, batch, k, dtype):
    data, queries, idx, val = _search(cuda, n_cap, n_valid, dim, batch, k,
                                      dtype, n_valid)
    _check_search(idx, val, data, n_valid, queries, k, dtype)


@pytest.mark.parametrize("batch", [1, 15, 16, 17, 65, 256])
@pytest.mark.parametrize("dim", [33, 96, 512])
def test_kernel_bf16_mma_matches_plain(cuda, batch, dim):
    """The tensor-core path at ragged batch (around its 16- and 64-query
    blocks), depth (33: the masked scalar loads) and n_valid (inside a
    128-row tile)."""
    n_valid = 3001 + 7 * batch
    data, queries, idx, val = _search(cuda, 4096, n_valid, dim, batch, 10,
                                      torch.bfloat16, batch * 1000 + dim)
    _check_search(idx, val, data, n_valid, queries, 10, torch.bfloat16)


@pytest.mark.parametrize("batch", [1, 3, 4, 5])
@pytest.mark.parametrize("dim", [33, 96, 1500])
def test_kernel_f32_small_batch_matches_plain(cuda, batch, dim):
    """The f32 path around its B <= 4 row-streaming variant: ragged depth
    (33: scalar loads; 1500: more than one staged depth chunk) and
    n_valid inside a tile."""
    n_valid = 2001 + 5 * batch
    data, queries, idx, val = _search(cuda, 4096, n_valid, dim, batch, 10,
                                      torch.float32, batch * 100 + dim)
    _check_search(idx, val, data, n_valid, queries, 10, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_valid,k", [(5000, 65), (5000, 200), (150, 200)])
def test_kernel_serves_k_above_one_pass(cuda, dtype, n_valid, k):
    """k > KMAX in ceil(k / KMAX) passes: one search, exact top-k, and
    k > n_valid pads with missing slots."""
    data, queries, idx, val = _search(cuda, 8192, n_valid, 96, 5, k, dtype,
                                      k + n_valid)
    _check_search(idx, val, data, n_valid, queries, k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_duplicate_rows_keep_the_lower_row(cuda, dtype):
    """Exact duplicate rows tie exactly: the lower row comes first, also
    across a pass boundary (k = 100 over 40 rows repeated 3 times)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    base = torch.randn((40, 64), generator=gen, device=cuda).to(dtype)
    data = torch.cat([base, base, base, torch.zeros((8, 64), device=cuda,
                                                    dtype=dtype)])
    queries = torch.randn((3, 64), generator=gen, device=cuda)
    idx, val = kp.cosine_topk_pallas(data, 120, queries, 100)
    _check_search(idx, val, data, 120, queries, 100, dtype)
    idx, val = idx.cpu().numpy(), val.cpu().numpy()
    for b in range(3):
        for j in range(99):
            assert val[b, j] >= val[b, j + 1]
            if val[b, j] == val[b, j + 1]:
                assert idx[b, j] < idx[b, j + 1], (b, j)
        # each base row's three copies come out together, lowest first
        for j in range(0, 99, 3):
            assert list(idx[b, j:j + 3] % 40) == [idx[b, j] % 40] * 3
            assert list(idx[b, j:j + 3]) == sorted(idx[b, j:j + 3])


def test_kernel_back_to_back_searches_reset_their_counters(cuda):
    """Two searches of different shapes, then the first again, queued on
    one stream without a synchronize: each last block resets its query
    block's counter for the next launch."""
    shapes = [(20000, 19000, 256, 70, 10, torch.bfloat16),
              (4096, 4000, 64, 3, 5, torch.float32),
              (20000, 19000, 256, 70, 10, torch.bfloat16)]
    inputs, outs = [], []
    for i, (n_cap, n_valid, dim, batch, k, dtype) in enumerate(shapes):
        gen = torch.Generator(device=cuda).manual_seed(100 + i)
        data = torch.randn((n_cap, dim), generator=gen,
                           device=cuda).to(dtype)
        queries = torch.randn((batch, dim), generator=gen, device=cuda)
        inputs.append((data, n_valid, queries, k, dtype))
    torch.cuda.synchronize()
    for data, n_valid, queries, k, _ in inputs:
        outs.append(kp.cosine_topk_pallas(data, n_valid, queries, k))
    for (data, n_valid, queries, k, dtype), (idx, val) in zip(inputs, outs):
        _check_search(idx, val, data, n_valid, queries, k, dtype)


def test_kernel_rejects_what_it_does_not_take(cuda):
    """k = KMAX + 1 is served (two passes); other dtypes and layouts are
    refused."""
    data = torch.randn((256, 32), device=cuda)
    q = torch.randn((2, 32), device=cuda)
    idx, val = kp.cosine_topk_pallas(data, 100, q, kp.KMAX + 1)
    _check_search(idx, val, data, 100, q, kp.KMAX + 1, torch.float32)
    with pytest.raises(TypeError):
        kp.cosine_topk_pallas(data.half(), 100, q, 5)
    with pytest.raises(ValueError):
        kp.cosine_topk_pallas(data.T.contiguous().T, 100, q, 5)


def test_descriptor_database_kernel_matches_exact(cuda):
    rng = np.random.default_rng(0)
    db_k = DescriptorDatabase(dim=64, capacity=64, method="pallas",
                              device=cuda)
    db_e = DescriptorDatabase(dim=64, capacity=64, method="exact",
                              device=cuda)
    assert DescriptorDatabase(device=cuda).method == "pallas"  # "auto"
    for i in range(300):
        v = rng.standard_normal(64)
        db_k.add_item(v, i)
        db_e.add_item(v, i)
    before = kp.cosine_topk_pallas.launches["cosine_topk_f32"]
    for _ in range(10):
        q = rng.standard_normal(64)
        items_k, sims_k = db_k.search(q, 10)
        items_e, sims_e = db_e.search(q, 10)
        assert items_k == items_e
        np.testing.assert_allclose(sims_k, sims_e, atol=1e-5)
    assert kp.cosine_topk_pallas.launches["cosine_topk_f32"] == before + 10


def test_descriptor_database_bf16_kernel_matches_plain(cuda):
    """bf16 storage: the tensor-core kernel on the card against the same
    function's plain version on the CPU (1e-4, tie-aware: an index that
    differs must carry a tied similarity), and against the exact path
    within the reference's own bound between its two bf16 lowerings
    (5e-3: the exact path rounds the raw query to bf16, the kernel the
    normalized one)."""
    rng = np.random.default_rng(1)
    dbs = [DescriptorDatabase(dim=512, method=m, storage="bfloat16",
                              device=d)
           for m, d in (("pallas", cuda), ("pallas", "cpu"),
                        ("exact", cuda))]
    for i in range(1500):
        v = rng.standard_normal(512)
        for db in dbs:
            db.add_item(v, i)
    before = kp.cosine_topk_pallas.launches["cosine_topk_bf16_mma"]
    for _ in range(10):
        q = rng.standard_normal(512)
        (items_k, sims_k), (items_p, sims_p), (_, sims_e) = [
            db.search(q, 10) for db in dbs]
        np.testing.assert_allclose(sims_k, sims_p, atol=1e-4)
        for a, b, s in zip(items_k, items_p, sims_p):
            if a != b:
                assert np.sum(np.abs(sims_p - s) <= 1e-4) > 1
        np.testing.assert_allclose(sims_k, sims_e, atol=5e-3)
    qs = rng.standard_normal((20, 512))
    (items_k, sims_k), (items_p, sims_p), _ = [db.batch_search(qs, 3)
                                               for db in dbs]
    assert np.asarray(items_k).shape == (20, 3)
    np.testing.assert_allclose(sims_k, sims_p, atol=1e-4)
    assert kp.cosine_topk_pallas.launches["cosine_topk_bf16_mma"] == \
        before + 11


def test_slice_on_card_matches_cpu(cuda):
    kw = dict(n_robots=2, n_poses=24, descriptor_dim=32, seed=0, rounds=4,
              nns_method="pallas")
    on_card = run_slice(device=cuda, **kw)
    on_cpu = run_slice(device="cpu", **kw)
    assert [c[:4] for c in on_card["candidates"]] == \
        [c[:4] for c in on_cpu["candidates"]]
    assert on_card["loop_closures"] == on_cpu["loop_closures"]
    assert on_card["ate_opt"] == pytest.approx(on_cpu["ate_opt"], abs=1e-3)
    assert on_card["ate_opt"] < on_card["ate_odom"]


def test_mission_on_card(cuda):
    """The sim mission through SwarmNode on the card (2 robots x 24
    keyframes): descriptor searches launch the kernel, the optimizer
    solves, the estimate beats odometry, no worker thread is left; the
    same mission on the CPU verifies the same loop closures."""
    import threading
    from cslam_tpu_torch.sim_mission import run_mission
    for name in kp.cosine_topk_pallas.launches:
        kp.cosine_topk_pallas.launches[name] = 0
    on_card = run_mission(2, 24, device=cuda)
    assert kp.cosine_topk_pallas.launches["cosine_topk_f32"] > 0
    assert on_card["optimization_count"][0] >= 1
    odo, opt = on_card["ate"][1]
    assert opt < odo
    assert not [t for t in threading.enumerate()
                if t is not threading.main_thread() and not t.daemon]
    on_cpu = run_mission(2, 24, device="cpu")
    assert on_card["fixed_edges"] == on_cpu["fixed_edges"]
    assert opt == pytest.approx(on_cpu["ate"][1][1], abs=1e-3)


# ----------------------------------------------------------------------
# The descriptor models' shapes: D = 64 (CosPlace) and D = 128 (NetVLAD
# after PCA), one query (the detector) or a batch (the recall check)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("batch,k", [(1, 1), (1, 10), (64, 1), (64, 10)])
@pytest.mark.parametrize("n_valid", [48, 1000])
def test_kernel_at_descriptor_dims_matches_plain(cuda, dtype, dim, batch, k,
                                                 n_valid):
    data, queries, idx, val = _search(cuda, 1024, n_valid, dim, batch, k,
                                      dtype, dim * 7 + batch + k + n_valid)
    _check_search(idx, val, data, n_valid, queries, k, dtype)


def test_resolve_device_turns_tf32_off(cuda):
    """Both TF32 switches, matrix products and cuDNN convolutions, are
    off after resolve_device, and the check passes."""
    from cslam_tpu_torch.device import require_full_fp32, resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(RuntimeError, match="allow_tf32"):
        require_full_fp32(cuda)
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    require_full_fp32(cuda)


MODEL_TOL = {"f32": (1e-5, None), "bf16": (2e-3, 0.9999)}


def _views(n=8):
    from cslam_tpu_torch.models.train_cosplace import make_world, \
        render_places
    imgs, _ = render_places(np.random.default_rng(5), make_world(77), n // 2,
                            2, 0.35, 0.06)
    return imgs


def _assert_close(card, cpu, dtype):
    atol, min_cos = MODEL_TOL[dtype]
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=0, atol=atol)
    if min_cos is not None:
        assert np.min(np.sum(card * cpu, axis=1)) >= min_cos


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["cosplace", "netvlad"])
def test_model_on_card_matches_cpu(cuda, which, dtype):
    """The shipped CosPlace (crop 224) and NetVLAD with PCA (crop 128) on
    the card against the same wrapper on the CPU, same 8 renders."""
    from cslam_tpu_torch.models.cosplace import CosPlace, \
        GeoLocalizationNet
    from cslam_tpu_torch.models.netvlad import NetVLAD, NetVLADNet

    def wrapper(device):
        w = (CosPlace if which == "cosplace" else NetVLAD)(
            {"frontend.nn_checkpoint": "shipped"}, device=device)
        if dtype == "f32":  # same weights, convs in f32
            net = GeoLocalizationNet(dtype=torch.float32) \
                if which == "cosplace" else NetVLADNet(dtype=torch.float32)
            net.load_state_dict(w.model.state_dict())
            w.model = net.eval().to(w.device)
        return w

    views = _views()
    card = wrapper(cuda)
    assert next(card.model.parameters()).is_cuda
    on_card = card.compute_embeddings_batch(views)
    on_cpu = wrapper("cpu").compute_embeddings_batch(views)
    assert on_card.shape == (8, 64 if which == "cosplace" else 128)
    _assert_close(on_card, on_cpu, dtype)


def test_descriptor_path_on_card(cuda):
    """Keyframes -> GlobalDescriptorComponent (config path, shipped
    CosPlace on the card) -> published descriptors -> a detector built
    from params (no descriptor_model) on the card: the revisit of each
    view is found through the kernel."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend.global_descriptor_component import \
        GlobalDescriptorComponent
    from cslam_tpu_torch.frontend.loop_closure_detection import \
        GlobalDescriptorLoopClosureDetection
    from cslam_tpu_torch.models.cosplace import CosPlace
    params = {"robot_id": 0, "max_nb_robots": 2,
              "frontend.global_descriptor_technique": "cosplace",
              "frontend.nn_checkpoint": "shipped",
              "frontend.similarity_threshold": 0.8,
              "frontend.nb_best_matches": 5,
              "frontend.intra_loop_min_inbetween_keyframes": 2,
              "frontend.enable_intra_robot_loop_closures": True,
              "frontend.inter_robot_loop_closure_budget": 5,
              "neighbor_management.enable_neighbor_monitoring": False,
              "neighbor_management.init_delay_sec": 0.0,
              "neighbor_management.max_heartbeat_delay_sec": 5.0}
    router = InProcessRouter()
    bus = InProcessBus(router, 0)
    gdc = GlobalDescriptorComponent(params, bus, batch_size=4, device=cuda)
    det = GlobalDescriptorLoopClosureDetection(params, bus, ManualClock(),
                                               device=cuda)
    assert isinstance(det.global_descriptor, CosPlace)
    assert next(det.global_descriptor.model.parameters()).is_cuda
    matches = []
    router.subscribe("/r0/cslam/local_keyframe_match", matches.append)
    views = _views()
    before = kp.cosine_topk_pallas.launches["cosine_topk_f32"]
    # every view twice, 4 keyframes apart
    for kid, im in enumerate(list(views[::2]) * 2):
        bus.publish("cslam/keyframe_data",
                    msgs.KeyframeRGB.from_image(kid, im[..., 0]))
    router.spin_until_idle()
    gdc.tick()
    router.spin_until_idle()
    assert len(det.lcm.local_nnsm) == 8
    assert kp.cosine_topk_pallas.launches["cosine_topk_f32"] == before + 8
    assert [(m.keyframe0_id, m.keyframe1_id) for m in matches] == \
        [(4, 0), (5, 1), (6, 2), (7, 3)]


# -- visual verification (the visual phase's card-against-CPU gates) --------

def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_visual_models_and_ransac_on_card_match_cpu(cuda):
    """SuperPoint (f32: identical keypoints, 1e-5; bf16: 2e-3 descriptors,
    3e-3 heatmap, cosine 0.9999) on 8 keyframes, and LightGlue (f32 scores
    1e-4, identical matches), ransac_rigid3d and ransac_pnp (identical
    inliers, pose 1e-4) on 8 pairs, card against CPU, each bound exceeded
    by its lower-precision control (bf16 heads, TF32 products):
    chip_smoke.py's visual-phase check."""
    out = _chip_smoke().check_visual_on_card(cuda)
    assert out["pairs"] == 8 and out["successes"]["ransac"] > 0


def test_stereo_on_card_matches_cpu(cuda):
    """Scan-line ZNCC on the card against the CPU: validity identical,
    disparities within 1e-4 px."""
    from cslam_tpu_torch.ops.stereo import stereo_correspondences
    rng = np.random.default_rng(4)
    tex = np.kron(rng.uniform(0, 1, (32, 42)).astype(np.float32),
                  np.ones((4, 4), np.float32))
    left, right = tex[:120, :160], tex[:120, 5:165]
    ys, xs = np.meshgrid(np.arange(12, 108, 8), np.arange(12, 148, 8),
                         indexing="ij")
    xy = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    mask = np.ones(len(xy), np.float32)
    out = {}
    for dev in ("cpu", cuda):
        d, v = stereo_correspondences(*(torch.from_numpy(
            np.ascontiguousarray(a)).to(dev) for a in (left, right, xy,
                                                       mask)),
            max_disparity=32)
        out[str(dev)] = (d.cpu().numpy(), v.cpu().numpy())
    (d_c, v_c), (d_r, v_r) = out[str(cuda)], out["cpu"]
    np.testing.assert_array_equal(v_c, v_r)
    np.testing.assert_allclose(d_c, d_r, rtol=0, atol=1e-4)
    assert v_r.sum() > 10


def test_top_k_padded_slots_on_card_match_cpu(cuda):
    """Fewer NMS maxima than the keypoint budget: the padded slots
    (score -inf) hold the lowest pixel indices, on the card as on the
    CPU (torch.topk promises no order among ties; the port's top_k is a
    stable sort)."""
    from cslam_tpu_torch.ops import features
    img = np.full((120, 160), 0.5, np.float32)
    img[40:50, 60:70] = 1.0
    img[80:90, 20:35] = 0.0
    out = {}
    for dev in ("cpu", cuda):
        xy, _, mask = features.detect_keypoints(
            torch.from_numpy(img).to(dev), max_keypoints=64)
        out[str(dev)] = (xy.cpu().numpy(), mask.cpu().numpy())
    (xy_c, m_c), (xy_r, m_r) = out[str(cuda)], out["cpu"]
    assert 0 < m_r.sum() < 64
    np.testing.assert_array_equal(m_c, m_r)
    np.testing.assert_array_equal(xy_c, xy_r)
    x = torch.full((4096,), -torch.inf, device=cuda)
    x[[7, 100, 3000]] = torch.tensor([1.0, 2.0, 1.0], device=cuda)
    vals, idx = features.top_k(x, 10)
    assert idx.tolist() == [100, 7, 3000, 0, 1, 2, 3, 4, 5, 6]


def test_visual_mission_on_card(cuda):
    """The learned visual mission (2 robots x 8 poses) on the card: the
    same keyframes as on the CPU, the kernel launched, every evaluated
    robot's ATE below its odometry's."""
    from cslam_tpu_torch.visual_mission import run_visual_mission
    before = kp.cosine_topk_pallas.launches["cosine_topk_f32"]
    card = run_visual_mission(2, 8, device=cuda)
    assert kp.cosine_topk_pallas.launches["cosine_topk_f32"] > before
    cpu = run_visual_mission(2, 8, device="cpu")
    assert card["keyframe_poses"] == cpu["keyframe_poses"]
    assert card["inter_loop_closures"]
    for odo, opt in card["ate"].values():
        assert opt < odo


# -- the lidar path (the lidar phase's card-against-CPU gates) -------------------

def test_lidar_ops_on_card_match_cpu(cuda):
    """The lidar phase's keyframe pairs at the handler's 8192-point
    capacity: voxel grid (identical keep masks, centroids 1e-6, bitwise
    equal across two card runs), Scan Contexts (at most one flipped cell
    per keyframe, within one ulp of an edge; same yaw and best match),
    FPFH (>= 99.5% of rows with agreeing neighbours, 1e-4), GNC-ICP and
    the closures the handler publishes through its intra- and
    inter-robot entry points (same success, poses within 1e-3):
    chip_smoke.py's lidar-phase check."""
    out = _chip_smoke().check_lidar_on_card(cuda)
    assert out["pairs"] == 4
    assert out["closures"]["intra_success"] > 0
    assert out["closures"]["inter_success"] > 0


def test_lidar_mission_on_card(cuda):
    """The lidar mission (2 robots x 8 poses of the reference's world) on
    the card: the same keyframes and loop closures as on the CPU, no
    cosine top-k launch."""
    from cslam_tpu_torch.lidar_mission import run_lidar_mission
    before = dict(kp.cosine_topk_pallas.launches)
    card = run_lidar_mission(2, 8, device=cuda)
    assert kp.cosine_topk_pallas.launches == before
    cpu = run_lidar_mission(2, 8, device="cpu")
    assert card["keyframe_poses"] == cpu["keyframe_poses"]
    assert card["inter_loop_closures"] == cpu["inter_loop_closures"]
    assert card["intra_loop_closures"] == cpu["intra_loop_closures"]


def test_lidar_branches_build_on_card(cuda):
    """make_sensor_handler with sensor_type lidar and a detector with the
    scancontext technique (no descriptor_model) build on the card; a
    keyframe published by the handler reaches the detector's Scan
    Context database there, with the CPU's embedding."""
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend import map_manager
    from cslam_tpu_torch.frontend.loop_closure_detection import \
        GlobalDescriptorLoopClosureDetection
    from cslam_tpu_torch.lidar_mission import DEFAULT_WORLD, LidarWorld, \
        make_params, make_pose
    params = make_params(0, 2)
    router = InProcessRouter()
    bus = InProcessBus(router, 0)
    handler = map_manager.make_sensor_handler(params, bus, ManualClock(),
                                              device=cuda)
    det = GlobalDescriptorLoopClosureDetection(params, bus, ManualClock(),
                                               device=cuda)
    assert type(handler).__name__ == "LidarHandler"
    assert type(det.global_descriptor).__name__ == "ScanContextModel"
    assert det.global_descriptor.device.type == "cuda"
    assert det.lcm.local_nnsm.data.device.type == "cuda"
    pose = make_pose(0.0)
    scan = LidarWorld(*DEFAULT_WORLD).scan(pose, np.random.default_rng(0))
    handler.add_sensor_data(scan, pose)
    assert handler.process_new_sensor_data() == 0
    router.spin_until_idle()
    assert det.lcm.local_nnsm.nb_items == 1
    from cslam_tpu_torch.frontend.lidar_handler import ScanContextModel
    np.testing.assert_array_equal(
        det.lcm.local_nnsm.data[0].cpu().numpy(),
        ScanContextModel(device="cpu").compute_embedding(
            handler.local_keyframes[0]))
