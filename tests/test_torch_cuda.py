"""The port on an NVIDIA card: the CUDA kernel against its plain version
(at the slice's 512-d and the descriptor models' 64-d and 128-d), the
kernel behind DescriptorDatabase(method="pallas") (its single-call
search against its torch path, bit for bit, and beside a busy default
stream), the slice on the
card against the same slice on the CPU, the sim mission through
SwarmNode on the card against the same mission on the CPU, and the
place-recognition models (shipped weights) on the card against the
same models on the CPU, and the visual slice (SuperPoint, LightGlue,
RANSAC, PnP, stereo, the top-k tie rule, the visual mission) and the
lidar slice (voxel grid, Scan Context, FPFH, GNC-ICP, registration at
8192 points, the lidar mission) on the card against the CPU; and the
multi-device layer: the row-sharded search through the kernel in every
rank and the factor-sharded solve against the single card, on meshes of
1 (NCCL) and 2 (gloo, sharing cuda:0) ranks, and of one rank per card
(NCCL) where there are 2 cards or more; and LightGlue's pair graph
against its eager forward at the stereo cell's K = 2,048 (scores, the
matches, captures per shape, each pair's own scores, a wrapper on the
instance's `scores`, weights loaded after a capture, a capture beside a
busy thread, TF32 captured apart).

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

import functools
import json

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


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [32, 64, 512])
def test_single_call_search_matches_torch_path(cuda, dim, storage):
    """The single-call search against the torch path on the same
    database: the same rows and similarities, bit for bit, at k in
    {1, 5, 64}, n from 1 to 2,100 (two capacity doublings), each search
    uploading the 0 to 10 rows staged since the last, and for batches of
    3 and 20; `knn.native_searches` counts every single-call search and
    every row is uploaded once. The call's function object keeps the GIL
    (a PYFUNCTYPE prototype) and the kernel library is loaded once."""
    import ctypes

    from cslam_tpu_torch import _build
    from cslam_tpu_torch.runtime.tracing import tracer

    rng = np.random.default_rng(dim)
    db = DescriptorDatabase(method="pallas", storage=storage, device=cuda)
    tracer.clear()
    tracer.enable(None)
    try:
        n, pending, native = 0, 1, 0
        while n < 2100:
            for _ in range(pending):
                db.add_item(rng.standard_normal(dim), n)
                n += 1
            q = rng.standard_normal(dim).astype(np.float32)
            for k in (1, 5, 64):
                idx, sims = db._search(q, k)
                native += 1
                assert db._flushed == db.n == n
                idx_t, sims_t = db._search_torch(
                    q.reshape(1, -1), min(k, db._capacity), min(k, n))
                np.testing.assert_array_equal(idx, idx_t)
                np.testing.assert_array_equal(sims.view(np.int32),
                                              sims_t.view(np.int32))
            pending = (pending + 1) % 11
        for batch in (3, 20):
            qs = rng.standard_normal((batch, dim)).astype(np.float32)
            idx, sims = db._search(qs, 5)
            native += 1
            idx_t, sims_t = db._search_torch(qs, 5, 5)
            np.testing.assert_array_equal(idx, idx_t)
            np.testing.assert_array_equal(sims.view(np.int32),
                                          sims_t.view(np.int32))
        counts = tracer.counter_totals()["knn"]
    finally:
        tracer.disable()
        tracer.clear()
    assert db._capacity == 4096
    assert counts["native_searches"] == native
    assert counts["flushed_rows"] == n
    assert "fallback_searches" not in counts
    assert db._card._fn._flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert type(_build._lib) is ctypes.CDLL
    assert _build.load_library() is _build._lib


def test_single_call_search_does_not_wait_for_the_default_stream(cuda):
    """A search (with staged rows to upload) issued while another thread
    keeps the legacy default stream busy for ~1.5 s returns at once, with
    the answer the torch path gives once that stream is free."""
    import threading
    import time

    rng = np.random.default_rng(2)
    db = DescriptorDatabase(dim=512, device=cuda)
    for i in range(300):
        db.add_item(rng.standard_normal(512), i)
    q = rng.standard_normal(512).astype(np.float32)
    db.search_best(q)  # the workspaces are made and the rows uploaded
    for i in range(5):
        db.add_item(rng.standard_normal(512), 300 + i)
    busy = threading.Event()

    def keep_default_stream_busy():
        torch.cuda._sleep(3_000_000_000)  # ~1.5 s of clock cycles
        busy.set()

    other = threading.Thread(target=keep_default_stream_busy)
    other.start()
    busy.wait()
    t = time.perf_counter()
    item, sim = db.search_best(q)
    seconds = time.perf_counter() - t
    still_busy = not torch.cuda.default_stream(cuda).query()
    other.join()
    torch.cuda.synchronize()
    assert still_busy, "the default stream's work ended before the search"
    assert seconds < 0.2, seconds
    idx_t, sims_t = db._search_torch(q.reshape(1, -1), 1, 1)
    assert item == int(idx_t[0, 0]) and sim == sims_t[0, 0]


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
        make_params
    from cslam_tpu_torch.mission import make_pose
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


# -- the launcher slice: solve_g2o and checkpoints across devices ------------

def test_solve_g2o_on_card_matches_cpu(cuda, tmp_path, capsys):
    """The solve_g2o CLI on a 200-pose sphere graph (chip_smoke.py's
    generator) on the card and with --cpu: the same poses and factors,
    final costs within 1e-4 relative."""
    from cslam_tpu_torch.backend.g2o import write_g2o
    from cslam_tpu_torch.tools import solve_g2o
    fg, _, _ = _chip_smoke().make_sphere_graph(200, 50, 0.02, 0)
    src = str(tmp_path / "in.g2o")
    write_g2o(fg, src)
    out = {}
    for name, extra in (("cuda", []), ("cpu", ["--cpu"])):
        assert solve_g2o.main([src, "--chordal", *extra]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert out["cuda"]["platform"] == "cuda"
    assert out["cpu"]["platform"] == "cpu"
    for key in ("poses", "factors", "loop_closures"):
        assert out["cuda"][key] == out["cpu"][key]
    assert out["cuda"]["final_cost"] < out["cuda"]["initial_cost"]
    assert out["cuda"]["final_cost"] == pytest.approx(
        out["cpu"]["final_cost"], rel=1e-4)


def _checkpointed_swarm(device):
    from cslam_tpu_torch.sim_mission import Swarm
    s = Swarm(2, 16, device=device)
    s.feed()
    s.detect()
    return s


@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path, src, dst):
    """A node checkpointed on one device restores on the other: its
    databases on the new node's device, the same lengths, top-3 results
    and fixed edges, poses within 1e-6."""
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.node import SwarmNode
    from cslam_tpu_torch.sim_mission import mission_params
    from cslam_tpu_torch.utils import checkpoint
    s = _checkpointed_swarm(src)
    node2 = SwarmNode(mission_params(0, 2),
                      InProcessBus(InProcessRouter(), 0), ManualClock(),
                      device=dst)
    try:
        folder = str(tmp_path / "ckpt")
        checkpoint.save_node(s.nodes[0], folder)
        checkpoint.load_node(node2, folder)
        a, b = s.nodes[0].detection.lcm, node2.detection.lcm
        assert b.local_nnsm.data.device.type == dst
        assert len(b.local_nnsm) == len(a.local_nnsm) > 0
        assert len(b.other_robots_nnsm[1]) == len(a.other_robots_nnsm[1])
        q = s.world.descriptor(0, 3)
        items_a, sims_a = a.local_nnsm.search(q, 3)
        items_b, sims_b = b.local_nnsm.search(q, 3)
        assert items_b == items_a
        np.testing.assert_allclose(sims_b, sims_a, atol=1e-5)
        assert [tuple(e) for e in b.candidate_selector.fixed_edges] == \
            [tuple(e) for e in a.candidate_selector.fixed_edges]
        for key, (R, t) in s.nodes[0].backend.odometry_pose_estimates.items():
            R2, t2 = node2.backend.odometry_pose_estimates[key]
            np.testing.assert_allclose(R2, R, atol=1e-6)
            np.testing.assert_allclose(t2, t, atol=1e-6)
    finally:
        node2.close()
        s.close()


# -- the multi-device layer (chip_smoke's multichip phase, small) -----------

def _mesh_knn_against_single_card(cs, mesh, gen):
    """Sharded kernel searches (f32 and bf16, every rank with valid rows)
    against the single-card kernel search; every rank launched its
    kernel once per search, counted from the workers."""
    from cslam_tpu_torch.parallel.sharded_knn import \
        kernel_slots_to_reference, sharded_cosine_topk
    for dtype in (torch.float32, torch.bfloat16):
        data = torch.randn((8192, 96), generator=gen, device="cuda").to(dtype)
        q = torch.randn((16, 96), generator=gen, device="cuda")
        for n_valid in (8000, 3):
            ref = kernel_slots_to_reference(
                *kp.cosine_topk_pallas(data, n_valid, q, 10), n_valid)
            mesh.reset_launches()
            got = sharded_cosine_topk(mesh, data, n_valid, q, 10)
            _, per_rank = mesh.launches()
            rows = 8192 // mesh.size
            want = [int(n_valid > r * rows) for r in range(mesh.size)]
            assert [c[kp.KERNELS[dtype]] for c in per_rank] == want
            cs.compare_topk(*got, *ref, f"{dtype} n_valid={n_valid}")


def _mesh_solve_against_single_card(cs, mesh):
    """tests/test_pgo_oracle.py's graph at 200 poses: the factor-sharded
    solve against the single-card solve of the same arrays (the
    reference parity test's tolerances)."""
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.parallel.distributed_pgo import \
        distributed_gnc_optimize
    fg, _ = cs.oracle_graph(200, 24, 4, seed=0)
    g = fg.to_arrays(edge_bucket_multiple=mesh.size, sort_by_robot=True,
                     device="cuda")
    cfg = pgo.PGOConfig(linear_solver="pcg")
    res = distributed_gnc_optimize(mesh, g, cfg)
    cs.check_pgo_parity(res, pgo.gnc_optimize(g, cfg), "200-pose solve")


@pytest.mark.parametrize("backend,ranks", [("nccl", 1), ("gloo", 2)])
def test_mesh_on_one_card_matches_single_card(cuda, backend, ranks):
    """d = 1 with NCCL and d = 2 sharing cuda:0 over gloo: the sharded
    search and the factor-sharded solve against the single card."""
    import multiprocessing

    from cslam_tpu_torch.parallel import make_swarm_mesh
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(7)
    with make_swarm_mesh(ranks, device="cuda", backend=backend) as mesh:
        ranks_seen = mesh.describe()
        assert [r["device"] for r in ranks_seen] == ["cuda:0"] * ranks
        assert {r["backend"] for r in ranks_seen} == {backend}
        _mesh_knn_against_single_card(cs, mesh, gen)
        _mesh_solve_against_single_card(cs, mesh)
    assert not multiprocessing.active_children()


def test_nccl_mesh_one_rank_per_card(cuda):
    """d = device_count with NCCL, rank r on cuda:r; needs 2 cards."""
    import multiprocessing

    from cslam_tpu_torch.parallel import make_swarm_mesh
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"one rank per card needs at least 2 cards; this host "
                    f"has {count}")
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(8)
    with make_swarm_mesh(count, device="cuda", backend="nccl") as mesh:
        assert [r["device"] for r in mesh.describe()] == \
            [f"cuda:{r}" for r in range(count)]
        _mesh_knn_against_single_card(cs, mesh, gen)
        _mesh_solve_against_single_card(cs, mesh)
    assert not multiprocessing.active_children()


# -- MAC's warm-LOBPCG step: the small-dense kernel and the CUDA graph -----

def _small_dense_inputs(gen, batch, m, n, kind):
    """(batch, m, n) float32: random, graded (columns scaled over six
    decades) or, square only, symmetric with nearly equal eigenvalue
    pairs (1e-7 apart)."""
    A = torch.randn((batch, m, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    if kind == "graded":
        A = A * torch.logspace(0, -6, n, device="cuda",
                               dtype=torch.float64)
    if kind == "degenerate":
        Q = torch.linalg.qr(A)[0]
        ev = torch.arange(n, device="cuda", dtype=torch.float64) // 2
        ev = ev + 1e-7 * torch.randn((batch, n), generator=gen,
                                     device="cuda", dtype=torch.float64)
        A = Q @ torch.diag_embed(ev) @ Q.mT
    return A.float()


@pytest.mark.parametrize("kind", ["random", "graded", "degenerate"])
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_small_dense_kernel_matches_plain(cuda, kind, batch):
    """The kernel against the plain float64 version at LOBPCG's shapes
    (eigh 4 x 4 and 12 x 12, QR 8 x 4, SVD 4 x 4) and at the kernel's
    largest (16, 16 x 8, 8): eigenvalues, singular values and the
    products V diag(w) V^T, Q R and U diag(S) V^T within 1e-6 of the
    matrix's largest entry; the factors orthonormal within 1e-6."""
    from cslam_tpu_torch.ops import small_dense as sd
    gen = torch.Generator(device="cuda").manual_seed(17 + batch)
    before = dict(sd.LAUNCHES)

    def close(got, want, scale, what):
        err = float((got.double() - want.double()).abs().max() / scale)
        assert err <= 1e-6, f"{what}: {err:.3g} of the largest entry"

    def orthonormal(M, what):
        eye = torch.eye(M.shape[-1], device="cuda", dtype=torch.float64)
        close(M.double().mT @ M.double(), eye.expand_as(
            M.mT @ M).double(), 1.0, what)

    for n in (4, 12, 16):
        A = _small_dense_inputs(gen, batch, n, n, kind)
        A = (A + A.mT) / 2 if kind != "degenerate" else A
        scale = float(A.abs().max())
        w, V = sd.eigh(A)
        w_p, _ = sd.eigh_plain(A)
        torch.cuda.synchronize()
        close(w, w_p, scale, f"eigh {n} values")
        close(V.double() @ torch.diag_embed(w.double()) @ V.double().mT,
              A, scale, f"eigh {n} V diag(w) V^T")
        orthonormal(V, f"eigh {n} V")
    for m, n in ((8, 4), (12, 4), (16, 8)):
        kind_qr = "random" if kind == "degenerate" else kind
        A = _small_dense_inputs(gen, batch, m, n, kind_qr)
        Q, R = sd.qr(A)
        torch.cuda.synchronize()
        close(Q.double() @ R.double(), A, float(A.abs().max()),
              f"qr {m}x{n} QR")
        orthonormal(Q, f"qr {m}x{n} Q")
        assert bool((R.tril(-1) == 0).all())
    for n in (4, 8):
        kind_svd = "random" if kind == "degenerate" else kind
        A = _small_dense_inputs(gen, batch, n, n, kind_svd)
        U, S, Vh = sd.svd(A)
        _, S_p, _ = sd.svd_plain(A)
        torch.cuda.synchronize()
        scale = float(A.abs().max())
        close(S, S_p, scale, f"svd {n} values")
        close(U.double() @ torch.diag_embed(S.double()) @ Vh.double(), A,
              scale, f"svd {n} U diag(S) V^T")
        orthonormal(U, f"svd {n} U")
        orthonormal(Vh.mT, f"svd {n} V")
    assert {k: sd.LAUNCHES[k] - before[k] for k in before} == \
        {"small_eigh": 3, "small_qr": 3, "small_svd": 2}


def test_small_dense_kernel_rejects_what_it_does_not_take(cuda):
    from cslam_tpu_torch.ops import small_dense as sd
    with pytest.raises(ValueError):
        sd.eigh(torch.zeros((17, 17), device="cuda"))
    with pytest.raises(ValueError):
        sd.qr(torch.zeros((4, 8), device="cuda"))
    with pytest.raises(ValueError):
        sd.svd(torch.zeros((9, 9), device="cuda"))
    with pytest.raises(TypeError):
        sd.eigh(torch.zeros((4, 4), device="cuda", dtype=torch.float64))
    # a singular matrix: U completed to an orthonormal basis
    A = torch.zeros((4, 4), device="cuda")
    A[0, 0] = 2.0
    U, S, Vh = sd.svd(A)
    torch.testing.assert_close(S, torch.tensor([2.0, 0, 0, 0],
                                               device="cuda"))
    torch.testing.assert_close(U.T @ U, torch.eye(4, device="cuda"),
                               rtol=0, atol=1e-6)


def _mac_problem(n, m, seed, k=5):
    from cslam_tpu_torch.sparsification import mac as tmac
    from cslam_tpu_torch.utils.edges import Edge
    rng = np.random.default_rng(seed)
    fixed = [Edge(i, i + 1, 1.0) for i in range(n - 1)]
    cand, seen = [], set()
    while len(cand) < m:
        i, j = sorted(rng.integers(0, n, 2).tolist())
        if j - i < 2 or (i, j) in seen:
            continue
        seen.add((i, j))
        cand.append(Edge(i, j, float(rng.random()) + 0.1))
    mac = tmac.MAC(fixed, cand, n, device="cuda")
    w0 = np.zeros(m, np.float32)
    w0[np.argsort([e.weight for e in cand])[-k:]] = 1.0
    pb = tmac._Problem(
        mac.L_fixed, tmac.incidence_matrix(mac._e_i_d, mac._e_j_d, mac._P),
        mac._weights_d, mac._valid_d, mac.node_mask,
        mac._e_i_d.long(), mac._e_j_d.long(),
        torch.tensor(float("-inf"), device="cuda"))
    return tmac, mac, pb, mac._pad_w(w0), k


def _eager_fw(tmac, mac, pb, w0, X, tol, *, k, max_iters, lobpcg_iters):
    """The eager warm-LOBPCG loop on the card (LOBPCG stopping early by
    reading its flag), with _STEP_GRAPHS.run's signature."""
    return tmac._fw_loop(
        pb, k, w0, X, tol, max_iters,
        lambda w, X: tmac._warm_fiedler(pb, w, X, lobpcg_iters))


def _start_block(tmac, mac):
    return torch.from_numpy(tmac.jax_random.normal(
        3, (mac._P, mac.lobpcg_block))).cuda()


def _fw(run, tmac, mac, pb, w0, k, max_iters, tol=1e-8):
    return run(pb, w0, _start_block(tmac, mac), tol, k=k,
               max_iters=max_iters, lobpcg_iters=mac.lobpcg_iters)


@pytest.mark.parametrize("tol", [1e-8, 0.05])
@pytest.mark.parametrize("n,m", [(60, 20), (400, 120), (1860, 300)])
def test_fw_graph_replay_matches_eager(cuda, n, m, tol):
    """P = 64, 512 and 2048: the Frank-Wolfe loop by graph replays gives
    w, u and the iteration count bitwise equal to the eager loop on the
    card, both at the 20-iteration cap (tol 1e-8) and stopping early on
    the replayed done flag (tol 0.05); a second call replays the cached
    graph alike."""
    tmac, mac, pb, w0, k = _mac_problem(n, m, seed=n)
    assert mac.fiedler_method == "warm-lobpcg"
    w_e, u_e, it_e = _fw(functools.partial(_eager_fw, tmac, mac), tmac,
                         mac, pb, w0, k, 20, tol)
    assert (it_e < 20) == (tol > 1e-3)
    for _ in range(2):  # captured, then replayed from the cache
        w_g, u_g, it_g = _fw(tmac._STEP_GRAPHS.run, tmac, mac, pb, w0, k,
                             20, tol)
        assert it_g == it_e
        assert torch.equal(w_g, w_e)
        assert torch.equal(u_g, u_e)


@pytest.mark.parametrize("tol", [1e-8, 0.05])
@pytest.mark.parametrize("n,m", [(400, 120), (1860, 300)])
def test_fw_subset_on_card_matches_eager(cuda, monkeypatch, n, m, tol):
    """MAC.fw_subset on the card, whose Frank-Wolfe loop replays graphs,
    gives the rounded and unrounded selections, the upper bound and the
    iteration count of the same call with the eager loop in its place;
    the counters `mac.graph_steps` and `mac.fw_iters` agree."""
    from cslam_tpu_torch.runtime.tracing import tracer
    tmac, mac, _, _, k = _mac_problem(n, m, seed=n + 1)
    rng = np.random.default_rng(n)
    w0 = np.zeros(m, np.float32)
    w0[rng.choice(m, k, replace=False)] = 1.0

    def traced(n_calls):
        tracer.clear()
        tracer.enable(None)
        try:
            res = [mac.fw_subset(w0, k, max_iters=20, duality_gap_tol=tol)
                   for _ in range(n_calls)]
            return res, tracer.counter_totals()["mac"]
        finally:
            tracer.disable()
            tracer.clear()

    got, counts = traced(2)
    assert counts["graph_steps"] == counts["fw_iters"]
    monkeypatch.setattr(tmac._STEP_GRAPHS, "run",
                        functools.partial(_eager_fw, tmac, mac))
    (want,), counts_eager = traced(1)
    assert "graph_steps" not in counts_eager
    assert counts["fw_iters"] == 2 * counts_eager["fw_iters"]
    for res in got:
        np.testing.assert_array_equal(res.w, want.w)
        np.testing.assert_array_equal(res.w_unrounded, want.w_unrounded)
        assert res.upper_bound == want.upper_bound


def test_fw_graph_replay_reads_nothing_back(cuda):
    """A replay of a captured step synchronizes with nothing (sync debug
    mode "error" raises on any synchronizing call)."""
    tmac, mac, pb, w0, k = _mac_problem(400, 120, seed=5)
    _fw(tmac._STEP_GRAPHS.run, tmac, mac, pb, w0, k, 3)
    key = next(key for key in tmac._STEP_GRAPHS.entries
               if key[1:4] == (mac._P, mac._E, k))
    entry = tmac._STEP_GRAPHS.entries[key]
    entry.load(pb, w0, _start_block(tmac, mac), 1e-8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            entry.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(entry.it) == 3


def test_fw_graph_capture_beside_a_solve(cuda):
    """A capture taken while a PGO solve runs on another thread succeeds,
    and its replays equal the eager loop."""
    import threading

    from cslam_tpu_torch.backend import pgo
    cs = _chip_smoke()
    fg, _ = cs.oracle_graph(200, 24, 4, seed=0)
    tmac, mac, pb, w0, k = _mac_problem(300, 90, seed=3, k=4)
    for key in [key for key in tmac._STEP_GRAPHS.entries
                if key[1:4] == (mac._P, mac._E, k)]:
        del tmac._STEP_GRAPHS.entries[key]
    started, stop, errors = threading.Event(), threading.Event(), []

    def solve():
        try:
            while not stop.is_set():
                g = fg.to_arrays(device="cuda")
                started.set()
                pgo.gnc_optimize(g, pgo.PGOConfig(linear_solver="pcg"))
        except Exception as exc:  # reported by the main thread
            errors.append(exc)
            started.set()

    th = threading.Thread(target=solve, daemon=True)
    th.start()
    try:
        assert started.wait(120)
        captures = len(tmac._STEP_GRAPHS.entries)
        w_g, u_g, it_g = _fw(tmac._STEP_GRAPHS.run, tmac, mac, pb, w0,
                             k, 20)
        assert th.is_alive() and not errors
        assert len(tmac._STEP_GRAPHS.entries) == captures + 1
    finally:
        stop.set()
        th.join(300)
    assert not th.is_alive() and not errors
    w_e, u_e, it_e = _fw(functools.partial(_eager_fw, tmac, mac), tmac,
                         mac, pb, w0, k, 20)
    assert it_g == it_e and torch.equal(w_g, w_e) and torch.equal(u_g, u_e)


# -- LightGlue: one CUDA graph a pair -----------------------------------------

LG_SIZE = (1241, 376)


@pytest.fixture
def lg_traced():
    """The process-wide tracer, on and empty; off and empty after."""
    from cslam_tpu_torch.runtime.tracing import tracer
    tracer.clear()
    tracer.enable(None)
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.clear()


def _lg(cuda, seed=0, layers=9):
    from cslam_tpu_torch.models.lightglue import LightGlue
    return LightGlue(num_layers=layers, rng_seed=seed, device=cuda)


def _lg_pair(seed, k=2048):
    """A padded pair as StereoHandler passes it, 1,300-1,900 of 2,048
    slots valid a side (chip_smoke.lightglue_pair)."""
    rng = np.random.default_rng(seed)
    n1, n0 = sorted(int(n) for n in rng.integers(k * 1300 // 2048,
                                                 k * 1900 // 2048 + 1, 2))
    return _chip_smoke().lightglue_pair(rng, k, k, n0, n1, LG_SIZE)


def _lg_eager(lg, args, size):
    """The eager forward and filter on the default stream: (scores,
    idx1 int32, valid float32)."""
    from cslam_tpu_torch.models.lightglue import mutual_matches, \
        normalize_keypoints
    t = [torch.from_numpy(a).to("cuda") for a in args]
    if size is None:
        size = torch.clamp(torch.amax(torch.cat([t[1], t[4]]), dim=0),
                           min=1.0)
    with torch.no_grad():
        s = lg.model(t[0], normalize_keypoints(t[1], size), t[2], t[3],
                     normalize_keypoints(t[4], size), t[5])
    best1, valid = mutual_matches(s, t[2], lg.score_threshold)
    return (s, best1.cpu().numpy().astype(np.int32),
            valid.cpu().numpy().astype(np.float32))


def _assert_lg_close(got, ref):
    """Same -inf pattern, finite entries within 1e-6 relative."""
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(torch.isneginf(ref), torch.isneginf(got))
    err = float(((got[fin] - ref[fin]).abs() / (1.0 + ref[fin].abs())).max())
    assert err <= 1e-6, err


def _lg_counts(traced):
    return traced.counter_totals().get("lightglue", {})


def test_lightglue_graph_matches_eager(cuda, lg_traced):
    """At K = 2,048: the replay's scores against the eager forward's,
    size given and taken from the bounds, four pairs through one graph
    and a fifth handed over as card tensors;
    match's idx1 and valid against the eager filter; a second shape (K =
    512) adds exactly one capture."""
    lg = _lg(cuda)
    calls = 0
    for seed, size in ((0, LG_SIZE), (1, None), (2, LG_SIZE), (3, None)):
        args = _lg_pair(seed)
        ref, best1, valid = _lg_eager(lg, args, size)
        _assert_lg_close(lg.scores(*args, size=size), ref)
        idx1, got_valid = lg.match(*args, size=size)
        assert np.array_equal(got_valid, valid)
        assert np.array_equal(idx1, best1)
        calls += 2
    # inputs already on the card, the size as a card tensor
    args = _lg_pair(15)
    on_card = [torch.from_numpy(a).to(cuda) for a in args]
    _assert_lg_close(lg.scores(*on_card, size=torch.tensor(
        LG_SIZE, dtype=torch.float32, device=cuda)),
        _lg_eager(lg, args, LG_SIZE)[0])
    calls += 1
    assert _lg_counts(lg_traced) == {"graph_captures": 1,
                                     "graph_replays": calls}
    args = _lg_pair(4, k=512)
    _assert_lg_close(lg.scores(*args, size=LG_SIZE),
                     _lg_eager(lg, args, LG_SIZE)[0])
    assert _lg_counts(lg_traced) == {"graph_captures": 2,
                                     "graph_replays": calls + 1}


def test_lightglue_scores_are_the_pairs_own(cuda):
    """The tensor returned for pair A is unchanged by pair B's replay."""
    lg = _lg(cuda)
    a = lg.scores(*_lg_pair(5), size=LG_SIZE)
    kept = a.clone()
    b = lg.scores(*_lg_pair(6), size=LG_SIZE)
    torch.cuda.synchronize()
    assert torch.equal(a, kept) and not torch.equal(a, b)


def test_lightglue_wrapper_on_the_instance_sees_every_match(cuda):
    """A wrapper set on the instance's `scores` (as the benchmark's is)
    sees every match, and what it kept is each pair's own answer."""
    lg = _lg(cuda)
    scores, seen = lg.scores, []

    def wrapped(*a, size=None):
        out = scores(*a, size=size)
        seen.append((a, size, out))
        return out
    lg.scores = wrapped
    pairs = [(_lg_pair(7), LG_SIZE), (_lg_pair(8), None),
             (_lg_pair(9, k=512), LG_SIZE)]
    for args, size in pairs:
        lg.match(*args, size=size)
    assert len(seen) == len(pairs)
    for a, size, out in seen:
        _assert_lg_close(out, _lg_eager(lg, a, size)[0])


@pytest.mark.parametrize("where", ["cpu", "cuda"])
def test_lightglue_graph_takes_weights_loaded_after_capture(cuda, where):
    """load_state_dict after the capture (from host tensors, or from card
    tensors: copies queued on the default stream) shows in the next
    replay's scores."""
    lg = _lg(cuda)
    args = _lg_pair(10)
    before = lg.scores(*args, size=LG_SIZE)
    state = {k: v.to(where) for k, v in
             _lg(cuda, seed=1).model.state_dict().items()}
    lg.model.load_state_dict(state)
    after = lg.scores(*args, size=LG_SIZE)
    _assert_lg_close(after, _lg_eager(lg, args, LG_SIZE)[0])
    fin = torch.isfinite(before)
    assert not torch.equal(after[fin], before[fin])


def test_lightglue_graph_replay_reads_nothing_back(cuda):
    """A replay synchronizes with nothing (sync debug mode "error")."""
    lg = _lg(cuda)
    lg.scores(*_lg_pair(11, k=512), size=LG_SIZE)
    (entry,) = lg._graphs.values()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(lg._stream):
            for _ in range(3):
                entry.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_lightglue_graph_keys_on_tf32(cuda, monkeypatch, lg_traced):
    """With TF32 allowed (chip_smoke's control lifts the fp32 check) the
    pair gets a graph of its own in TF32, which answers otherwise; back
    in fp32 the first graph answers as before."""
    from cslam_tpu_torch.models import lightglue
    lg = _lg(cuda)
    args = _lg_pair(12, k=512)
    f32 = lg.scores(*args, size=LG_SIZE)
    monkeypatch.setattr(lightglue, "require_full_fp32",
                        lambda device=None: None)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = lg.scores(*args, size=LG_SIZE)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.undo()
    fin = torch.isfinite(f32)
    assert float((tf32[fin] - f32[fin]).abs().max()) > 1e-5
    assert torch.equal(lg.scores(*args, size=LG_SIZE), f32)
    assert _lg_counts(lg_traced) == {"graph_captures": 2,
                                     "graph_replays": 3}


def test_lightglue_capture_beside_a_busy_thread(cuda):
    """A capture and replays taken while another thread launches small
    ops on the default stream and reads back now and then (as the
    back-end's solve does) equal the eager forward."""
    import threading
    cs = _chip_smoke()
    stop, ops = threading.Event(), [0]
    th = threading.Thread(target=cs._solve_like, args=(stop, ops),
                          daemon=True)
    th.start()
    try:
        lg = _lg(cuda)
        got = [(args, lg.scores(*args, size=LG_SIZE))
               for args in (_lg_pair(13), _lg_pair(14))]
    finally:
        stop.set()
        th.join(60)
    assert ops[0] > 0 and not th.is_alive()
    for args, out in got:
        _assert_lg_close(out, _lg_eager(lg, args, LG_SIZE)[0])
