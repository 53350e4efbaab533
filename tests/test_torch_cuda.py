"""The port on an NVIDIA card: the CUDA kernel against its plain version,
the kernel behind DescriptorDatabase(method="pallas"), the slice on the
card against the same slice on the CPU, and the sim mission through
SwarmNode on the card against the same mission on the CPU.

Every test here needs a card: marked `cuda`, skipped (in a fixture, not
at import) where there is none. On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: similarities 1e-5 in f32 and 1e-4 in bf16 (same inputs, only
the summation order differs); every returned index must carry the plain
similarity of its slot (ties may pick either row).
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
