"""The port on an NVIDIA card: the CUDA kernel against its plain version,
the kernel behind DescriptorDatabase(method="pallas"), and the slice on
the card against the same slice on the CPU.

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
    gen = torch.Generator(device=cuda).manual_seed(n_valid)
    data = torch.randn((n_cap, dim), generator=gen, device=cuda).to(dtype)
    queries = torch.randn((batch, dim), generator=gen, device=cuda)
    before = kp.cosine_topk_pallas.launches
    idx, val = kp.cosine_topk_pallas(data, n_valid, queries, k)
    assert kp.cosine_topk_pallas.launches == before + 1
    inv, bias, q_n = kp.prepare_inputs(data, n_valid, queries)
    idx_p, val_p = kp.cosine_topk_plain(data, n_valid, q_n, inv, bias, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(val, val_p, rtol=0, atol=TOL[dtype])
    n_eff = min(k, n_valid)
    full = (q_n.float() @ data.float().T) * inv + bias
    got = torch.gather(full, 1, idx[:, :n_eff].long())
    torch.testing.assert_close(got, val[:, :n_eff], rtol=0, atol=TOL[dtype])
    assert bool((idx[:, :n_eff] < n_valid).all())
    assert bool((val[:, n_eff:] == kp.NEG_LARGE).all())
    assert bool((idx[:, n_eff:] == 0).all())


def test_kernel_rejects_what_it_does_not_take(cuda):
    data = torch.randn((256, 32), device=cuda)
    q = torch.randn((2, 32), device=cuda)
    with pytest.raises(ValueError):
        kp.cosine_topk_pallas(data, 100, q, kp.KMAX + 1)
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
    before = kp.cosine_topk_pallas.launches
    for _ in range(10):
        q = rng.standard_normal(64)
        items_k, sims_k = db_k.search(q, 10)
        items_e, sims_e = db_e.search(q, 10)
        assert items_k == items_e
        np.testing.assert_allclose(sims_k, sims_e, atol=1e-5)
    assert kp.cosine_topk_pallas.launches == before + 10


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
