"""The port's NetVLAD against the plain float32 reference
(`swarmbench/reference_netvlad.py`, the one the NetVLAD cell's checks
use), on the CPU, at its published widths (VGG-16 to conv5_3 at 512
channels, 64 clusters, a 32,768 -> 4,096 projection) and small crops;
the wrapper's projection check, its counter and span args; the NetVLAD
cell's operation counts (`swarmbench/roofline_netvlad.py`).

The reference is written from the paper and shares no code with the
port; it reads state dicts in the published key names, and reads the
shipped weight file with its own key mapping.

Every cosine is taken in float64 over float64-normalized rows: a float32
sum of 32,768 products of unit vectors rounds at ~5e-7, which would hide
the errors measured here. Tolerances, each with its reason:
- NetVLADNet, float32 network, seeded random weights, crop 56: 1 - cosine
  <= 1e-10 (float32 convolutions summed in another order; measured
  1.4e-14).
- NetVLADNet, bfloat16 convolutions (the port's default), the same:
  1 - cosine <= 5e-7 (bf16 inputs carry 8 mantissa bits; measured
  2.5e-8-2.8e-8).
- The wrapper with the shipped weights (read by the port's converter and
  by the reference's own mapping) and a seeded 4,096 x 32,768
  projection, crop 48: 1 - cosine <= 2e-5 with bf16 convolutions
  (measured 2.6e-6), <= 1e-10 with the float32 network.
A planted fault, one cluster's centroid shifted by 0.05 in the
reference, reads 1.2e-5 on random weights and 1.8e-3 on the shipped
ones: each tolerance fails it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cslam_tpu_torch.models import zoo
from cslam_tpu_torch.models.cosplace import flax_init_, preprocess
from cslam_tpu_torch.models.netvlad import NetVLAD, NetVLADNet
from cslam_tpu_torch.runtime.tracing import tracer
from swarmbench import reference_netvlad as ref
from swarmbench import roofline_netvlad as roof

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "swarmbench", "reference_netvlad.py")
VLAD = 64 * 512


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _one_minus_cos(a, b):
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    a = a / a.norm(dim=1, keepdim=True)
    b = b / b.norm(dim=1, keepdim=True)
    return float((1.0 - (a * b).sum(dim=1)).max())


def _shifted(state, cluster=5, by=0.05):
    """The planted fault: one cluster's centroid moved by `by`."""
    state = dict(state)
    c = state["pool.centroids"].clone()
    c[cluster] += by
    state["pool.centroids"] = c
    return state


def _images(seed, n, h, w):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(n, h, w, generator=gen) * 255).to(torch.uint8)


def _rgb(images):
    x = images.numpy()
    return np.broadcast_to(x[..., None], x.shape + (3,))


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-10),
                                         (torch.bfloat16, 5e-7)])
def test_netvlad_net_at_published_widths_against_reference(dtype, bound):
    net = flax_init_(NetVLADNet(dtype=dtype), 4).eval()
    assert net.pool.num_clusters == 64
    assert net.pool.centroids.shape == (64, 512)
    images = _images(4, 3, 56, 64)
    with torch.no_grad():
        got = net(torch.from_numpy(np.asarray(preprocess(_rgb(images), 56),
                                              np.float32)))
    state = {k: v.detach().float() for k, v in net.state_dict().items()}
    want = ref.vlad_vectors(state, images, 56)
    assert got.shape == want.shape == (3, VLAD)
    assert _one_minus_cos(got, want) <= bound
    assert _one_minus_cos(got, ref.vlad_vectors(_shifted(state), images,
                                                56)) > bound


@pytest.fixture(scope="module")
def projection(tmp_path_factory):
    """A seeded 32,768 -> 4,096 projection file and its arrays."""
    gen = torch.Generator().manual_seed(8)
    mean = (0.01 * torch.randn(VLAD, generator=gen)).numpy()
    comps = (torch.randn(4096, VLAD, generator=gen) / VLAD ** 0.5).numpy()
    path = str(tmp_path_factory.mktemp("netvlad") / "projection.npz")
    np.savez(path, mean=mean, components=comps)
    return path, torch.from_numpy(mean), torch.from_numpy(comps)


def _wrapper(path, dim=4096, crop=48):
    return NetVLAD({"frontend.nn_checkpoint": "shipped",
                    "frontend.netvlad.pca_checkpoint": path,
                    "frontend.global_descriptor_dim": dim,
                    "frontend.image_crop_size": crop}, device="cpu")


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 2e-5),
                                         (torch.float32, 1e-10)])
def test_wrapper_with_4096_projection_against_reference(projection, dtype,
                                                        bound):
    path, mean, comps = projection
    program = _wrapper(path)
    assert tuple(program.pca_components.shape) == (4096, VLAD)
    if dtype == torch.float32:
        net = NetVLADNet(dtype=torch.float32)
        net.load_state_dict(program.model.state_dict())
        program.model = net.eval()
    images = _images(9, 3, 48, 80)
    got = program.compute_embeddings_batch(_rgb(images))
    assert got.shape == (3, 4096) and got.dtype == np.float32
    state = ref.netvlad_weights(zoo.shipped_checkpoint("netvlad_synth.npz"))
    want = ref.descriptors(state, images, 48, mean, comps)
    assert _one_minus_cos(got, want) <= bound
    planted = ref.descriptors(_shifted(state), images, 48, mean, comps)
    assert _one_minus_cos(got, planted) > bound


def test_projection_of_another_width_raises(tmp_path):
    """A projection whose rows are not the configured descriptor width
    (here 64 rows for 4,096), or whose columns are not the VLAD vector's
    entries, is refused when the wrapper is built."""
    rows = np.zeros((64, VLAD), np.float32)
    path = str(tmp_path / "p64.npz")
    np.savez(path, mean=np.zeros(VLAD, np.float32), components=rows)
    with pytest.raises(ValueError, match="global_descriptor_dim is 4096"):
        _wrapper(path, dim=4096)
    assert _wrapper(path, dim=64).descriptor_dim == 64
    path = str(tmp_path / "narrow.npz")
    np.savez(path, mean=np.zeros(512, np.float32),
             components=np.zeros((64, 512), np.float32))
    with pytest.raises(ValueError, match="VLAD vector has 32768"):
        _wrapper(path, dim=64)


def test_counter_and_span_args():
    """`visual.netvlad_images` counts the images embedded, and the
    `descriptor_forward` span carries the batch's shape."""
    program = NetVLAD({"frontend.nn_checkpoint": "shipped",
                       "frontend.image_crop_size": 32}, device="cpu")
    tracer.clear()
    tracer.enable(None)
    try:
        for n in (3, 2):
            program.compute_embeddings_batch(np.zeros((n, 40, 48, 3),
                                                      np.uint8))
    finally:
        tracer.disable()
    assert tracer.counter_totals()["visual"]["netvlad_images"] == 5
    assert tracer.totals()["descriptor_forward"]["count"] == 2
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"netvlad_spans_{os.getpid()}.json")
    try:
        events = json.load(open(tracer.dump(path)))["traceEvents"]
    finally:
        os.unlink(path)
    args = [e["args"] for e in events if e.get("name") == "descriptor_forward"]
    assert args == [{"images": n, "crop": 32, "clusters": 64, "pca_dim": 128}
                    for n in (3, 2)]
    tracer.clear()


def test_vgg16_operation_counts():
    """VGG-16's convolutions through conv5_3 at 224 x 224 are the
    published 15.3-15.5 GMACs; at crop 376 the conv5 map is 23 x 23 and a
    batch of 8 with the 4,096-row projection has a least time under a
    millisecond on an H100."""
    convs, hw = roof.vgg16_layers(224)
    assert len(convs) == 13 and hw == (14, 14)
    assert 15.3e9 <= sum(m for _, m, _ in convs) <= 15.5e9
    convs, hw = roof.vgg16_layers(376)
    assert hw == (23, 23)
    assert 43.0e9 <= sum(m for _, m, _ in convs) <= 43.2e9
    bound = roof.batch_bound_s(8, 376, 64, 4096)
    # the projection's matrix read (537 MB at 3.35 TB/s) is part of it
    assert 0.7e-3 + 4096 * VLAD * 4 / 3.35e12 < bound < 1e-3
    assert roof.projection(8, VLAD, 4096)[1] == 8 * VLAD * 4096


def test_reference_loads_nothing_of_the_packages():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('rn', {REF_PATH!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(top & {'jax', 'jaxlib', 'flax', "
        "'cslam_tpu', 'cslam_tpu_torch'})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd="/")
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
