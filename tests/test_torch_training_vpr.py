"""Port parity, place-recognition trainers: the CosPlace and NetVLAD
trainers of cslam_tpu_torch against cslam_tpu on the CPU, two steps from
the same JAX init carried across, on the same rendered batches (crop 64,
4 places x 2 views), and BatchNorm's train mode against Flax's.

Tolerances (f32 networks in both packages; oneDNN off on the port's
side, as in test_torch_training.py):
- BatchNorm in train mode against flax.linen.BatchNorm(momentum=0.9):
  outputs and running statistics within 1e-5, gradients within 1e-5.
- CosPlace: the first loss within 1e-4 relative, the BatchNorm running
  statistics after the first step within 1e-4 relative (of each
  tensor's largest value). The first step's gradients per tensor within
  a relative norm of 2e-2 of the reference's: measured 6.7e-3, and that
  is the reference's own error; on this batch the reference's f32
  gradient lies 6.7e-3 from a float64 one (the port's float64 model),
  the port's f32 gradient 1.1e-5, so the port is also held to its
  float64 gradient within 1e-4. The second loss and statistics within
  1e-2 relative (measured 3e-3 and 1.5e-3: the first update differs
  where the reference's gradient is off). At the trainer's own bf16
  precision: the first loss within 1e-2 relative (measured 2.1e-3).
- NetVLAD: both losses within 1e-4 relative; the first step's gradients
  per tensor within a relative norm of 2e-3 (measured 1.35e-3 in the
  layers up to conv3_1, 4e-6 after). The gradient is not smooth on
  these renders: their flat regions give whole regions of conv3_1 the
  same pre-activation, and where that value sits at ReLU's kink the
  rounding decides the mask for all of them at once. Against a float64
  gradient the reference's f32 one is 2.5e-6 off, the port's 1.35e-3
  with oneDNN off and 2.4e-6 with it on (which flips SuperPoint's first
  layer instead). `data_driven_init`'s centroids within 5e-3 and
  every centroid's dot with the reference's above 0.9999 (features of
  the bf16 backbone, rounded in other places); `fit_pca` on the host
  with the reference's signs (components within 1e-3, every row's dot
  with the reference's above 0.999).
- Checkpoints written by the port's savers load in the reference's
  wrappers with the shipped files' key names and shapes (CosPlace's
  batch_stats included) and give the port's descriptors within 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from cslam_tpu.models import cosplace as jcp
from cslam_tpu.models import netvlad as jnv
from cslam_tpu.models import train_cosplace as jtc
from cslam_tpu.models import train_netvlad as jtn
from cslam_tpu.models import zoo as jzoo
from cslam_tpu_torch.models import convert as tconvert
from cslam_tpu_torch.models import cosplace as tcp
from cslam_tpu_torch.models import netvlad as tnv
from cslam_tpu_torch.models import train_cosplace as ttc
from cslam_tpu_torch.models import train_netvlad as ttn
from cslam_tpu_torch.models.cosplace import flax_init_, load_flat_weights

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_training import (assert_grads_close, flat_of,  # noqa: E402
                                 reference_gradients, variables_of)

torch.set_num_threads(1)

CROP = 64
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batches(n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        world = jtc.make_world(int(rng.integers(2**31)), n=160)
        out.append(jtc.make_batch(rng, world, 4, 2, 0.3, 0.05, CROP))
    return out


def _port_batches_equal(batches, seed=0):
    rng = np.random.default_rng(seed)
    for images, labels in batches:
        world = ttc.make_world(int(rng.integers(2**31)), n=160)
        a, b = ttc.make_batch(rng, world, 4, 2, 0.3, 0.05, CROP)
        assert np.array_equal(a, images) and np.array_equal(b, labels)


def test_batchnorm_train_mode_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 5, 6, 3)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 2, 3).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    ra_mean = rng.standard_normal(3).astype(np.float32)
    ra_var = rng.uniform(0.5, 2, 3).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    w = rng.standard_normal(x.shape).astype(np.float32)

    def f(params, x):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd)

    (_, (y_ref, upd)), g_ref = jax.value_and_grad(f, has_aux=True)(
        variables["params"], jnp.asarray(x))
    m = tcp.BatchNorm(3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(ra_mean))
        m.running_var.copy_(torch.from_numpy(ra_var))
    m.train()
    y = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.sum(y * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               upd["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(),
                               upd["batch_stats"]["var"], atol=1e-5)
    np.testing.assert_allclose(m.weight.grad.numpy(), g_ref["scale"],
                               atol=1e-5)
    np.testing.assert_allclose(m.bias.grad.numpy(), g_ref["bias"],
                               atol=1e-5)
    # eval mode reads the running statistics and leaves them alone
    m.eval()
    before = m.running_var.clone()
    m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(before, m.running_var)


def _stats_close(model, ref_state, rtol):
    sd = model.state_dict()
    for k, ref in ref_state.items():
        if "running" in k:
            err = np.abs(sd[k].numpy() - ref).max() / np.abs(ref).max()
            assert err <= rtol, (k, err)


def test_cosplace_two_steps_match_reference():
    lr = 1e-3
    jm = jcp.GeoLocalizationNet(fc_output_dim=64, dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)))
    flat = flat_of(variables)
    batches = _batches()
    _port_batches_equal(batches)

    def state_of(params, stats):
        return tconvert.cosplace_state_dict(
            flat_of({"params": params, "batch_stats": stats}))

    tx, step = jtc.build_train_step(jm, lr, 10)
    params, stats, st = variables["params"], variables["batch_stats"], None
    st = tx.init(params)
    ref_losses, ref_states = [], []
    for images, labels in batches:
        params, stats, st, loss = step(params, stats, st,
                                       jnp.asarray(images),
                                       jnp.asarray(labels))
        ref_losses.append(float(loss))
        ref_states.append(state_of(params, stats))
    with reference_gradients():
        tx, gstep = jtc.build_train_step(jm, lr, 10)
        grads, *_ = gstep(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]),
                          jnp.asarray(batches[0][0]),
                          jnp.asarray(batches[0][1]))
    ref_grads = state_of(grads, variables["batch_stats"])

    # the port's float64 gradient of the first step
    m64 = tcp.GeoLocalizationNet(fc_output_dim=64,
                                 dtype=torch.float64).double()
    load_flat_weights(m64, {k: v.astype(np.float64) for k, v in
                            tconvert.cosplace_state_dict(flat).items()})
    m64.train()
    ttc.supcon_loss(m64(torch.from_numpy(batches[0][0]).double()),
                    torch.from_numpy(batches[0][1]).long()).backward()
    grads64 = {k: p.grad.numpy() for k, p in m64.named_parameters()}

    tm = tcp.GeoLocalizationNet(fc_output_dim=64, dtype=torch.float32)
    load_flat_weights(tm, tconvert.cosplace_state_dict(flat))
    _, train_step = ttc.build_train_step(tm, lr, 10)
    loss = float(train_step(*batches[0]))
    np.testing.assert_allclose(loss, ref_losses[0], rtol=LOSS_RTOL)
    _stats_close(tm, ref_states[0], 1e-4)
    assert_grads_close(tm, ref_grads, rtol=2e-2)
    assert_grads_close(tm, grads64, rtol=1e-4)
    loss = float(train_step(*batches[1]))
    np.testing.assert_allclose(loss, ref_losses[1], rtol=1e-2)
    _stats_close(tm, ref_states[1], 1e-2)


def test_cosplace_bf16_step_loss_matches_reference():
    jm = jcp.GeoLocalizationNet(fc_output_dim=64)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, CROP, CROP, 3)))
    images, labels = _batches(1, seed=3)[0]
    tx, step = jtc.build_train_step(jm, 1e-3, 10)
    *_, ref = step(variables["params"], variables["batch_stats"],
                   tx.init(variables["params"]), jnp.asarray(images),
                   jnp.asarray(labels))
    tm = tcp.GeoLocalizationNet(fc_output_dim=64)
    load_flat_weights(tm, tconvert.cosplace_state_dict(flat_of(variables)))
    _, train_step = ttc.build_train_step(tm, 1e-3, 10)
    np.testing.assert_allclose(float(train_step(images, labels)),
                               float(ref), rtol=1e-2)


@pytest.fixture(scope="module")
def netvlad_init():
    """A JAX NetVLADNet (f32) after the reference's data_driven_init, and
    the port's from the same JAX init, each drawing from its own rng."""
    jm = jnv.NetVLADNet(dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)))
    init_flat = flat_of(variables)
    # the reference's data_driven_init builds a default (bf16) backbone
    ref_params = jtn.data_driven_init(jm, variables["params"],
                                      np.random.default_rng(0), CROP)
    tm = tnv.NetVLADNet()
    load_flat_weights(tm, tconvert.netvlad_state_dict(init_flat))
    ttn.data_driven_init(tm, np.random.default_rng(0), CROP)
    return jm, ref_params, tm


def test_data_driven_init_matches_reference(netvlad_init):
    _, ref_params, tm = netvlad_init
    ref = tconvert.netvlad_state_dict(flat_of({"params": ref_params}))
    c = tm.pool.centroids.detach().numpy()
    np.testing.assert_allclose(c, ref["pool.centroids"], rtol=0, atol=5e-3)
    assert np.all(np.sum(c * ref["pool.centroids"], axis=1) > 0.9999)
    assert torch.equal(tm.pool.conv.weight[:, :, 0, 0],
                       16.0 * tm.pool.centroids)


def test_netvlad_two_steps_match_reference(netvlad_init):
    jm, ref_params, _ = netvlad_init
    lr = 1e-4
    flat = flat_of({"params": ref_params})
    batches = _batches(seed=1)
    tx, step = jtn.build_train_step(jm, lr, 10)
    params, st, ref_losses = ref_params, tx.init(ref_params), []
    for images, labels in batches:
        params, st, loss = step(params, st, jnp.asarray(images),
                                jnp.asarray(labels))
        ref_losses.append(float(loss))
    with reference_gradients():
        tx, gstep = jtn.build_train_step(jm, lr, 10)
        grads, *_ = gstep(ref_params, tx.init(ref_params),
                          jnp.asarray(batches[0][0]),
                          jnp.asarray(batches[0][1]))
    ref_grads = tconvert.netvlad_state_dict(flat_of({"params": grads}))
    tm = tnv.NetVLADNet(dtype=torch.float32)
    load_flat_weights(tm, tconvert.netvlad_state_dict(flat))
    _, train_step = ttn.build_train_step(tm, lr, 10)
    for i, (images, labels) in enumerate(batches):
        np.testing.assert_allclose(float(train_step(images, labels)),
                                   ref_losses[i], rtol=LOSS_RTOL)
        if i == 0:
            assert_grads_close(tm, ref_grads, rtol=2e-3)


def test_fit_pca_keeps_the_reference_signs(netvlad_init):
    jm, ref_params, _ = netvlad_init
    tm = tnv.NetVLADNet(dtype=torch.float32)
    load_flat_weights(tm, tconvert.netvlad_state_dict(
        flat_of({"params": ref_params})))
    mean_ref, comps_ref = jtn.fit_pca(jm, {"params": ref_params}, 4, 0,
                                      CROP, n_batches=1)
    mean, comps = ttn.fit_pca(tm, 4, 0, CROP, n_batches=1, device="cpu")
    np.testing.assert_allclose(mean, mean_ref, atol=1e-5)
    np.testing.assert_allclose(comps, comps_ref, atol=1e-3)
    assert np.all(np.sum(comps * comps_ref, axis=1) > 0.999)


def _shipped_keys(name):
    with np.load(jzoo.shipped_checkpoint(name)) as data:
        return {k: data[k].shape for k in data.files}


@pytest.mark.skipif(not jzoo.shipped_checkpoint("cosplace_synth.npz"),
                    reason="no shipped weights")
def test_cosplace_checkpoint_loads_in_reference(tmp_path):
    tm = flax_init_(tcp.GeoLocalizationNet(fc_output_dim=64,
                                           dtype=torch.float32), 2)
    _, train_step = ttc.build_train_step(tm, 1e-3, 10)
    train_step(*_batches(1, seed=5)[0])     # batch_stats move off (0, 1)
    path = str(tmp_path / "cp.npz")
    ttc.save_variables(tm, path)
    with np.load(path) as data:
        assert {k: data[k].shape for k in data.files} == \
            _shipped_keys("cosplace_synth.npz")
        assert not np.allclose(
            data["batch_stats/ResNet18Backbone_0/BatchNorm_0/var"], 1.0)
    images = _batches(1, seed=6)[0][0]
    ref = jcp.GeoLocalizationNet(fc_output_dim=64, dtype=jnp.float32).apply(
        variables_of(tconvert.load_flat(path)), jnp.asarray(images))
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    wrapper = jcp.CosPlace({"frontend.nn_checkpoint": path})
    assert wrapper.enabled and wrapper.compute_embedding(
        (images[0] * 40 + 120).clip(0, 255).astype(np.uint8)).shape == (64,)


@pytest.mark.skipif(not jzoo.shipped_checkpoint("netvlad_synth.npz"),
                    reason="no shipped weights")
def test_netvlad_checkpoint_and_pca_load_in_reference(tmp_path):
    tm = flax_init_(tnv.NetVLADNet(dtype=torch.float32), 2)
    path = str(tmp_path / "nv.npz")
    ttn.save_variables(tm, path)
    with np.load(path) as data:
        assert {k: data[k].shape for k in data.files} == \
            _shipped_keys("netvlad_synth.npz")
    images = _batches(1, seed=7)[0][0]
    ref = jnv.NetVLADNet(dtype=jnp.float32).apply(
        variables_of(tconvert.load_flat(path)), jnp.asarray(images))
    with torch.no_grad():
        out = tm(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
