"""Port parity, training tooling: synthetic shapes, homographic
adaptation, the shared optimizer and saver, and the SuperPoint and
LightGlue trainers of cslam_tpu_torch against cslam_tpu on the CPU,
from the same seeds and the same JAX inits carried across through the
flat layout. (The CosPlace and NetVLAD trainers are in
test_torch_training_vpr.py.)

Tolerances:
- Synthetic renders, corners, homographies, warps and pair samples:
  bit-identical (numpy in both packages).
- Homographic adaptation (SuperPoint at f32, shipped weights): the
  aggregated heatmap max abs <= 1e-6 and the counts identical; the
  pseudo-corners identical.
- The schedule: the port's rate before every update equals optax's
  `cosine_decay_schedule` within 1e-6 relative.
- Training steps (f32, oneDNN off on the port's side: its f32 conv
  weight gradient differs from a float64 one by 3e-4 in SuperPoint's
  first layer, the reference's by 1e-6): two steps on the same batches
  from the same weights; each loss within 1e-4 relative; the first
  step's gradients per tensor within a relative norm of 1e-4 of the
  reference's (the reference's gradients are taken from its own
  train_step, built with optax's Adam swapped for the identity, so the
  returned "parameters" are its gradients); after the first update the
  parameters within 1e-6 wherever the reference's gradient component
  exceeds 1e-6 (Adam's first update is lr * g / (|g| + 1e-8), about
  lr * sign(g): a component near zero may take either sign in either
  package; over half the components are compared).
- LightGlue with_aux: scores, z0 and z1 within 1e-4 (the scores' bound
  of test_torch_visual_models.py; they reach -13 here).
- Checkpoints written by a port trainer load in the reference's model
  wrappers with the shipped files' key names and shapes and give the
  port's outputs within 1e-5 (f32 networks).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from cslam_tpu.models import homographic_adaptation as jha
from cslam_tpu.models import lightglue as jlg
from cslam_tpu.models import superpoint as jsp
from cslam_tpu.models import synthetic_shapes as jss
from cslam_tpu.models import train_lightglue as jtl
from cslam_tpu.models import train_superpoint as jts
from cslam_tpu.models import zoo as jzoo
from cslam_tpu_torch.models import convert as tconvert
from cslam_tpu_torch.models import homographic_adaptation as tha
from cslam_tpu_torch.models import lightglue as tlg
from cslam_tpu_torch.models import superpoint as tsp
from cslam_tpu_torch.models import synthetic_shapes as tss
from cslam_tpu_torch.models import train_lightglue as ttl
from cslam_tpu_torch.models import train_superpoint as tts
from cslam_tpu_torch.models import training
from cslam_tpu_torch.models.cosplace import flax_init_, load_flat_weights
from cslam_tpu_torch.utils.image_sequence import open_sequence

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
GRAD_CLEAR = 1e-6
REAL_SEQ = os.path.join(os.path.dirname(__file__), "data", "real_seq")
SP_NPZ = jzoo.shipped_checkpoint("superpoint_synth.npz")


def flat_of(variables):
    return {k: np.asarray(v) for k, v in
            flatten_dict(variables, sep="/").items()}


def variables_of(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.fixture(autouse=True)
def no_onednn():
    """The port's CPU side without oneDNN (see the module docstring)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@contextlib.contextmanager
def reference_gradients():
    """A reference train_step built and first called inside returns its
    gradients where it returns the updated parameters: optax.adam(...)
    is the identity and apply_updates returns the updates."""
    saved = optax.adam, optax.apply_updates
    optax.adam = lambda schedule: optax.identity()
    optax.apply_updates = lambda params, updates: updates
    try:
        yield
    finally:
        optax.adam, optax.apply_updates = saved


def assert_grads_close(model, ref_grads, rtol=GRAD_RTOL):
    """The port's .grad per tensor against the reference's (a state_dict
    of numpy arrays); returns the worst relative norm."""
    worst = 0.0
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        err = np.linalg.norm(p.grad.cpu().numpy() - ref) / max(
            np.linalg.norm(ref), 1e-30)
        assert err <= rtol, (name, err)
        worst = max(worst, err)
    return worst


def assert_update_close(model, ref_params, ref_grads, atol=PARAM_ATOL):
    """Parameters after the first update against the reference's, where
    the reference's gradient is clear of zero; returns the share of
    components compared."""
    n = n_cmp = 0
    for name, p in model.named_parameters():
        clear = np.abs(ref_grads[name]) > GRAD_CLEAR
        diff = np.abs(p.detach().cpu().numpy() - ref_params[name])[clear]
        assert diff.size == 0 or diff.max() <= atol, (name, diff.max())
        n += clear.size
        n_cmp += int(clear.sum())
    return n_cmp / n


# ----------------------------------------------------------------------
# synthetic shapes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("background",
                         ["gradient", "black", "texture", "photo", "mixed"])
def test_render_shapes_is_bit_identical(background):
    for seed in range(3):
        a = jss.render_shapes(np.random.default_rng(seed), 48, 64,
                              background=background, return_ignore=True)
        b = tss.render_shapes(np.random.default_rng(seed), 48, 64,
                              background=background, return_ignore=True)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_pair_and_detector_samples_are_bit_identical():
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        a = jss.make_pair_sample(ra, 48, 64, background="mixed")
        b = tss.make_pair_sample(rb, 48, 64, background="mixed")
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        for x, y in zip(jss.make_detector_sample(ra, 40, 56),
                        tss.make_detector_sample(rb, 40, 56)):
            assert np.array_equal(x, y)
    Hm = tss.random_homography(np.random.default_rng(1), 48, 64)
    img = tss.render_shapes(np.random.default_rng(2), 48, 64)[0]
    for x, y in zip(jss.warp_image(img, Hm), tss.warp_image(img, Hm)):
        assert np.array_equal(x, y)


def test_photo_background_without_the_portrait_names_the_path(
        monkeypatch, tmp_path):
    missing = str(tmp_path / "grace_hopper.jpg")
    monkeypatch.setattr(tss, "_PHOTO", None)
    monkeypatch.setattr(tss, "photo_source_path", lambda: missing)
    with pytest.raises(FileNotFoundError, match="grace_hopper.jpg"):
        tss.render_shapes(np.random.default_rng(0), 48, 64,
                          background="photo")


def test_match_batch_uses_the_shared_homography_helpers():
    """train_lightglue keeps no copy of the homography helpers."""
    assert ttl.random_homography is tss.random_homography
    assert ttl.apply_homography is tss.apply_homography
    a = jtl.make_match_batch(np.random.default_rng(4), 2, K=32)
    b = ttl.make_match_batch(np.random.default_rng(4), 2, K=32)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# ----------------------------------------------------------------------
# homographic adaptation
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def superpoint_f32():
    """The shipped SuperPoint at f32 in both packages."""
    flat = tconvert.load_flat(SP_NPZ)
    jm = jsp.SuperPointNet(dtype=jnp.float32)
    tm = tsp.SuperPointNet(dtype=torch.float32)
    load_flat_weights(tm, tconvert.superpoint_state_dict(flat))
    return jm, variables_of(flat), tm.eval()


def _real_crops():
    seq = open_sequence(REAL_SEQ)
    return [np.ascontiguousarray(
        seq.frame(i).astype(np.float32).mean(-1)[16:80, 32:128] / 255.0)
        for i in (0, 9)]


@pytest.mark.skipif(not SP_NPZ, reason="no shipped weights")
def test_aggregate_heatmap_and_pseudo_corners_match_reference(
        superpoint_f32):
    jm, jvars, tm = superpoint_f32
    for img in _real_crops():
        h_ref, c_ref = jha.aggregate_heatmap(
            jm.apply, jvars, img, np.random.default_rng(5), n_warps=6)
        h, c = tha.aggregate_heatmap(
            tha.apply_superpoint, tm, img, np.random.default_rng(5),
            n_warps=6)
        np.testing.assert_allclose(h, h_ref, rtol=0, atol=1e-6)
        assert np.array_equal(c, c_ref)
        for thr in (0.010, 0.015):
            assert np.array_equal(tha.pseudo_corners(h, threshold=thr),
                                  jha.pseudo_corners(h_ref, threshold=thr))


@pytest.mark.skipif(not SP_NPZ, reason="no shipped weights")
def test_real_pseudo_dataset_matches_reference(superpoint_f32):
    jm, jvars, tm = superpoint_f32
    imgs = _real_crops()
    ref = jha.RealPseudoDataset(jm.apply, jvars, images=imgs,
                                rng=np.random.default_rng(6), n_warps=4)
    port = tha.RealPseudoDataset(tha.apply_superpoint, tm, images=imgs,
                                 rng=np.random.default_rng(6), n_warps=4)
    assert port.corner_counts() == ref.corner_counts()
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        a, b = ref.sample_pair(ra, 32, 48), port.sample_pair(rb, 32, 48)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_default_source_images_match_reference():
    a, b = jha.default_source_images(), tha.default_source_images()
    assert len(a) == len(b) == 31
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# ----------------------------------------------------------------------
# the shared optimizer and saver
# ----------------------------------------------------------------------


@pytest.mark.parametrize("lr,steps,alpha", [(1e-3, 1500, 0.1),
                                            (1e-3, 7, 0.05),
                                            (2e-4, 5, 0.1)])
def test_schedule_matches_optax_at_every_step(lr, steps, alpha):
    schedule = optax.cosine_decay_schedule(lr, steps, alpha)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = training.CosineAdam([p], lr, steps, alpha)
    for t in list(range(min(steps, 40))) + [steps - 1, steps, steps + 3]:
        while opt.optimizer.state.get(p, {}).get("step", 0) < t:
            p.grad = torch.ones(3)
            opt.step()
        np.testing.assert_allclose(opt.lr, float(schedule(t)), rtol=1e-6)


def test_adam_updates_match_optax():
    """Five updates of the same gradients: optax.adam under the schedule
    against CosineAdam, within 2.5e-7 (two f32 ulps of the |p| < 2 here:
    the two round the same update in another order)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(50).astype(np.float32)
    grads = [rng.standard_normal(50).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0, 1e-6, 1.0)]
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, 5, 0.1))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = training.CosineAdam([p], 1e-3, 5, 0.1)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=2.5e-7)


# ----------------------------------------------------------------------
# trainers
# ----------------------------------------------------------------------


def test_superpoint_two_steps_match_reference():
    H, W, B, lr = 32, 48, 2, 1e-3
    jm = jsp.SuperPointNet(dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 1)))
    flat = flat_of(variables)
    rng = np.random.default_rng(0)
    batches = [jts._batch(rng, B, H, W) for _ in range(2)]
    rng = np.random.default_rng(0)
    for a, b in zip(batches, [tts._batch(rng, B, H, W) for _ in range(2)]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)

    tx, step = jts.build_train_step(jm, lr, 10)
    params, state, ref_losses, ref_after = variables, tx.init(variables), \
        [], []
    for b in batches:
        params, state, *losses = step(params, state,
                                      tuple(map(jnp.asarray, b)))
        ref_losses.append([float(x) for x in losses])
        ref_after.append(tconvert.superpoint_state_dict(flat_of(params)))
    with reference_gradients():
        tx, gstep = jts.build_train_step(jm, lr, 10)
        grads, *_ = gstep(variables, tx.init(variables),
                          tuple(map(jnp.asarray, batches[0])))
    ref_grads = tconvert.superpoint_state_dict(flat_of(grads))

    tm = tsp.SuperPointNet(dtype=torch.float32)
    load_flat_weights(tm, tconvert.superpoint_state_dict(flat))
    _, train_step = tts.build_train_step(tm, lr, 10)
    for i, b in enumerate(batches):
        losses = [float(x) for x in train_step(b)]
        np.testing.assert_allclose(losses, ref_losses[i], rtol=LOSS_RTOL)
        if i == 0:
            assert_grads_close(tm, ref_grads)
            assert assert_update_close(tm, ref_after[0], ref_grads) > 0.5


def test_lightglue_with_aux_matches_reference():
    K = 24
    jm = jlg.LightGlueNet(num_layers=2)
    batch = jtl.make_match_batch(np.random.default_rng(1), 1, K=K)
    size = jnp.asarray([160.0, 120.0])
    args = [batch[0][0], jlg.normalize_keypoints(batch[1][0], size),
            batch[2][0], batch[3][0],
            jlg.normalize_keypoints(batch[4][0], size), batch[5][0]]
    variables = jm.init(jax.random.PRNGKey(3), *args)
    ref = jm.apply(variables, *args, with_aux=True)
    tm = tlg.LightGlueNet(num_layers=2)
    load_flat_weights(tm, tconvert.lightglue_state_dict(
        flat_of(variables), 2))
    with torch.no_grad():
        out = tm(*[torch.from_numpy(np.asarray(a)) for a in args],
                 with_aux=True)
        plain = tm(*[torch.from_numpy(np.asarray(a)) for a in args])
    assert torch.equal(out[0], plain)
    for x, y in zip(out, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-4)


def test_lightglue_two_steps_match_reference():
    K, B, layers, lr = 32, 2, 2, 2e-4
    jm = jlg.LightGlueNet(num_layers=layers)
    dummy = (jnp.zeros((K, 256)), jnp.zeros((K, 2)), jnp.ones(K),
             jnp.zeros((K, 256)), jnp.zeros((K, 2)), jnp.ones(K))
    variables = jm.init(jax.random.PRNGKey(0), *dummy)
    flat = flat_of(variables)
    rng = np.random.default_rng(2)
    batches = [jtl.make_match_batch(rng, B, K=K) for _ in range(2)]

    def state_of(v):
        return tconvert.lightglue_state_dict(flat_of(v), layers)

    tx, step = jtl.build_train_step(jm, lr, 10)
    params, st, ref_losses, ref_after = variables, tx.init(variables), [], []
    for b in batches:
        params, st, loss = step(params, st, tuple(map(jnp.asarray, b)))
        ref_losses.append(float(loss))
        ref_after.append(state_of(params))
    with reference_gradients():
        tx, gstep = jtl.build_train_step(jm, lr, 10)
        grads, *_ = gstep(variables, tx.init(variables),
                          tuple(map(jnp.asarray, batches[0])))
    ref_grads = state_of(grads)

    tm = tlg.LightGlueNet(num_layers=layers)
    load_flat_weights(tm, tconvert.lightglue_state_dict(flat, layers))
    _, train_step = ttl.build_train_step(tm, lr, 10)
    for i, b in enumerate(batches):
        np.testing.assert_allclose(float(train_step(b)), ref_losses[i],
                                   rtol=LOSS_RTOL)
        if i == 0:
            assert_grads_close(tm, ref_grads)
            assert assert_update_close(tm, ref_after[0], ref_grads) > 0.5


# ----------------------------------------------------------------------
# checkpoints across packages
# ----------------------------------------------------------------------


def _shipped_keys(name):
    with np.load(jzoo.shipped_checkpoint(name)) as data:
        return {k: data[k].shape for k in data.files}


@pytest.mark.skipif(not SP_NPZ, reason="no shipped weights")
def test_superpoint_checkpoint_loads_in_reference(tmp_path):
    tm = flax_init_(tsp.SuperPointNet(dtype=torch.float32), 3)
    path = str(tmp_path / "sp.npz")
    tts.save_params(tm, path)
    with np.load(path) as data:
        assert {k: data[k].shape for k in data.files} == \
            _shipped_keys("superpoint_synth.npz")
    ref = jsp.SuperPointNet(dtype=jnp.float32)
    img = tss.render_shapes(np.random.default_rng(0), 64, 96)[0]
    out_ref = ref.apply(variables_of(tconvert.load_flat(path)),
                        jnp.asarray(img)[None, :, :, None])
    with torch.no_grad():
        out = tm(torch.from_numpy(img)[None, :, :, None])
    for x, y in zip(out, out_ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-5)
    # and the reference's runtime wrapper reads it
    sp = jsp.SuperPoint(checkpoint=path, max_keypoints=32)
    assert np.asarray(sp.extract_features(img)[0]).shape == (32, 2)


def test_lightglue_checkpoint_loads_in_reference(tmp_path):
    tm = flax_init_(tlg.LightGlueNet(num_layers=3), 4)
    path = str(tmp_path / "lg.npz")
    ttl.save_params(tm, path)
    if jzoo.shipped_checkpoint("lightglue_synth.npz"):
        with np.load(path) as data:
            assert {k: data[k].shape for k in data.files} == \
                _shipped_keys("lightglue_synth.npz")
    wrapper = jlg.LightGlue(checkpoint=path, num_layers=3)
    d0, p0, m0, d1, p1, m1 = (x[0] for x in
                              ttl.make_match_batch(np.random.default_rng(5),
                                                   1, K=32)[:6])
    size = np.array([160.0, 120.0], np.float32)
    ref = wrapper.model.apply(
        wrapper.variables, jnp.asarray(d0),
        jlg.normalize_keypoints(jnp.asarray(p0), jnp.asarray(size)),
        jnp.asarray(m0), jnp.asarray(d1),
        jlg.normalize_keypoints(jnp.asarray(p1), jnp.asarray(size)),
        jnp.asarray(m1))
    t = [torch.from_numpy(x) for x in (d0, p0, m0, d1, p1, m1, size)]
    with torch.no_grad():
        out = tm(t[0], tlg.normalize_keypoints(t[1], t[6]), t[2], t[3],
                 tlg.normalize_keypoints(t[4], t[6]), t[5])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
