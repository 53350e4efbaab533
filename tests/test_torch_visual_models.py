"""Port parity, visual verification models: SuperPoint and LightGlue of
cslam_tpu_torch against cslam_tpu on the same seeded numpy inputs, on
the CPU: JAX random inits carried across through the flat layout, the
shipped superpoint_synth.npz / lightglue_synth.npz (LightGlue at its
shipped 3 layers), 120x160 images and K <= 128 keypoints.

Tolerances:
- SuperPoint at f32: heatmap and descriptors max abs <= 1e-5, keypoints
  (padded slots included) and masks identical.
- SuperPoint at bf16 (the reference's default): descriptors max abs
  <= 2e-3 and cosine >= 0.9999 over the descriptor map (the bf16
  CosPlace bounds of tests/test_torch_models.py); the heatmap max abs
  <= 3e-3 (a softmax of logits whose bf16 inputs round at other places;
  measured up to 2.1e-3 with the shipped weights, 7.6e-6 at random
  init), a bound that the same network with its f32 heads computed in
  bf16 exceeds (measured 5.7e-3);
  at least 95% of the keypoints identical (keypoint choice after bf16
  logits can pick a neighbouring pixel near the threshold; measured
  98.4-100% per image).
- LightGlue log-assignment scores (f32): max abs <= 1e-4 on valid
  entries, -inf on the same padded entries, identical mutual matches;
  on real SuperPoint features, whose scores reach -130, 1e-4 + 2e-6
  |score| (f32 rounding at that size, ROADMAP queue 3; LightGlue with
  TF32 products exceeds it on the card, chip_smoke.py's control).
- Weight layouts: npz <-> state_dict round trips bit-exact; ONNX
  imports identical to the reference's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from cslam_tpu.frontend import sim as jsim
from cslam_tpu.models import convert as jconvert
from cslam_tpu.models import lightglue as jlg
from cslam_tpu.models import onnx_import as jonnx
from cslam_tpu.models import superpoint as jsp
from cslam_tpu.models import train_lightglue as jtl
from cslam_tpu.models import zoo as jzoo
from cslam_tpu_torch.models import convert as tconvert
from cslam_tpu_torch.models import lightglue as tlg
from cslam_tpu_torch.models import onnx_import as tonnx
from cslam_tpu_torch.models import superpoint as tsp
from cslam_tpu_torch.models import train_lightglue as ttl
from cslam_tpu_torch.models import zoo as tzoo

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_lightglue_parity import TorchLightGlue  # noqa: E402
from test_lightglue_parity import DIM as OFFICIAL_DIM  # noqa: E402
from test_lightglue_parity import LAYERS as OFFICIAL_LAYERS  # noqa: E402
from test_onnx_import import (_superpoint_state, node_proto,  # noqa: E402
                              write_onnx)
from test_rgbd_handler import INTR, make_pose  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-3
BF16_HEAT_TOL = 3e-3
BF16_MIN_COS = 0.9999
BF16_MIN_KEYPOINT_OVERLAP = 0.95
SCORE_TOL = 1e-4
SP_NPZ = tzoo.shipped_checkpoint("superpoint_synth.npz")
LG_NPZ = tzoo.shipped_checkpoint("lightglue_synth.npz")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def flat_of(variables):
    return {k: np.asarray(v) for k, v in
            flatten_dict(variables, sep="/").items()}


def variables_of(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def images(n=3, seed=0):
    """Rendered 120x160 corner scenes (the shipped models' training
    distribution), as float images in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pose = make_pose(rng.uniform(-1, 1), rng.uniform(-0.3, 0.3),
                         rng.uniform(-0.2, 0.2))
        img, _ = jsim.render_corner_scene(pose, INTR, rng)
        out.append(img.astype(np.float32) / 255.0)
    return out


def superpoint_pair(weights, dtype):
    """(JAX variables, JAX module, port module) computing one function."""
    jdt, tdt = DTYPES[dtype]
    jmodel = jsp.SuperPointNet(dtype=jdt)
    if weights == "shipped":
        flat = tconvert.load_flat(SP_NPZ)
    else:
        flat = flat_of(jmodel.init(jax.random.PRNGKey(3),
                                   jnp.zeros((1, 64, 64, 1))))
    tmodel = tsp.SuperPointNet(dtype=tdt)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in
                            tconvert.superpoint_state_dict(flat).items()},
                           strict=True)
    return variables_of(flat), jmodel, tmodel.eval()


def j_extract(variables, jmodel, img, K):
    return [np.asarray(a) for a in jsp.extract(
        variables, lambda v, x: jmodel.apply(v, x), jnp.asarray(img),
        max_keypoints=K)]


def t_extract(tmodel, img, K):
    return [a.numpy() for a in tsp.extract(tmodel, torch.from_numpy(img),
                                           max_keypoints=K)]


@pytest.mark.parametrize("weights", ["random", "shipped"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_superpoint_matches_reference(weights, dtype):
    variables, jmodel, tmodel = superpoint_pair(weights, dtype)
    K = 128
    same, total = 0, 0
    for img in images(2, seed=1 if weights == "random" else 2):
        det_j, desc_j = jmodel.apply(variables, jnp.asarray(img)[None, :, :,
                                                                 None])
        heat_j = np.asarray(jsp._cell_scores_to_heatmap(det_j))
        with torch.no_grad():
            det_t, desc_t = tmodel(torch.from_numpy(img)[None, :, :, None])
        heat_t = tsp._cell_scores_to_heatmap(det_t).numpy()
        desc_j, desc_t = np.asarray(desc_j), desc_t.numpy()
        xy_j, d_j, s_j, m_j = j_extract(variables, jmodel, img, K)
        xy_t, d_t, s_t, m_t = t_extract(tmodel, img, K)
        if dtype == "f32":
            np.testing.assert_allclose(heat_t, heat_j, atol=F32_TOL)
            np.testing.assert_allclose(desc_t, desc_j, atol=F32_TOL)
            np.testing.assert_array_equal(m_t, m_j)
            np.testing.assert_array_equal(xy_t, xy_j)
            np.testing.assert_allclose(d_t, d_j, atol=F32_TOL)
            np.testing.assert_allclose(s_t, s_j, atol=F32_TOL)
        else:
            np.testing.assert_allclose(heat_t, heat_j, atol=BF16_HEAT_TOL)
            np.testing.assert_allclose(desc_t, desc_j, atol=BF16_TOL)
            assert np.min(np.sum(desc_t * desc_j, axis=-1)) >= BF16_MIN_COS
        ref = {tuple(p) for p in xy_j[m_j > 0]}
        same += sum(tuple(p) in ref for p in xy_t[m_t > 0])
        total += max(len(ref), int(m_t.sum()))
    overlap = same / max(total, 1)
    assert overlap >= BF16_MIN_KEYPOINT_OVERLAP, \
        f"{weights} {dtype}: keypoint overlap {overlap:.4f}"


def test_superpoint_bf16_heat_bound_rejects_bf16_heads():
    """The control of BF16_HEAT_TOL: the shipped bf16 network with its two
    f32 1x1 heads computed in bf16, the next lower precision, lies beyond
    the bound against the reference on the parity test's images."""
    variables, jmodel, tmodel = superpoint_pair("shipped", "bf16")
    tmodel.convPb.compute_dtype = torch.bfloat16
    tmodel.convDb.compute_dtype = torch.bfloat16
    worst = 0.0
    for img in images(2, seed=2):
        det_j, _ = jmodel.apply(variables, jnp.asarray(img)[None, :, :,
                                                            None])
        heat_j = np.asarray(jsp._cell_scores_to_heatmap(det_j))
        with torch.no_grad():
            det_t, _ = tmodel(torch.from_numpy(img)[None, :, :, None])
        heat_t = tsp._cell_scores_to_heatmap(det_t.float()).numpy()
        worst = max(worst, float(np.abs(heat_t - heat_j).max()))
    assert worst > BF16_HEAT_TOL, worst


def test_superpoint_wrapper_with_shipped_weights():
    """SuperPoint(checkpoint=.npz) on the port = the reference wrapper
    (bf16) within the bf16 bounds; uint8 input scaled as the reference;
    the padded slots carry zero descriptors."""
    port = tsp.SuperPoint(checkpoint=SP_NPZ, max_keypoints=128,
                          device="cpu")
    ref = jsp.SuperPoint(checkpoint=SP_NPZ, max_keypoints=128)
    assert port.model.dtype == torch.bfloat16
    # loaded (not random init): the weights are the checkpoint's
    want = tconvert.superpoint_state_dict(flat_of(ref.variables))
    for k, v in port.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    img = (images(1, seed=5)[0] * 255).astype(np.uint8)
    xy_t, d_t, s_t, m_t = (a.numpy() for a in port.extract_features(img))
    xy_j, d_j, s_j, m_j = (np.asarray(a) for a in ref.extract_features(img))
    ref_set = {tuple(p) for p in xy_j[m_j > 0]}
    overlap = sum(tuple(p) in ref_set for p in xy_t[m_t > 0]) / max(
        len(ref_set), 1)
    assert overlap >= BF16_MIN_KEYPOINT_OVERLAP, overlap
    assert np.all(d_t[m_t == 0] == 0)
    np.testing.assert_allclose(np.linalg.norm(d_t[m_t > 0], axis=1), 1.0,
                               atol=1e-5)


def test_superpoint_state_dict_round_trip_is_exact():
    flat = tconvert.load_flat(SP_NPZ)
    sd = tconvert.superpoint_state_dict(flat)
    back = jconvert.convert_superpoint(sd)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])
    sd2 = tconvert.superpoint_state_dict(tconvert.convert_superpoint(sd))
    assert set(sd2) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(sd2[k], sd[k])
    # the port's state_dict keys are the module's, strictly
    tsp.SuperPointNet().load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)


# -- LightGlue --------------------------------------------------------------

def lightglue_pair(weights, num_layers, dim=256):
    jmodel = jlg.LightGlueNet(dim=dim, num_layers=num_layers,
                              input_dim=dim)
    if weights == "shipped":
        flat = tconvert.load_flat(LG_NPZ)
    else:
        K = 8
        flat = flat_of(jmodel.init(
            jax.random.PRNGKey(1), jnp.zeros((K, dim)), jnp.zeros((K, 2)),
            jnp.ones(K), jnp.zeros((K, dim)), jnp.zeros((K, 2)),
            jnp.ones(K)))
    tmodel = tlg.LightGlueNet(dim=dim, num_layers=num_layers,
                              input_dim=dim)
    tmodel.load_state_dict(
        {k: torch.from_numpy(v) for k, v in
         tconvert.lightglue_state_dict(flat, num_layers).items()},
        strict=True)
    return variables_of(flat), jmodel, tmodel.eval()


def match_inputs(seed, K=128, D=256, pad0=9, pad1=17):
    """Correlated descriptor sets with padded slots on both sides."""
    rng = np.random.default_rng(seed)
    d0, xy0, _, d1, xy1, _, _, _, _ = ttl.make_match_batch(
        rng, 1, K=K, D=D, noise_lo=0.6, noise_hi=0.6)
    m0 = np.ones(K, np.float32)
    m1 = np.ones(K, np.float32)
    m0[K - pad0:] = 0
    m1[K - pad1:] = 0
    size = np.array([160.0, 120.0], np.float32)
    n0 = (xy0[0] - size / 2) / (size.max() / 2)
    n1 = (xy1[0] - size / 2) / (size.max() / 2)
    return d0[0], n0.astype(np.float32), m0, d1[0], n1.astype(np.float32), \
        m1


def assert_scores_close(s_t, s_j, m0, m1):
    valid = (m0[:, None] > 0) & (m1[None, :] > 0)
    assert np.all(np.isneginf(s_t[~valid])) and \
        np.all(np.isneginf(s_j[~valid]))
    np.testing.assert_allclose(s_t[valid], s_j[valid], atol=SCORE_TOL)


@pytest.mark.parametrize("weights,layers,dim", [("random", 2, 256),
                                                ("random", 2, 64),
                                                ("shipped", 3, 256)])
def test_lightglue_matches_reference(weights, layers, dim):
    variables, jmodel, tmodel = lightglue_pair(weights, layers, dim)
    for seed in (0, 1):
        args = match_inputs(seed, D=dim)
        s_j = np.asarray(jmodel.apply(variables, *map(jnp.asarray, args)))
        with torch.no_grad():
            s_t = tmodel(*map(torch.from_numpy, args)).numpy()
        assert_scores_close(s_t, s_j, args[2], args[5])
        idx_t, val_t = tlg.mutual_matches(torch.from_numpy(s_t),
                                          torch.from_numpy(args[2]), 0.1)
        p = np.exp(s_j)
        best1, best0 = p.argmax(1), p.argmax(0)
        val_j = (best0[best1] == np.arange(len(best1))) & \
            (p.max(1) > 0.1) & (args[2] > 0)
        np.testing.assert_array_equal(val_t.numpy(), val_j)
        np.testing.assert_array_equal(idx_t.numpy()[val_j], best1[val_j])
    # a leading batch dimension computes each pair as alone
    batch = [match_inputs(s, D=dim) for s in (0, 1)]
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*batch)]
    with torch.no_grad():
        s_b = tmodel(*stacked).numpy()
        s_1 = tmodel(*map(torch.from_numpy, batch[1])).numpy()
    assert_scores_close(s_b[1], s_1, batch[1][2], batch[1][5])


def test_lightglue_wrapper_matches_reference_wrapper():
    """LightGlue.match on the port = the reference's, shipped weights,
    pixel keypoints normalized by the image size."""
    port = tlg.LightGlue(checkpoint=LG_NPZ, num_layers=3, device="cpu")
    ref = jlg.LightGlue(checkpoint=LG_NPZ, num_layers=3)
    rng = np.random.default_rng(7)
    d0, xy0, m0, d1, xy1, m1, *_ = ttl.make_match_batch(
        rng, 1, K=128, noise_lo=0.5, noise_hi=0.5)
    m0 = m0[0].copy()
    m0[-5:] = 0
    args = (d0[0], xy0[0], m0, d1[0], xy1[0], m1[0])
    for size in ((160, 120), None):
        idx_t, val_t = port.match(*args, size=size)
        idx_j, val_j = ref.match(*args, size=size)
        np.testing.assert_array_equal(val_t, val_j)
        np.testing.assert_array_equal(idx_t[val_t > 0], idx_j[val_j > 0])
        assert idx_t.dtype == np.int32 and val_t.dtype == np.float32
        assert val_t.sum() > 20


def test_official_torch_lightglue_loads_strictly():
    """The official-topology torch LightGlue of test_lightglue_parity.py
    (official module names, forward math) loads into the port's module
    strictly once its early-exit heads are left out, and both give the
    same scores."""
    torch.manual_seed(3)
    ref = TorchLightGlue().eval()
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    model = tlg.LightGlueNet(dim=OFFICIAL_DIM, num_layers=OFFICIAL_LAYERS,
                             input_dim=OFFICIAL_DIM)
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in
         tlg.official_state(state, OFFICIAL_LAYERS).items()}, strict=True)
    rng = np.random.default_rng(0)
    K = 12
    d0, d1 = (rng.standard_normal((K, OFFICIAL_DIM)).astype(np.float32)
              for _ in range(2))
    xy0, xy1 = (rng.uniform(-1, 1, (K, 2)).astype(np.float32)
                for _ in range(2))
    with torch.no_grad():
        want = ref(*(torch.from_numpy(a)[None]
                     for a in (d0, xy0, d1, xy1)))[0].numpy()
        ones = torch.ones(K)
        got = model(torch.from_numpy(d0), torch.from_numpy(xy0), ones,
                    torch.from_numpy(d1), torch.from_numpy(xy1),
                    ones).numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)
    # the flat layout carries the same weights both ways
    flat = jconvert.convert_lightglue(state, num_layers=OFFICIAL_LAYERS)
    sd = tconvert.lightglue_state_dict(flat, OFFICIAL_LAYERS)
    for k, v in sd.items():
        np.testing.assert_array_equal(v, state[k])


def test_lightglue_state_dict_round_trip_is_exact():
    layers = tzoo.SHIPPED_LIGHTGLUE_LAYERS
    assert layers == jzoo.SHIPPED_LIGHTGLUE_LAYERS == 3
    flat = tconvert.load_flat(LG_NPZ)
    sd = tconvert.lightglue_state_dict(flat, layers)
    back = jconvert.convert_lightglue(sd, num_layers=layers)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])
    sd2 = tconvert.lightglue_state_dict(
        tconvert.convert_lightglue(sd, num_layers=layers), layers)
    assert set(sd2) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(sd2[k], sd[k])


def _chip_smoke():
    """chip_smoke.py as a module: its shipped-weight gates take a device,
    so the card and the CPU run one implementation."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shipped_lightglue_beats_raw_matching_under_noise():
    """The reference's shipped-weight gate (tests/test_trained_weights.py
    test_lightglue_beats_raw_matching_under_noise) through the port's
    eval_matching (chip_smoke.py's check, which the card runs too): at
    sigma = 0.7, F1 above raw mutual matching's by more than 0.05 and
    precision >= 0.85; the same numbers as the reference's
    eval_matching on the same seed."""
    ev = _chip_smoke().check_lightglue_quality("cpu")
    assert ev["lightglue_f1"] > ev["raw_f1"] + 0.05, ev
    assert ev["lightglue"]["precision"] >= 0.85, ev
    ref = jtl.eval_matching(jlg.LightGlueNet(num_layers=3),
                            variables_of(tconvert.load_flat(LG_NPZ)),
                            np.random.default_rng(4321), n_pairs=16, K=96,
                            sigma=0.7)
    for name in ("lightglue", "raw"):
        for key in ("precision", "recall"):
            assert abs(ev[name][key] - ref[name][key]) <= 0.01, (ev, ref)


def test_make_match_batch_is_the_references():
    a = ttl.make_match_batch(np.random.default_rng(9), 2, K=32, D=16)
    b = jtl.make_match_batch(np.random.default_rng(9), 2, K=32, D=16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- ONNX import -------------------------------------------------------------

def _superpoint_onnx(tmp_path, mangled):
    state, names = _superpoint_state(np.random.default_rng(1))
    inits, nodes, prev = {}, [], "image"
    for i, n in enumerate(names):
        w, b = ((f"onnx::Conv_{100 + i}", f"onnx::Conv_{200 + i}")
                if mangled else (f"{n}.weight", f"{n}.bias"))
        inits[w], inits[b] = state[f"{n}.weight"], state[f"{n}.bias"]
        nodes.append(node_proto("Conv", [prev, w, b], [f"o{i}"], name=n))
        prev = f"o{i}"
    path = str(tmp_path / f"sp_{int(mangled)}.onnx")
    write_onnx(path, inits, nodes)
    return path, state


@pytest.mark.parametrize("mangled", [False, True])
def test_onnx_import_matches_reference(tmp_path, mangled):
    path, state = _superpoint_onnx(tmp_path, mangled)
    got = tonnx.convert_superpoint_onnx(path)
    want = jonnx.convert_superpoint_onnx(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    init_t, nodes_t = tonnx.read_onnx(path)
    init_j, nodes_j = jonnx.read_onnx(path)
    assert [tuple(x) for x in nodes_t] == [tuple(x) for x in nodes_j]
    for k in init_j:
        np.testing.assert_array_equal(init_t[k], init_j[k])
    # the wrapper loads the .onnx: the MagicLeap state_dict exactly
    sp = tsp.SuperPoint(checkpoint=path, device="cpu", max_keypoints=16)
    for k, v in sp.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    xy, desc, _, mask = sp.extract_features(np.zeros((64, 64), np.uint8))
    assert xy.shape == (16, 2) and desc.shape == (16, 256)


def test_cosplace_onnx_prefix_strip(tmp_path):
    from cslam_tpu_torch.models import cosplace as tcp
    flat = tconvert.load_flat(tzoo.shipped_checkpoint("cosplace_synth.npz"))
    state = {f"model.{k}": v
             for k, v in tconvert.cosplace_state_dict(flat).items()}
    path = str(tmp_path / "eigenplaces.onnx")
    write_onnx(path, state, [node_proto("Conv", ["image"], ["out"])])
    got = tonnx.convert_cosplace_onnx(path)
    want = jonnx.convert_cosplace_onnx(path)
    assert set(got) == set(want) == set(flat)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], flat[k])
    tcp.load_flat_weights(tcp.GeoLocalizationNet(),
                          tconvert.cosplace_state_dict(got))


def test_lightglue_on_rendered_features_matches_reference():
    """The shipped LightGlue on real SuperPoint features of render pairs
    (the visual mission's inputs): scores reach -130, where f32 rounding
    through 3 layers alone is ~1e-4 (measured up to 1.2e-4, ROADMAP
    queue 3), so valid entries agree within 1e-4 + 2e-6 |score| (which
    TF32 products exceed, chip_smoke.py's control on the card); the
    mutual matches are identical."""
    variables, jmodel, tmodel = lightglue_pair("shipped", 3)
    sp = tsp.SuperPoint(SP_NPZ, 128, device="cpu")
    size = np.array([160.0, 120.0], np.float32)
    imgs = images(4, seed=8)
    for a, b in ((imgs[0], imgs[1]), (imgs[2], imgs[3]), (imgs[0], imgs[0])):
        feats = [[x.numpy() for x in sp.extract_features(im)]
                 for im in (a, b)]
        (xy0, d0, _, m0), (xy1, d1, _, m1) = feats
        args = (d0, ((xy0 - size / 2) / 80.0).astype(np.float32), m0,
                d1, ((xy1 - size / 2) / 80.0).astype(np.float32), m1)
        s_j = np.asarray(jmodel.apply(variables, *map(jnp.asarray, args)))
        with torch.no_grad():
            s_t = tmodel(*map(torch.from_numpy, args)).numpy()
        valid = (m0[:, None] > 0) & (m1[None, :] > 0)
        np.testing.assert_allclose(s_t[valid], s_j[valid], rtol=2e-6,
                                   atol=SCORE_TOL)
        assert np.all(np.isneginf(s_t[~valid]))
        idx_t, val_t = tlg.mutual_matches(torch.from_numpy(s_t),
                                          torch.from_numpy(m0), 0.1)
        p = np.exp(s_j)
        best1, best0 = p.argmax(1), p.argmax(0)
        val_j = (best0[best1] == np.arange(len(best1))) & \
            (p.max(1) > 0.1) & (m0 > 0)
        np.testing.assert_array_equal(val_t.numpy(), val_j)
        np.testing.assert_array_equal(idx_t.numpy()[val_j], best1[val_j])
        assert val_j.sum() > 10
