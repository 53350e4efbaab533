"""Port parity, place-recognition models: cslam_tpu_torch against
cslam_tpu on the same seeded numpy inputs, on the CPU, with the shipped
weights at full width (cosplace_synth.npz: ResNet-18 64/128/256/512,
64-d head; netvlad_synth.npz + netvlad_pca_synth.npz: VGG16 conv5,
64 x 512 centroids, 128-d PCA) and small images (4 renders, crops of
72-224 pixels).

Tolerances, on unit descriptors:
- f32 (both packages compute every layer in f32): max |port - reference|
  <= 1e-5. Only the summation order differs.
- bf16 (the reference's default: bf16 convs, f32 BatchNorm and head):
  max |port - reference| <= 2e-3 and cosine >= 0.9999. XLA and torch
  accumulate a bf16 conv in other orders, so an output near a rounding
  boundary rounds to the neighbouring bf16 value and the flips grow
  over the layers.
Renders, preprocessing and weight layouts are exact (bit-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from cslam_tpu.frontend import sim as jsim
from cslam_tpu.models import convert as jconvert
from cslam_tpu.models import cosplace as jcp
from cslam_tpu.models import netvlad as jnv
from cslam_tpu.models import train_cosplace as jtc
from cslam_tpu_torch import device as tdevice
from cslam_tpu_torch.frontend import sim as tsim
from cslam_tpu_torch.models import convert as tconvert
from cslam_tpu_torch.models import cosplace as tcp
from cslam_tpu_torch.models import netvlad as tnv
from cslam_tpu_torch.models import train_cosplace as ttc
from cslam_tpu_torch.models import zoo as tzoo

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-3
BF16_MIN_COS = 0.9999
CPU = torch.device("cpu")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_descriptors_close(port, ref, dtype):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(port, axis=-1), 1.0,
                               atol=1e-5)
    if dtype == "f32":
        np.testing.assert_allclose(port, ref, rtol=0, atol=F32_TOL)
    else:
        np.testing.assert_allclose(port, ref, rtol=0, atol=BF16_TOL)
        assert np.min(np.sum(port * ref, axis=-1)) >= BF16_MIN_COS


def _views(n=4, seed=99):
    """n grey renders of one world (as (n, 120, 160, 3) uint8), made by
    the port's renderer."""
    world = ttc.make_world(seed, n=160)
    xys = [(-1.0, 0.0), (1.5, 1.0), (0.3, -0.7), (2.0, 0.4)][:n]
    ims = [ttc.render_view(world, xy, np.random.default_rng(i), 0.3, 0.05)
           for i, xy in enumerate(xys)]
    return np.stack([np.broadcast_to(im[..., None], im.shape + (3,))
                     for im in ims])


def _variables(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.fixture(scope="module")
def views():
    return _views()


@pytest.fixture(scope="module")
def cosplace_flat():
    return tconvert.load_flat(tzoo.shipped_checkpoint("cosplace_synth.npz"))


@pytest.fixture(scope="module")
def netvlad_flat():
    return tconvert.load_flat(tzoo.shipped_checkpoint("netvlad_synth.npz"))


# ----------------------------------------------------------------------
# Renders, preprocessing, weights
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["world", "seeded_scene", "yawed"])
def test_render_corner_scene_is_byte_identical(case):
    """Same seed and pose: the same image and depth bytes, and the
    caller's RNG left in the same state."""
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    R, t = np.eye(3, dtype=np.float32), np.array([0.4, -0.3, 0.0],
                                                  np.float32)
    kw = {}
    if case == "world":
        kw = dict(zip(("squares_w", "shades"), ttc.make_world(3)))
    elif case == "seeded_scene":
        kw = dict(n=50, seed=11)
    else:
        R = ttc._yaw_R(0.05)
    img_t, dep_t = tsim.render_corner_scene((R, t), ttc._Intr, rng_t, **kw)
    img_j, dep_j = jsim.render_corner_scene((R, t), jtc._Intr, rng_j, **kw)
    assert img_t.dtype == np.uint8 and img_t.shape == (120, 160)
    assert img_t.tobytes() == img_j.tobytes()
    assert dep_t.tobytes() == dep_j.tobytes()
    assert rng_t.random() == rng_j.random()


def test_render_view_and_places_match_reference():
    world_t, world_j = ttc.make_world(31337), jtc.make_world(31337)
    np.testing.assert_array_equal(world_t[0], world_j[0])
    np.testing.assert_array_equal(world_t[1], world_j[1])
    batch_t, labels_t = ttc.make_batch(np.random.default_rng(2), world_t,
                                       3, 2, 0.35, 0.06, 64)
    batch_j, labels_j = jtc.make_batch(np.random.default_rng(2), world_j,
                                       3, 2, 0.35, 0.06, 64)
    assert batch_t.tobytes() == batch_j.tobytes()
    np.testing.assert_array_equal(labels_t, labels_j)


@pytest.mark.parametrize("crop", [64, 96, 224])
@pytest.mark.parametrize("kind", ["uint8", "float", "single"])
def test_preprocess_is_identical(views, crop, kind):
    images = {"uint8": views, "float": views[:, :100].astype(np.float64),
              "single": views[0]}[kind]
    out = tcp.preprocess(images, crop)
    ref = jcp.preprocess(images, crop)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert out.tobytes() == ref.tobytes()


def test_cosplace_state_dict_round_trip_is_exact(cosplace_flat):
    """npz -> the port's state_dict -> flat again (convert_cosplace) is
    bit-exact, and the port's model takes the state_dict strictly."""
    state = tconvert.cosplace_state_dict(cosplace_flat)
    back = tconvert.convert_cosplace(state)
    assert sorted(back) == sorted(cosplace_flat)
    for k, v in cosplace_flat.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    model = tcp.GeoLocalizationNet(64)
    assert sorted(model.state_dict()) == sorted(state)
    tcp.load_flat_weights(model, state)
    np.testing.assert_array_equal(
        model.backbone.layer2[0].downsample[0].weight.detach().numpy(),
        np.transpose(cosplace_flat[
            "params/ResNet18Backbone_0/BasicBlock_2/Conv_2/kernel"],
            (3, 2, 0, 1)))


def test_netvlad_state_dict_round_trip_is_exact(netvlad_flat):
    state = tconvert.netvlad_state_dict(netvlad_flat)
    model = tnv.NetVLADNet()
    assert sorted(model.state_dict()) == sorted(state)
    back = tconvert.convert_netvlad_layer(state, prefix="pool.")
    for i, idx in enumerate(tconvert.VGG16_CONV_INDICES):
        fp = f"params/VGG16Conv5_0/Conv_{i}"
        back[f"{fp}/kernel"] = tconvert._conv(state[f"encoder.{idx}.weight"])
        back[f"{fp}/bias"] = state[f"encoder.{idx}.bias"]
    assert sorted(back) == sorted(netvlad_flat)
    for k, v in netvlad_flat.items():
        assert back[k].tobytes() == v.tobytes()


def _torch_style_state(rng):
    """A torchvision-resnet18-keyed CosPlace state_dict with random
    values (numpy), as a downloaded checkpoint holds."""
    model = tcp.GeoLocalizationNet(32)
    state = {}
    for k, v in model.state_dict().items():
        state[k] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    return state


@pytest.mark.parametrize("prefixed", [True, False])
def test_convert_cosplace_matches_reference(prefixed):
    state = _torch_style_state(np.random.default_rng(0))
    if not prefixed:
        state = {k.replace("backbone.", ""): v for k, v in state.items()}
        state["gem.p"] = state.pop("aggregation.1.p")
        state["fc.weight"] = state.pop("aggregation.3.weight")
        state["fc.bias"] = state.pop("aggregation.3.bias")
    port = tconvert.convert_cosplace(state)
    ref = jconvert.convert_cosplace(state)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].tobytes() == np.asarray(ref[k]).tobytes()


def test_other_converters_match_reference():
    """The copied SuperPoint, LightGlue and NetVLAD-layer converters give
    the reference's flat dicts."""
    rng = np.random.default_rng(3)
    names = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
             "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb"]
    sp = {}
    for n in names:
        sp[f"{n}.weight"] = rng.standard_normal((4, 3, 3, 3))
        sp[f"{n}.bias"] = rng.standard_normal(4)
    lg = {"posenc.Wr.weight": rng.standard_normal((8, 2))}
    for i in range(2):
        for att, lins in (("self_attn", ("Wqkv", "out_proj")),
                          ("cross_attn", ("to_qk", "to_v", "to_out"))):
            for lin in lins + ("ffn.0", "ffn.1", "ffn.3"):
                lg[f"transformers.{i}.{att}.{lin}.weight"] = \
                    rng.standard_normal((4, 4))
                lg[f"transformers.{i}.{att}.{lin}.bias"] = \
                    rng.standard_normal(4)
    for head in ("final_proj", "matchability"):
        lg[f"log_assignment.1.{head}.weight"] = rng.standard_normal((4, 4))
        lg[f"log_assignment.1.{head}.bias"] = rng.standard_normal(4)
    nv = {"pool.centroids": rng.standard_normal((4, 8)),
          "pool.conv.weight": rng.standard_normal((4, 8, 1, 1))}
    for port, ref in (
            (tconvert.convert_superpoint(sp), jconvert.convert_superpoint(sp)),
            (tconvert.convert_lightglue(lg, 2),
             jconvert.convert_lightglue(lg, 2)),
            (tconvert.convert_netvlad_layer(nv),
             jconvert.convert_netvlad_layer(nv))):
        assert sorted(port) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k])


# ----------------------------------------------------------------------
# The networks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,crop", [("f32", 96), ("bf16", 96),
                                        ("f32", 72)])
def test_geolocalization_net_matches_reference(views, cosplace_flat, dtype,
                                               crop):
    """Shipped weights at full width. Crop 72 gives odd feature maps
    (9 -> 5 -> 3) through the stride-2 convs and 1x1 downsamples."""
    jdt, tdt = DTYPES[dtype]
    batch = tcp.preprocess(views, crop)
    jm = jcp.GeoLocalizationNet(fc_output_dim=64, dtype=jdt)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _variables(cosplace_flat), jnp.asarray(batch)))
    model = tcp.load_flat_weights(tcp.GeoLocalizationNet(64, dtype=tdt),
                                  tconvert.cosplace_state_dict(cosplace_flat))
    out = tcp.embed(model.eval(), batch, CPU)
    assert_descriptors_close(out, ref, dtype)


@pytest.mark.parametrize("dtype,crop", [("f32", 96), ("bf16", 96),
                                        ("f32", 72)])
def test_netvlad_net_matches_reference(views, netvlad_flat, dtype, crop):
    """Shipped weights, 32768-d VLAD before PCA. Crop 72: the 2x2 VALID
    pools floor an odd map (9 -> 4)."""
    jdt, tdt = DTYPES[dtype]
    batch = tcp.preprocess(views, crop)
    jm = jnv.NetVLADNet(dtype=jdt)
    ref = np.asarray(jax.jit(jm.apply)(_variables(netvlad_flat),
                                       jnp.asarray(batch)))
    model = tcp.load_flat_weights(tnv.NetVLADNet(dtype=tdt),
                                  tconvert.netvlad_state_dict(netvlad_flat))
    out = tcp.embed(model.eval(), batch, CPU)
    assert out.shape == (4, 64 * 512)
    assert_descriptors_close(out, ref, dtype)


def _f32_network(wrapper):
    """The port's side of the f32 variant: the wrapper's network swapped
    for the same architecture computing in f32, same weights."""
    f32 = tcp.GeoLocalizationNet(wrapper.fc_output_dim, dtype=torch.float32) \
        if isinstance(wrapper, tcp.CosPlace) \
        else tnv.NetVLADNet(dtype=torch.float32)
    f32.load_state_dict(wrapper.model.state_dict())
    wrapper.model = f32.eval().to(wrapper.device)
    return wrapper


def _port_wrapper(cls, dtype):
    port = cls({"frontend.nn_checkpoint": "shipped"}, device="cpu")
    return _f32_network(port) if dtype == "f32" else port


def _reference_wrapper(cls, module, dtype, **kw):
    """The reference wrapper; at f32 its network is swapped for the same
    architecture computing in f32 (its jit looks the model up at the
    first call)."""
    ref = cls({"frontend.nn_checkpoint": "shipped"}, **kw)
    if dtype == "f32":
        ref.model = module(dtype=jnp.float32, **(
            {"fc_output_dim": ref.fc_output_dim} if cls is jcp.CosPlace
            else {}))
    return ref


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cosplace_wrapper_matches_reference(views, dtype):
    """The full deploy path (preprocess at crop 224 -> ResNet-18 -> head)
    through both wrappers with the shipped weights."""
    port = _port_wrapper(tcp.CosPlace, dtype)
    assert port.enabled and port.checkpoint.endswith("cosplace_synth.npz")
    assert port.crop_size == 224 and port.fc_output_dim == 64
    ref = _reference_wrapper(jcp.CosPlace, jcp.GeoLocalizationNet, dtype)
    assert_descriptors_close(port.compute_embeddings_batch(views),
                             ref.compute_embeddings_batch(views), dtype)
    assert_descriptors_close(port.compute_embedding(views[1]),
                             ref.compute_embedding(views[1]), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_netvlad_wrapper_with_pca_matches_reference(views, dtype):
    """preprocess at the shipped weights' crop (128) -> VGG16 -> VLAD ->
    PCA to 128-d -> L2, both wrappers; the port projects on its device
    in f32, the reference on the host in numpy f32."""
    port = _port_wrapper(tnv.NetVLAD, dtype)
    assert port.enabled and port.crop_size == 128
    assert tuple(port.pca_components.shape) == (128, 64 * 512)
    ref = _reference_wrapper(jnv.NetVLAD, jnv.NetVLADNet, dtype)
    out = port.compute_embeddings_batch(views)
    assert out.shape == (4, 128)
    assert_descriptors_close(out, ref.compute_embeddings_batch(views), dtype)
    assert_descriptors_close(port.compute_embedding(views[2]),
                             ref.compute_embedding(views[2]), dtype)


def test_pca_projection_matches_reference_within_1e5(views):
    """The projection alone, on the same VLAD vectors: the port's torch
    f32 product against the reference's numpy f32 product."""
    port = _port_wrapper(tnv.NetVLAD, "f32")
    vlad = tcp.embed(port.model, tcp.preprocess(views, 128), CPU)
    mean = port.pca_mean.numpy()
    comps = port.pca_components.numpy()
    ref = (vlad - mean) @ comps.T
    ref = ref / np.maximum(np.linalg.norm(ref, axis=-1, keepdims=True),
                           1e-12)
    out = tcp.l2_normalize((torch.from_numpy(vlad) - port.pca_mean)
                           @ port.pca_components.T, dim=-1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["cosplace", "netvlad"])
def test_disabled_wrappers_are_identical(views, which):
    """No checkpoint: the reference's testing mode, the same
    default_rng(rng_seed) unit vectors in the same order."""
    params = {"frontend.nn_checkpoint": "disable",
              "frontend.global_descriptor_dim": 48}
    if which == "cosplace":
        port = tcp.CosPlace(params, rng_seed=7, device="cpu")
        ref = jcp.CosPlace(params, rng_seed=7)
    else:
        port = tnv.NetVLAD(params, rng_seed=7, device="cpu")
        ref = jnv.NetVLAD(params, rng_seed=7)
    assert not port.enabled and not ref.enabled
    for _ in range(2):
        np.testing.assert_array_equal(port.compute_embedding(views[0]),
                                      ref.compute_embedding(views[0]))
        np.testing.assert_array_equal(port.compute_embeddings_batch(views),
                                      ref.compute_embeddings_batch(views))


def test_random_init_follows_flax_distributions():
    """The disabled wrapper's network: lecun-normal kernels (std
    1/sqrt(fan_in), truncated at 2 sigma), zero biases, unit BatchNorm,
    GeM p = 3, centroids in [0, 1); the same seed gives the same
    weights."""
    a = tcp.flax_init_(tcp.GeoLocalizationNet(64), 3)
    b = tcp.flax_init_(tcp.GeoLocalizationNet(64), 3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.backbone.layer3[0].conv2.weight
    fan_in = w[0].numel()
    w = w.detach()
    assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.03)
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert float(a.aggregation[1].p.detach()) == 3.0
    assert float(a.aggregation[3].bias.detach().abs().max()) == 0.0
    nv = tcp.flax_init_(tnv.NetVLADNet(), 0)
    c = nv.pool.centroids.detach()
    assert 0.0 <= float(c.min()) and float(c.max()) < 1.0


def test_eval_recall_matches_reference(cosplace_flat):
    """Held-out recall@1 at f32 on one small world: the same renders,
    the same descriptors, and the port's top-1 (the DescriptorDatabase
    search, the kernel's plain version here) the reference's argmax."""
    model = tcp.load_flat_weights(
        tcp.GeoLocalizationNet(64, dtype=torch.float32),
        tconvert.cosplace_state_dict(cosplace_flat)).eval()
    kw = dict(seed=4242, n_places=6, crop_size=96, n_worlds=1)
    port = ttc.eval_recall(model, device="cpu", **kw)
    ref = jtc.eval_recall(jcp.GeoLocalizationNet(64, dtype=jnp.float32),
                          _variables(cosplace_flat), **kw)
    assert port == ref
    assert port > 0.5


def test_top1_recall_excludes_self():
    emb = np.eye(4, dtype=np.float32)[[0, 0, 1, 1, 2, 3]]
    emb[1, 1] = 0.1
    emb[5, 2] = 0.5
    labels = np.array([0, 0, 1, 1, 2, 2])
    # 0<->1 and 2<->3 are each other's best; 4's best is 5, 5's best is 4
    assert ttc.top1_recall(emb, labels, "cpu") == 1.0
    assert ttc.top1_recall(emb, np.array([0, 1, 1, 1, 2, 2]), "cpu") == \
        pytest.approx(4 / 6)


# ----------------------------------------------------------------------
# Devices and precision
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["matmul", "cudnn"])
def test_require_full_fp32_refuses_tf32(monkeypatch, flag):
    """Either TF32 flag on: the check refuses (for the card, or with no
    device named); a CPU device has no TF32 mode and passes."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    tdevice.require_full_fp32()
    tdevice.require_full_fp32("cuda")
    target = torch.backends.cuda.matmul if flag == "matmul" \
        else torch.backends.cudnn
    monkeypatch.setattr(target, "allow_tf32", True)
    for device in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tdevice.require_full_fp32(device)
    tdevice.require_full_fp32("cpu")


@pytest.mark.parametrize("which", ["cosplace", "netvlad"])
def test_models_refuse_without_a_card(monkeypatch, which):
    """No card and no device="cpu": the wrappers raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = tcp.CosPlace if which == "cosplace" else tnv.NetVLAD
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls({"frontend.nn_checkpoint": "disable"})
    assert cls({"frontend.nn_checkpoint": "disable"},
               device="cpu").device == CPU


def test_weights_are_read_from_the_reference_package():
    """The port ships no weights: zoo resolves the JAX package's files by
    path, and a missing file resolves to "" (disabled)."""
    path = tzoo.shipped_checkpoint("cosplace_synth.npz")
    assert path.endswith("cslam_tpu/models/weights/cosplace_synth.npz")
    assert path == jcp.__file__.replace("cosplace.py",
                                        "weights/cosplace_synth.npz")
    assert tzoo.shipped_checkpoint("missing.npz") == ""
    assert tzoo.SHIPPED_LIGHTGLUE_LAYERS == 3
