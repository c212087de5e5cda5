"""The port's models and checkpoints against the JAX package's: the SSL
model (backbone, projection head, predictor) and UNet++ forwards with the
same weights carried across by ``models/convert.py``, the JAX tree's keys
and shapes one to one at full width, flax's "SAME" padding and bilinear x2,
and flax msgpack checkpoints written by either package and read by the
other.

Tolerances: 1e-5 at the tiny plan and the small UNet++ (float32 through
about twenty layers; measured here 2.05e-07 and 2.09e-07), 1e-4 at full
width (EfficientNetV2-S, 756/512/256: measured 1.19e-07; UNet++ with
filters 64..1024: 4.47e-07)."""

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_biometric_fingerprints_palms_tpu.models import (
    NestedUNet as JUNet, SSLModel as JSSL)
from multimodal_biometric_fingerprints_palms_tpu.models.projection_head import (
    WeightNormDense as JWeightNormDense)
from multimodal_biometric_fingerprints_palms_tpu.models.unetpp import _up2 as j_up2
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    NestedUNet, SSLModel, load_jax_variables, seed_weights, ssl_state_from_jax,
    ssl_variables_from_state, unet_state_from_jax, unet_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.models.backbone import (
    SameConv2d)
from multimodal_biometric_fingerprints_palms_tpu_torch.models.projection_head import (
    WeightNormDense)
from multimodal_biometric_fingerprints_palms_tpu_torch.models.unetpp import _up2
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import checkpoint
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.device import (
    full_float32)

torch.set_num_threads(1)

TINY = dict(backbone_name="effnetv2_tiny", embedding_dim=64,
            proj_hidden_dim=32, proj_output_dim=16)
FULL = dict(backbone_name="effnetv2_s", embedding_dim=756,
            proj_hidden_dim=512, proj_output_dim=256)
UNET_SMALL = (8, 16, 32, 64, 128)
UNET_FULL = (64, 128, 256, 512, 1024)


def _init_zeros(jm, x):
    """The JAX model's variable tree as flax's ``init`` builds it (traced,
    not compiled), with zero leaves."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            train=False))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))


def port_state_with_stats(model, seed):
    """The port's seeded weights, BatchNorm statistics drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    seed_weights(model, seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.weight.copy_(1 + 0.1 * torch.randn(mod.weight.shape, generator=g))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize("n", [7, 8, 9, 16])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_same_padding_matches_flax(n, k, stride):
    """flax pads "SAME" as (total // 2, total - total // 2): (0, 1) for a
    stride-2 3x3 on an even side, which PyTorch's padding=1 is not."""
    x = np.random.default_rng(n).random((1, n, n + 3, 2), np.float32)
    conv = fnn.Conv(3, (k, k), strides=stride)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(v, x))
    t = SameConv2d(2, 3, k, stride)
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        t.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_ssl_tiny_matches_jax():
    """EFFNETV2_TINY at 64x64, batch 2: the predictor's output and the
    backbone embedding within 1e-5 of ``apply(train=False,
    return_embedding=True)``. The weights go both ways: the port's seeded
    ones to the JAX tree, and that tree into a fresh port model."""
    x = np.random.default_rng(1).random((2, 64, 64), np.float32)
    v = ssl_variables_from_state(port_state_with_stats(SSLModel(**TINY), 4)
                                 .state_dict())
    jp, je = JSSL(**TINY).apply(v, x, train=False, return_embedding=True)
    tm = load_jax_variables(SSLModel(**TINY), v).eval()
    with torch.no_grad():
        tp, te = tm(torch.from_numpy(x), return_embedding=True)
        tq = tm(torch.from_numpy(x)[..., None])          # (B, H, W, 1) input
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_array_equal(tq.numpy(), tp.numpy())


def test_ssl_full_width_matches_jax():
    """effnetv2_s with 756/512/256 and the predictor, batch 2 at 64x64 (to
    bound JAX's time): the port's seeded weights carried to the JAX model
    (``ssl_variables_from_state``); both outputs within 1e-4."""
    x = np.random.default_rng(2).random((2, 64, 64), np.float32)
    tm = port_state_with_stats(SSLModel(**FULL), 5)
    v = ssl_variables_from_state(tm.state_dict())
    jp, je = JSSL(**FULL).apply(v, x, train=False, return_embedding=True)
    with torch.no_grad():
        tp, te = tm(torch.from_numpy(x), return_embedding=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)


@pytest.mark.parametrize("kind", ["ssl", "unet"])
def test_full_width_trees_map_one_to_one(kind):
    """Every key and shape of the JAX tree at full width maps to one entry
    of the port's ``state_dict`` and back (traced shapes, no compile)."""
    if kind == "ssl":
        jm, tm, x = JSSL(**FULL), SSLModel(**FULL), jnp.zeros((2, 64, 64))
        fwd, back = ssl_state_from_jax, ssl_variables_from_state
    else:
        jm, tm = JUNet(filters=UNET_FULL), NestedUNet(UNET_FULL)
        x, fwd, back = jnp.zeros((1, 32, 32, 3)), unet_state_from_jax, unet_variables_from_state
    zeros = _init_zeros(jm, x)
    state = fwd(dict(zeros))
    own = tm.state_dict()
    assert sorted(state) == sorted(own)
    assert all(tuple(state[k].shape) == tuple(own[k].shape) for k in own)
    n_leaves = len(jax.tree.leaves(zeros))
    n_bn = sum(k.endswith("num_batches_tracked") for k in own)
    assert len(own) == n_leaves + n_bn
    again = back(state)
    assert jax.tree.structure(again) == jax.tree.structure(dict(zeros))
    assert jax.tree.all(jax.tree.map(lambda a, b: a.shape == b.shape, again,
                                     dict(zeros)))


def test_unet_small_matches_jax():
    """UNet++ with filters (8, 16, 32, 64, 128) at 32x32: logits within
    1e-5 (NHWC in the JAX model, NCHW in the port)."""
    x = np.random.default_rng(6).random((2, 32, 32, 3), np.float32)
    v = unet_variables_from_state(port_state_with_stats(
        NestedUNet(UNET_SMALL), 8).state_dict())
    want = np.asarray(JUNet(filters=UNET_SMALL).apply(v, x, train=False))
    tm = load_jax_variables(NestedUNet(UNET_SMALL), v).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_unet_full_filters_match_jax():
    """UNet++ with the config's filters (64 .. 1024) at 32x32, batch 1:
    the port's seeded weights carried to the JAX model; within 1e-4."""
    x = np.random.default_rng(9).random((1, 32, 32, 3), np.float32)
    tm = port_state_with_stats(NestedUNet(UNET_FULL), 10)
    v = unet_variables_from_state(tm.state_dict())
    want = np.asarray(JUNet(filters=UNET_FULL).apply(v, x, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 2, 2, 1), (2, 5, 7, 3), (1, 16, 16, 4)])
def test_up2_equals_jax_image_resize(shape):
    """jax.image.resize(bilinear) at x2 renormalises its kernel at the
    edges; F.interpolate(align_corners=False) clamps the coordinate: the
    same weights (within float32 rounding)."""
    x = np.random.default_rng(11).random(shape, np.float32)
    want = np.asarray(j_up2(jnp.asarray(x)))
    got = _up2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-7)


def test_weight_norm_dense_clamps_a_zero_column():
    """A zero column of v gives a zero output column, not NaN: the
    max(||v||, 1e-12) clamp written out, as the JAX layer has it."""
    x = np.random.default_rng(12).random((3, 4), np.float32)
    v = np.random.default_rng(13).normal(size=(4, 5)).astype(np.float32)
    v[:, 2] = 0.0
    params = {"params": {"v": v, "g": np.full(5, 2.0, np.float32),
                         "bias": np.zeros(5, np.float32)}}
    want = np.asarray(JWeightNormDense(5).apply(params, x))
    t = WeightNormDense(4, 5)
    with torch.no_grad():
        t.v.copy_(torch.from_numpy(v))
        t.g.fill_(2.0)
        got = t(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and not got[:, 2].any()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_convert_fails_loudly():
    """A missing key, a left-over key, a leaf of another name or a shape
    that differs raises, naming it."""
    tm = SSLModel(**TINY)
    v = ssl_variables_from_state(tm.state_dict())
    del v["params"]["predictor"]["Dense_1"]["bias"]
    with pytest.raises(KeyError, match="missing.*predictor.Dense_1.bias"):
        load_jax_variables(SSLModel(**TINY), v)
    v = ssl_variables_from_state(tm.state_dict())
    v["params"]["predictor"]["Dense_9"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="left over.*Dense_9"):
        load_jax_variables(SSLModel(**TINY), v)
    v = ssl_variables_from_state(tm.state_dict())
    v["params"]["predictor"]["Dense_0"]["weights"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no counterpart"):
        load_jax_variables(SSLModel(**TINY), v)
    v = ssl_variables_from_state(tm.state_dict())
    v["params"]["predictor"]["Dense_1"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shapes differ"):
        load_jax_variables(SSLModel(**TINY), v)
    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(SSLModel(**TINY), {**v, "dropout": {}})


def test_checkpoint_written_by_jax_reads_in_the_port(tmp_path):
    """``to_bytes`` of the JAX SSL payload ({params, batch_stats, step}),
    read by the port: the same outputs as the JAX model."""
    x = np.random.default_rng(14).random((2, 64, 64), np.float32)
    jm = JSSL(**TINY)
    v = ssl_variables_from_state(port_state_with_stats(SSLModel(**TINY), 16)
                                 .state_dict())
    path = tmp_path / "ssl_model_final.msgpack"
    path.write_bytes(fs.to_bytes({"params": v["params"],
                                  "batch_stats": v["batch_stats"], "step": 7}))
    payload = checkpoint.load_msgpack(path)
    assert payload["step"] == 7
    tm = load_jax_variables(SSLModel(**TINY), {
        "params": payload["params"], "batch_stats": payload["batch_stats"]})
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x, train=False)),
                               atol=1e-5)


def test_checkpoint_written_by_the_port_reads_in_flax(tmp_path):
    """The port's writer, read by ``flax.serialization.from_bytes`` against
    the JAX model's template: an equal tree bit for bit (and the bytes are
    flax's own)."""
    tm = port_state_with_stats(SSLModel(**TINY), 17)
    v = ssl_variables_from_state(tm.state_dict())
    payload = {"params": v["params"], "batch_stats": v["batch_stats"], "step": 3}
    path = checkpoint.save_msgpack(tmp_path / "ck.msgpack", payload)
    template = _init_zeros(JSSL(**TINY), jnp.zeros((2, 64, 64)))
    back = fs.from_bytes({"params": template["params"],
                          "batch_stats": template["batch_stats"], "step": 0},
                         path.read_bytes())
    assert back["step"] == 3
    same = jax.tree.map(lambda a, b: a.dtype == b.dtype and np.array_equal(a, b),
                        {"params": back["params"], "batch_stats": back["batch_stats"]},
                        {"params": v["params"], "batch_stats": v["batch_stats"]})
    assert jax.tree.all(same)
    assert path.read_bytes() == fs.to_bytes(payload)


def test_checkpoint_types_and_refusals(tmp_path):
    """Every msgpack type the models' payloads hold, ndarrays (flax's ext
    type 1) and a bfloat16 array (widened to float32); flax's other ext
    types, an unknown ext code, a chunked array and a truncated file raise
    on reading, and the writer refuses numpy scalars and complex numbers; a
    file round-trips."""
    g = np.random.default_rng(18)
    tree = {"a": g.random((3, 4), dtype=np.float32), "i": np.arange(5),
            "b": np.array([True, False]), "s": "x" * 40, "n": None,
            "t": True, "f": 1.5, "neg": -70000, "big": 2 ** 40,
            "tup": (1, 2), "empty": np.zeros((0, 3), np.float16)}
    data = fs.to_bytes(tree)
    assert checkpoint.to_bytes(tree) == data
    back = checkpoint.msgpack_restore(data)
    for k in ("a", "i", "b", "empty"):
        assert back[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(back[k], tree[k])
    assert back["tup"] == {"0": 1, "1": 2}
    assert (back["s"], back["n"], back["t"], back["neg"], back["big"]) == (
        tree["s"], None, True, -70000, 2 ** 40)
    bf = checkpoint.msgpack_restore(fs.to_bytes(
        {"w": jnp.asarray([1.5, -2.25], jnp.bfloat16)}))["w"]
    assert bf.dtype == np.float32 and bf.tolist() == [1.5, -2.25]
    for value, code in ((complex(1, -2), 2), (np.float32(2.5), 3)):
        with pytest.raises(checkpoint.CheckpointFormatError,
                           match=f"ext type {code}"):
            checkpoint.msgpack_restore(fs.to_bytes({"v": value}))
        with pytest.raises(TypeError):
            checkpoint.to_bytes({"v": value})
    chunked = fs._chunk(np.arange(10, dtype=np.float32))
    with pytest.raises(checkpoint.CheckpointFormatError, match="chunked"):
        checkpoint.msgpack_restore(fs.msgpack_serialize({"w": chunked}))
    with pytest.raises(checkpoint.CheckpointFormatError, match="ext type 7"):
        checkpoint.msgpack_restore(b"\xd4\x07\x00")
    with pytest.raises(checkpoint.CheckpointFormatError, match="ends inside"):
        checkpoint.msgpack_restore(data[:-3])
    path = checkpoint.save_msgpack(tmp_path / "t.msgpack", {"w": np.arange(3.0)})
    np.testing.assert_array_equal(checkpoint.load_msgpack(path)["w"], np.arange(3.0))
    assert not path.with_suffix(".msgpack.tmp").exists()


def test_full_float32_turns_tf32_off_inside_only():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with full_float32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
