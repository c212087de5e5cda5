"""The port's UNet++ segmentation training against the JAX package's:

- the OpenCV calls its host data makes (``utils/cvcompat.py`` and the
  codec's colour read), bit-equal to OpenCV: INTER_NEAREST and
  3-channel INTER_AREA resizes, the nearest warp with its constant-0
  border, ``IMREAD_COLOR`` + ``COLOR_BGR2RGB``;
- ``_load_pair`` and ``_augment`` bit-equal to the JAX functions for the
  same ``np.random.Generator``;
- one train step (UNet++ with filters 4..20 at 32x32, batch 2, the
  config's loss, clip and injected AdamW): loss within 1e-5 relative,
  parameters within ``2 lr + 1e-6`` (Adam's first move is about +-lr on
  every element whose gradient is not near 0, so an element whose
  gradient is near 0 can move the other way when the two packages sum it
  in another order); the optimizer's moments, which are the gradients
  themselves after one step, within 1e-3 of each leaf's largest element
  (measured 2.2e-4: a gradient summed over 2 x 32 x 32 positions through
  BatchNorm over two images, in each package's order); running
  statistics within 1e-5;
- checkpoints both ways: ``train_from_config`` of each package resumes
  from the other's ``last.msgpack`` (``{params, batch_stats, opt_state,
  epoch}`` in flax's layout) at the saved epoch + 1, with the lr,
  ``count``, ``mu`` and ``nu`` it saved.
"""

import flax.serialization as fs
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.models import (
    NestedUNet as JUNet)
from multimodal_biometric_fingerprints_palms_tpu.models import losses as JL
from multimodal_biometric_fingerprints_palms_tpu.train import seg_train as JS
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    NestedUNet, seed_weights, unet_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
    seg_train as TS)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
    cvcompat, image_codec)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
    load_msgpack, save_msgpack)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)

FILTERS = [4, 8, 12, 16, 20]
SIZE = 32
LR = 1.5e-4                   # configs/config_segmentation.yml optimizer.lr
ACFG = dict(hflip_prob=0.5, vflip_prob=0.2, rotate_prob=0.5, rotate_limit=15,
            brightness_contrast_prob=0.3)


def _u8(h, w, seed):
    return np.round(blob_prints([seed], None, h, w)[0] * 255.0).astype(np.uint8)


# --- the OpenCV calls -------------------------------------------------------

@pytest.mark.parametrize("src", [(320, 240), (300, 200), (37, 29), (480, 640)])
@pytest.mark.parametrize("dst", [(256, 256), (32, 32), (17, 300)])
def test_nearest_resize_bit_equal(src, dst):
    img = np.random.default_rng(src[0]).integers(0, 256, src, dtype=np.uint8)
    np.testing.assert_array_equal(
        cvcompat.resize(img, dst, cvcompat.INTER_NEAREST),
        cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("src", [(320, 240), (512, 512), (300, 200), (200, 180)])
def test_colour_area_resize_bit_equal(src):
    img = np.random.default_rng(1).integers(0, 256, src + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(
        cvcompat.resize(img, (256, 256), cvcompat.INTER_AREA),
        cv2.resize(img, (256, 256), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("shape", [(256, 256), (64, 48), (37, 29), (50, 61)])
def test_nearest_warp_bit_equal(shape):
    """uint8 and float32 masks, constant-0 border; widths inside and off
    OpenCV's 16-pixel vector steps."""
    h, w = shape
    g = np.random.default_rng(h)
    for img in (g.integers(0, 256, shape, dtype=np.uint8),
                (g.random(shape) < 0.5).astype(np.float32)):
        for angle in np.linspace(-15, 15, 7):
            m = cv2.getRotationMatrix2D((w // 2, h // 2), float(angle), 1.0)
            np.testing.assert_array_equal(
                cvcompat.warp_affine_nearest(img, m, (w, h)),
                cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST))


def test_colour_read_equals_opencv(tmp_path):
    """Grey JPEG (OpenCV's and the port's encoder), grey, RGB and RGBA
    PNG, grey and colour BMP: RGB bytes equal; a colour JPEG is refused
    by name."""
    g = np.random.default_rng(0)
    grey = g.integers(0, 256, (37, 29), dtype=np.uint8)
    col = g.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    for name, img in (("g.jpg", grey), ("g.png", grey), ("c.png", col),
                      ("a.png", np.concatenate([col, col[..., :1]], 2)),
                      ("g.bmp", grey), ("c.bmp", col)):
        cv2.imwrite(str(tmp_path / name), img)
    (tmp_path / "port.jpg").write_bytes(image_codec.encode_jpeg(grey))
    for p in sorted(tmp_path.iterdir()):
        want = cv2.cvtColor(cv2.imread(str(p), cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(image_codec.read_rgb(p), want)
    cv2.imwrite(str(tmp_path / "colour.jpg"), col)
    with pytest.raises(image_codec.ImageFormatError, match="colour JPEG"):
        image_codec.read_rgb(tmp_path / "colour.jpg")


# --- host data ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Ten image/mask pairs: 320x240 grey JPEGs and masks under
    ``<masks>/debug/cluster_0/mask/<name>`` (the preprocessing runner's
    debug layout), one image a PNG."""
    root = tmp_path_factory.mktemp("seg")
    imgs, masks = root / "images", root / "masks" / "cluster_0" / "mask"
    imgs.mkdir()
    masks.mkdir(parents=True)
    for k in range(10):
        img = _u8(320, 240, 40 + k)
        ext = ".png" if k == 3 else ".jpg"
        cv2.imwrite(str(imgs / f"{k + 1}_1_1{ext}"), img)
        mask = (cv2.GaussianBlur(img, (0, 0), 6) > 110).astype(np.uint8) * 255
        cv2.imwrite(str(masks / f"{k + 1}_1_1.jpg"), mask)
    return root


def test_collect_pairs_and_load_pair_bit_equal(pairs):
    want = JS.collect_image_mask_paths(pairs / "images", pairs / "masks")
    got = TS.collect_image_mask_paths(pairs / "images", pairs / "masks")
    assert got == want and len(got) == 10
    for img, mask in got:
        a, b = TS._load_pair(img, mask, 256)
        c, d = JS._load_pair(img, mask, 256)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert a.shape == (256, 256, 3) and b.shape == (256, 256, 1)


def test_augment_bit_equal(pairs):
    """40 generator seeds over two pairs: flips, rotations (image bilinear
    with reflect-101, mask nearest with 0 border), brightness/contrast."""
    loaded = [JS._load_pair(*p, SIZE) for p in JS.collect_image_mask_paths(
        pairs / "images", pairs / "masks")[:2]]
    for s in range(40):
        img, mask = loaded[s % 2]
        a, b = TS._augment(img, mask, np.random.default_rng(s), ACFG)
        c, d = JS._augment(img, mask, np.random.default_rng(s), ACFG)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# --- the train step ---------------------------------------------------------

def _start_model(seed=6):
    model = seed_weights(NestedUNet(FILTERS), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape,
                                                         generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape,
                                                       generator=g))
    return model


def _tx_pair():
    jtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.inject_hyperparams(optax.adamw)(
                          learning_rate=LR, weight_decay=5e-4))
    from multimodal_biometric_fingerprints_palms_tpu_torch.train.optim import (
        ClipAdamW)
    return jtx, ClipAdamW(1.0, LR, 5e-4, inject=True)


def test_one_train_step_matches_jax(pairs):
    """The JAX trainer's step (its ``loss_fn`` and ``train_step``, composed
    here from the JAX package's model, losses and optax chain) and the
    port's on the same batch of two augmented pairs."""
    model = _start_model()
    v = unet_variables_from_state(model.state_dict())
    jtx, ttx = _tx_pair()
    jm = JUNet(filters=tuple(FILTERS))
    ft = (0.7, 0.3, 0.75)

    def loss_fn(params, batch_stats, x, y):
        out, upd = jm.apply({"params": params, "batch_stats": batch_stats}, x,
                            train=True, mutable=["batch_stats"])
        return (0.7 * JL.bce_with_logits(out, y)
                + JL.focal_tversky_loss(out, y, *ft)), upd["batch_stats"]

    @jax.jit
    def step(params, batch_stats, opt, x, y):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch_stats, x, y)
        u, opt = jtx.update(grads, opt, params)
        return optax.apply_updates(params, u), bs, opt, loss

    rng = np.random.default_rng(0)
    batch = [JS._augment(*JS._load_pair(*p, SIZE), rng, ACFG) for p in
             JS.collect_image_mask_paths(pairs / "images", pairs / "masks")[:2]]
    x = np.stack([b[0] for b in batch])
    y = np.stack([b[1] for b in batch])
    params = jax.tree.map(jnp.asarray, v["params"])
    jp, jbs, jopt, jloss = step(params, jax.tree.map(jnp.asarray,
                                                     v["batch_stats"]),
                                jtx.init(params), x, y)
    tparams = list(model.parameters())
    opt = ttx.init(tparams)
    model.train()
    loss = TS.seg_loss(model, torch.from_numpy(x), torch.from_numpy(y), 0.7, ft)
    grads = torch.autograd.grad(loss, tparams)
    ttx.step(tparams, list(grads), opt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    after = unet_variables_from_state(model.state_dict())
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(after["params"])):
        assert np.abs(np.asarray(a) - b).max() <= 2 * LR + 1e-6
    for a, b in zip(jax.tree.leaves(jbs), jax.tree.leaves(after["batch_stats"])):
        assert np.abs(np.asarray(a) - b).max() <= 1e-5
    tree = ttx.to_flax(opt, lambda ts: TS.params_tree_of(model, ts))
    j_adam = fs.to_state_dict(jopt)["1"]["inner_state"]["0"]
    assert int(j_adam["count"]) == tree["1"]["inner_state"]["0"]["count"] == 1
    worst = 0.0
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(j_adam[name]),
                        jax.tree.leaves(tree["1"]["inner_state"]["0"][name])):
            a = np.asarray(a)
            worst = max(worst, float(np.abs(a - b).max()
                                     / max(np.abs(a).max(), 1e-30)))
    assert worst <= 1e-3


# --- checkpoints both ways through train_from_config -------------------------

def _config(root, pairs, ckpt_dir, epochs, resume):
    text = f"""experiment:
  seed: 42
dataset:
  images_dir: {pairs / 'images'}
  masks_dir: {pairs / 'masks'}
  image_size: {SIZE}
  batch_size: 2
  val_split: 0.2
model:
  filters: [{', '.join(map(str, FILTERS))}]
training:
  epochs: {epochs}
  grad_clip: 1.0
  checkpoint_dir: {ckpt_dir}
  early_stop_patience: 5
optimizer:
  lr: {LR}
  weight_decay: 5.0e-4
scheduler:
  type: plateau
  factor: 0.5
  patience: 1
loss:
  bce_weight: 0.7
  focal_tversky:
    alpha: 0.7
    beta: 0.3
    gamma: 0.75
logging:
  tensorboard: false
  curves_csv: {ckpt_dir / 'curve.csv'}
misc:
  resume_from_checkpoint: {resume}
"""
    path = root / f"seg_{ckpt_dir.name}_{epochs}.yml"
    path.write_text(text)
    return str(path)


def _adam_of(tree):
    return tree["opt_state"]["1"]


def test_checkpoints_cross_both_ways(pairs, tmp_path, monkeypatch):
    """Both trainers start from one port-written checkpoint (epoch -1, a
    fresh optimizer state), train 1 epoch each, then each resumes from
    the OTHER's ``last.msgpack`` for epoch 1: the history starts at epoch
    1, and the state it resumed holds the lr, ``count``, ``mu`` and ``nu``
    the other saved. The 1-epoch losses agree within 1e-4 relative."""
    monkeypatch.chdir(tmp_path)
    model = _start_model()
    _, ttx = _tx_pair()
    start = tmp_path / "start.msgpack"
    save_msgpack(start, TS.checkpoint_payload(
        model, ttx, ttx.init(list(model.parameters())), -1))
    jd, td = tmp_path / "jax", tmp_path / "port"
    jres = JS.train_from_config(_config(tmp_path, pairs, jd, 1, start))
    tres = TS.train_from_config(_config(tmp_path, pairs, td, 1, start),
                                device="cpu")
    assert [h["epoch"] for h in jres["history"]] == [0]
    assert [h["epoch"] for h in tres["history"]] == [0]
    np.testing.assert_allclose(tres["history"][0]["loss"],
                               jres["history"][0]["loss"], rtol=1e-4)
    jl, tl = load_msgpack(jd / "last.msgpack"), load_msgpack(td / "last.msgpack")
    assert jl["epoch"] == tl["epoch"] == 0
    assert int(_adam_of(jl)["count"]) == int(_adam_of(tl)["count"]) == 4

    # the port resumes the JAX file; the JAX trainer resumes the port's
    t2 = TS.train_from_config(_config(tmp_path, pairs, tmp_path / "p2", 2,
                                      jd / "last.msgpack"), device="cpu")
    j2 = JS.train_from_config(_config(tmp_path, pairs, tmp_path / "j2", 2,
                                      td / "last.msgpack"))
    assert [h["epoch"] for h in t2["history"]] == [1]
    assert [h["epoch"] for h in j2["history"]] == [1]
    for got, resumed in ((load_msgpack(tmp_path / "p2" / "last.msgpack"), jl),
                         (load_msgpack(tmp_path / "j2" / "last.msgpack"), tl)):
        assert got["epoch"] == 1
        assert int(_adam_of(got)["count"]) == int(_adam_of(resumed)["count"]) + 4
        assert int(_adam_of(got)["inner_state"]["0"]["count"]) == 8

    # what the port resumes equals what was saved, moments included
    m = NestedUNet(FILTERS)
    tx = TS.make_tx(TS.load_segmentation_config(
        _config(tmp_path, pairs, tmp_path / "x", 2, "null")), 8, 2)
    opt, epoch = TS.resume_state(m, tx, jd / "last.msgpack", "cpu")
    assert epoch == 1 and opt.count == 4 and opt.inject_count == 4
    saved = _adam_of(jl)
    assert opt.hyperparams["learning_rate"] == np.float32(
        saved["hyperparams"]["learning_rate"])
    tree = tx.to_flax(opt, lambda ts: TS.params_tree_of(m, ts))
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(saved["inner_state"]["0"][name]),
                        jax.tree.leaves(tree["1"]["inner_state"]["0"][name])):
            np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_in_flax_template(pairs, tmp_path):
    """``serialization.from_bytes`` with the JAX trainer's own template
    (``model.init`` shapes and ``tx.init``) reads the port's file."""
    model = _start_model()
    jtx, ttx = _tx_pair()
    opt = ttx.init(list(model.parameters()))
    ttx.step(list(model.parameters()),
             [torch.full_like(p, 1e-3) for p in model.parameters()], opt)
    path = save_msgpack(tmp_path / "last.msgpack",
                        TS.checkpoint_payload(model, ttx, opt, 3))
    shapes = jax.eval_shape(lambda: JUNet(filters=tuple(FILTERS)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    template = {"params": zeros["params"], "batch_stats": zeros["batch_stats"],
                "opt_state": jtx.init(zeros["params"]), "epoch": 0}
    got = fs.from_bytes(template, path.read_bytes())
    assert got["epoch"] == 3
    assert int(got["opt_state"][1].count) == 1
    assert float(got["opt_state"][1].hyperparams["learning_rate"]) == np.float32(LR)
    v = unet_variables_from_state(model.state_dict())
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(v["params"])):
        np.testing.assert_array_equal(a, b)
