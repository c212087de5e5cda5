"""The port's UNet++ segmentation inference against the JAX package's:
``segment_images`` from a JAX-written UNet++ checkpoint (the training
payload {params, batch_stats, opt_state, epoch}), the same images in and
the same three PNGs out per image. Masks may differ only where the
probability resized back to the frame lies within 1e-4 of 0.5 (85 of
189,600 pixels here, of which 0 differ); the overlay decodes to OpenCV's
pixels, channel order included."""

import flax.serialization as fs
import cv2
import numpy as np
import optax
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.preprocessing import (
    segmentation_infer as J)
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    NestedUNet, seed_weights, unet_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
    segmentation_infer as T)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import cvcompat
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)

FILTERS = [4, 8, 16, 32, 64]
SIZE = 32
BAND = 1e-4


@pytest.fixture()
def setup(tmp_path):
    """Three prints (two 320x240 JPEGs, one 200x180 PNG), a config and a
    JAX-format checkpoint of a small UNet++ whose output layer is scaled
    so that the first print's logits have mean 0 and std 2 (both classes
    occur, few pixels sit near 0.5)."""
    src = tmp_path / "in"
    src.mkdir()
    imgs = [np.round(p * 255.0).astype(np.uint8) for p in blob_prints([3, 4], None, 320, 240)]
    cv2.imwrite(str(src / "1_1_1.jpg"), imgs[0])
    cv2.imwrite(str(src / "2_1_1.jpg"), imgs[1])
    small = np.round(blob_prints([5], None, 200, 180)[0] * 255.0).astype(np.uint8)
    cv2.imwrite(str(src / "3_1_1.png"), small)
    (src / "notes.txt").write_text("skipped")

    model = seed_weights(NestedUNet(FILTERS), 6).eval()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
        gray = cv2.imread(str(src / "1_1_1.jpg"), cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
        x = cvcompat.resize(gray, (SIZE, SIZE), cvcompat.INTER_AREA)
        logits = model(torch.from_numpy(np.stack([x] * 3)[None]))
        model.Conv_0.weight *= 2.0 / logits.std()
        model.Conv_0.bias.copy_((model.Conv_0.bias - logits.mean()) * 2.0 / logits.std())
    v = unet_variables_from_state(model.state_dict())
    payload = {"params": v["params"], "batch_stats": v["batch_stats"],
               "opt_state": optax.adamw(1e-3).init(v["params"]), "epoch": 4}
    ckpt = tmp_path / "best.msgpack"
    ckpt.write_bytes(fs.to_bytes(payload))
    cfg = tmp_path / "seg.yml"
    # a flow list, as configs/config_segmentation.yml writes it
    cfg.write_text(f"dataset:\n  image_size: {SIZE}\n"
                   f"model:\n  filters: {FILTERS}\n")
    return tmp_path, src, ckpt, cfg


def jax_probability(path, cfg, ckpt):
    """The JAX package's probability map resized back to the frame."""
    import jax
    from multimodal_biometric_fingerprints_palms_tpu.config import (
        load_segmentation_config)
    model, variables, size = J.load_model(load_segmentation_config(cfg), ckpt)
    gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
    h, w = gray.shape
    x = cv2.resize(gray, (size, size), interpolation=cv2.INTER_AREA)
    prob = np.asarray(jax.nn.sigmoid(model.apply(
        variables, np.stack([x] * 3, axis=-1)[None], train=False)))[0, ..., 0]
    return cv2.resize(prob, (w, h))


def test_segment_images_matches_jax(setup):
    tmp_path, src, ckpt, cfg = setup
    n_j = J.segment_images(src, tmp_path / "jax", ckpt, str(cfg))
    n_t = T.segment_images(src, tmp_path / "port", ckpt, str(cfg), device="cpu")
    assert n_j == n_t == 3
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    band_px = total_px = differ_px = 0
    for img in sorted(p for p in src.iterdir() if p.suffix != ".txt"):
        prob = jax_probability(img, cfg, ckpt)
        band = np.abs(prob - 0.5) < BAND
        band_px += int(band.sum())
        total_px += band.size
        for kind in ("mask", "segmented", "overlay"):
            a = cv2.imread(str(tmp_path / "jax" / f"{img.stem}_{kind}.png"),
                           cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "port" / f"{img.stem}_{kind}.png"),
                           cv2.IMREAD_UNCHANGED)
            assert a.shape == b.shape and a.dtype == b.dtype, kind
            differ = (a != b) if a.ndim == 2 else (a != b).any(axis=-1)
            assert not (differ & ~band).any(), (img.name, kind, int(differ.sum()))
            differ_px += int(differ.sum()) if kind == "mask" else 0
        mask = cv2.imread(str(tmp_path / "port" / f"{img.stem}_mask.png"),
                          cv2.IMREAD_UNCHANGED)
        assert 0 < int((mask > 0).sum()) < mask.size     # both classes
    # measured: 85 of 189,600 pixels in the band, masks differing in 0
    assert band_px <= 1e-3 * total_px, (band_px, differ_px)
    print(f"band {band_px} of {total_px} px; masks differ in {differ_px}")


def test_overlay_channel_order(setup):
    """The mask brightens the last channel of the JAX package's array,
    which ``cv2.imwrite`` stores as red: reading back in OpenCV's B, G, R
    order, index 2 carries the mask and 0 and 1 the grey image."""
    tmp_path, src, ckpt, cfg = setup
    T.segment_images(src, tmp_path / "port", ckpt, str(cfg), device="cpu")
    over = cv2.imread(str(tmp_path / "port" / "1_1_1_overlay.png"))
    mask = cv2.imread(str(tmp_path / "port" / "1_1_1_mask.png"),
                      cv2.IMREAD_GRAYSCALE) > 0
    gray = cv2.imread(str(src / "1_1_1.jpg"), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(over[..., 2][~mask], over[..., 1][~mask])
    assert (over[..., 2][mask] >= over[..., 1][mask]).all()
    assert (over[..., 2][mask] > over[..., 1][mask]).any()
    np.testing.assert_array_equal(over[..., 0], over[..., 1])
    assert np.abs(over[..., 1].astype(int) - gray).max() <= 1


def test_load_model_reads_the_training_payload(setup):
    """The seg payload's opt_state and epoch are read and left aside; the
    model's weights are the checkpoint's."""
    tmp_path, src, ckpt, cfg = setup
    from multimodal_biometric_fingerprints_palms_tpu_torch.config import (
        load_segmentation_config)
    model, size = T.load_model(load_segmentation_config(cfg), ckpt, device="cpu")
    assert size == SIZE and not model.training
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        load_msgpack)
    payload = load_msgpack(ckpt)
    assert payload["epoch"] == 4 and "0" in payload["opt_state"]
    np.testing.assert_array_equal(
        model.Conv_0.bias.detach().numpy(),
        payload["params"]["Conv_0"]["bias"])
