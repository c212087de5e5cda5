"""UNet++ segmentation training of the port (the JAX package's
``train/seg_train.py``), on the card unless given ``device="cpu"``.

The same run: image/mask pairs matched by stem (masks self-produced by
the classical pipeline under ``<masks_dir>/**/mask/<name>``), the seeded
split, AdamW after a global-norm clip with the lr injected as a
hyperparameter (``train/optim.py``, ``inject=True``) and scaled by
``scheduler.factor`` on a plateau, or a one-cycle schedule; loss
``bce_weight * BCE + FocalTversky``; val dice and IoU; the curves CSV;
``best.msgpack`` and ``last.msgpack`` with ``{params, batch_stats,
opt_state, epoch}`` in flax's layout (either package resumes from the
other's); early stopping; resume from ``misc.resume_from_checkpoint`` at
the saved epoch + 1. TensorBoard stays optional and off, as in the JAX
package.

Host data: ``_load_pair`` and ``_augment`` over ``utils/cvcompat.py`` and
the port's codec (a colour read turned to RGB, INTER_AREA, INTER_NEAREST,
the 3-channel INTER_LINEAR REFLECT_101 warp and the nearest warp of the
mask), equal to the JAX package's cv2 calls. The network runs NCHW in
float32 with TF32 off. Initial weights come from ``models.seed_weights``
(flax's own draws cannot be reproduced), and UNet++ has no dropout, so the
JAX step's dropout key moves nothing and is not drawn.

The result adds ``seconds`` (host batches, train steps, evaluation) and
``steps`` to the JAX function's keys.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_segmentation_config
from ..models.convert import (load_jax_variables, params_list_of,
                              params_tree_of, unet_variables_from_state)
from ..models.losses import (bce_with_logits, dice_coeff,
                             focal_tversky_loss, iou_score)
from ..models.seeding import seed_weights
from ..models.unetpp import NestedUNet
from ..utils import cvcompat
from ..utils.checkpoint import load_msgpack, save_msgpack
from ..utils.device import full_float32, resolve_device
from ..utils.image_codec import read_rgb
from ..utils.io import read_image_grayscale
from ..utils.logging import console_step, get_file_logger
from .optim import ClipAdamW
from .schedule import cosine_onecycle_schedule


def _logger():
    return get_file_logger(__name__, "data/metadata/seg_train.log")


def collect_image_mask_paths(images_dir: str | Path, masks_dir: str | Path
                             ) -> list[tuple[Path, Path]]:
    """Pair images with classical-pipeline masks by stem. Masks live under
    <masks_dir>/**/mask/<name>."""
    images_dir, masks_dir = Path(images_dir), Path(masks_dir)
    masks = {}
    for m in masks_dir.rglob("*"):
        if m.is_file() and m.parent.name == "mask":
            masks[m.stem] = m
    pairs = []
    for img in sorted(images_dir.rglob("*")):
        if img.suffix.lower() in {".jpg", ".jpeg", ".png", ".bmp"}:
            m = masks.get(img.stem)
            if m is not None:
                pairs.append((img, m))
    return pairs


def _load_pair(img_path: Path, mask_path: Path, size: int
               ) -> tuple[np.ndarray, np.ndarray]:
    img = read_rgb(img_path)
    img = cvcompat.resize(img, (size, size), cvcompat.INTER_AREA)
    mask = read_image_grayscale(mask_path)
    mask = cvcompat.resize(mask, (size, size), cvcompat.INTER_NEAREST)
    return (img.astype(np.float32) / 255.0,
            (mask > 127).astype(np.float32)[..., None])


def _augment(img, mask, rng, acfg):
    if rng.random() < acfg.get("hflip_prob", 0.5):
        img, mask = img[:, ::-1], mask[:, ::-1]
    if rng.random() < acfg.get("vflip_prob", 0.2):
        img, mask = img[::-1], mask[::-1]
    if rng.random() < acfg.get("rotate_prob", 0.5):
        angle = rng.uniform(-acfg.get("rotate_limit", 15),
                            acfg.get("rotate_limit", 15))
        h, w = img.shape[:2]
        m = cvcompat.rotation_matrix_2d((w // 2, h // 2), angle, 1.0)
        img = cvcompat.warp_affine_linear(np.ascontiguousarray(img), m, (w, h))
        mask = cvcompat.warp_affine_nearest(
            np.ascontiguousarray(mask[..., 0]), m, (w, h))[..., None]
    if rng.random() < acfg.get("brightness_contrast_prob", 0.3):
        img = np.clip(img * rng.uniform(0.8, 1.2) + rng.uniform(-0.1, 0.1), 0, 1)
    return np.ascontiguousarray(img), np.ascontiguousarray(mask)


def _write_curves(path: Path, history: list[dict]) -> None:
    """Training-curve CSV (epoch, loss, val_dice, val_iou) rewritten each
    epoch."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["epoch", "loss", "val_dice",
                                          "val_iou"])
        w.writeheader()
        w.writerows(history)


def make_tx(cfg, n_train: int, batch: int) -> ClipAdamW:
    """The JAX trainer's optimizer for this config and training-set size."""
    lr = cfg.get("optimizer.lr", 1.5e-4)
    epochs = cfg.get("training.epochs", 10)
    if str(cfg.get("scheduler.type", "plateau")).lower() == "onecycle":
        steps_per_epoch = max(1, n_train // batch)
        pct_start = cfg.get("scheduler.pct_start", 0.3)
        # warmup must span >= 1 step (optax divides by the interval)
        total_steps = max(epochs * steps_per_epoch,
                          int(np.ceil(1.0 / pct_start)) + 1)
        lr = cosine_onecycle_schedule(
            total_steps, lr, pct_start,
            cfg.get("scheduler.div_factor", 25.0),
            cfg.get("scheduler.final_div_factor", 1e4))
    return ClipAdamW(cfg.get("training.grad_clip", 1.0), lr,
                     cfg.get("optimizer.weight_decay", 5e-4), inject=True)


def seg_loss(model: NestedUNet, x: torch.Tensor, y: torch.Tensor,
             bce_w: float, ft_args: tuple) -> torch.Tensor:
    """The train-mode loss on NHWC batches (the JAX layout)."""
    out = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return bce_w * bce_with_logits(out, y) + focal_tversky_loss(out, y,
                                                                *ft_args)


def checkpoint_payload(model: NestedUNet, tx: ClipAdamW, opt_state,
                       epoch: int) -> dict:
    v = unet_variables_from_state(model.state_dict())
    return {"params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": tx.to_flax(opt_state,
                                    lambda ts: params_tree_of(model, ts)),
            "epoch": int(epoch)}


def resume_state(model: NestedUNet, tx: ClipAdamW, path: Path, device):
    """Load ``path``'s weights into ``model`` and return (opt_state,
    start epoch)."""
    payload = load_msgpack(path)
    load_jax_variables(model, {"params": payload["params"],
                               "batch_stats": payload["batch_stats"]})
    model.to(device)
    opt_state = tx.from_flax(payload["opt_state"],
                             lambda tree: params_list_of(model, tree), device)
    return opt_state, int(payload["epoch"]) + 1


def train_from_config(config_path: str | None = None,
                      pairs: list | None = None,
                      device=None) -> dict:
    """Train UNet++ per the segmentation YAML on ``device`` (default: the
    card)."""
    device = resolve_device(device, "train_from_config")
    log = _logger()
    cfg = load_segmentation_config(config_path)
    seed = cfg.get("experiment.seed", 42)
    rng = np.random.default_rng(seed)

    size = cfg.get("dataset.image_size", 256)
    batch = cfg.get("dataset.batch_size", 4)
    if pairs is None:
        pairs = collect_image_mask_paths(
            cfg.get("dataset.images_dir", "dataset/DBII"),
            cfg.get("dataset.masks_dir", "dataset/processed/debug"))
    if not pairs:
        raise FileNotFoundError("no image/mask pairs found")
    console_step(f"Segmentation training: {len(pairs)} pairs")

    order = rng.permutation(len(pairs))
    n_val = max(1, int(len(pairs) * cfg.get("dataset.val_split", 0.2)))
    val_idx, train_idx = order[:n_val], order[n_val:]
    if len(train_idx) == 0:
        train_idx = val_idx

    model = NestedUNet(filters=tuple(cfg.get("model.filters",
                                             [64, 128, 256, 512, 1024])))
    seed_weights(model, seed)
    model.to(device)
    epochs = cfg.get("training.epochs", 10)
    sched_type = str(cfg.get("scheduler.type", "plateau")).lower()
    tx = make_tx(cfg, len(train_idx), batch)
    params = list(model.parameters())
    opt_state = tx.init(params)

    ckpt_dir = Path(cfg.get("training.checkpoint_dir",
                            "save_models/segmentation"))
    resume = cfg.get("misc.resume_from_checkpoint")
    start_epoch = 0
    if resume and Path(resume).exists():
        opt_state, start_epoch = resume_state(model, tx, Path(resume), device)
        log.info("resumed from %s at epoch %d", resume, start_epoch)

    bce_w = cfg.get("loss.bce_weight", 0.7)
    ft = cfg.get("loss.focal_tversky", {})
    ft_args = (ft.get("alpha", 0.7), ft.get("beta", 0.3), ft.get("gamma", 0.75))

    def train_step(x, y):
        model.train()
        with full_float32():
            loss = seg_loss(model, x, y, bce_w, ft_args)
            grads = torch.autograd.grad(loss, params)
        tx.step(params, list(grads), opt_state)
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, y):
        model.eval()
        with full_float32():
            out = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return dice_coeff(out, y), iou_score(out, y)

    seconds = {"batches": 0.0, "train_steps": 0.0, "eval": 0.0}

    def batches(idx, train_mode):
        idx = rng.permutation(idx) if train_mode else idx
        for i in range(0, len(idx) - batch + 1, batch):
            t0 = time.perf_counter()
            xs, ys = [], []
            for k in idx[i:i + batch]:
                img, mask = _load_pair(*pairs[int(k)], size)
                if train_mode:
                    img, mask = _augment(img, mask, rng,
                                         cfg.get("augmentation", {}))
                xs.append(img)
                ys.append(mask)
            out = (torch.from_numpy(np.stack(xs)).to(device),
                   torch.from_numpy(np.stack(ys)).to(device))
            seconds["batches"] += time.perf_counter() - t0
            yield out

    curves_path = Path(cfg.get("logging.curves_csv",
                               str(ckpt_dir / "training_curve.csv")))
    tb_writer = None
    if cfg.get("logging.tensorboard", False):
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb_writer = SummaryWriter(
                log_dir=cfg.get("logging.tensorboard_dir", "logs/tb_seg"))
        except ImportError:
            log.warning("tensorboard not installed; CSV curves only")

    best_dice = -1.0
    patience = 0
    plateau = 0
    history = []
    n_steps = 0
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for x, y in batches(train_idx, True):
            t1 = time.perf_counter()
            losses.append(float(train_step(x, y)))
            seconds["train_steps"] += time.perf_counter() - t1
            n_steps += 1
        dices, ious = [], []
        t1 = time.perf_counter()
        for x, y in batches(val_idx, False):
            d, i = eval_step(x, y)
            dices.append(float(d))
            ious.append(float(i))
        seconds["eval"] += time.perf_counter() - t1
        val_dice = float(np.mean(dices)) if dices else 0.0
        val_iou = float(np.mean(ious)) if ious else 0.0
        history.append({"epoch": epoch,
                        "loss": float(np.mean(losses) if losses else 0),
                        "val_dice": val_dice, "val_iou": val_iou})
        log.info("epoch %d: loss=%.4f dice=%.4f iou=%.4f (%.1fs)",
                 epoch, history[-1]["loss"], val_dice, val_iou,
                 time.time() - t0)
        _write_curves(curves_path, history)
        if tb_writer is not None:
            tb_writer.add_scalar("train/loss", history[-1]["loss"], epoch)
            tb_writer.add_scalar("val/dice", val_dice, epoch)
            tb_writer.add_scalar("val/iou", val_iou, epoch)

        def save(name):
            save_msgpack(ckpt_dir / name,
                         checkpoint_payload(model, tx, opt_state, epoch))

        if val_dice > best_dice:
            best_dice = val_dice
            patience = 0
            plateau = 0
            save("best.msgpack")
        else:
            patience += 1
            plateau += 1
            if sched_type != "onecycle" and plateau >= cfg.get(
                    "scheduler.patience", 2):
                plateau = 0
                factor = cfg.get("scheduler.factor", 0.5)
                opt_state.hyperparams["learning_rate"] = np.float32(
                    opt_state.hyperparams["learning_rate"] * np.float32(factor))
                log.info("plateau: lr scaled by %.2f", factor)
            if patience >= cfg.get("training.early_stop_patience", 5):
                log.info("early stop at epoch %d", epoch)
                break
        save("last.msgpack")

    if tb_writer is not None:
        tb_writer.close()
    return {"best_dice": best_dice, "history": history,
            "checkpoint_dir": str(ckpt_dir),
            "curves_csv": str(curves_path),
            "seconds": seconds, "steps": n_steps}


if __name__ == "__main__":
    train_from_config()
