"""Single-image, batch and full-raster inference, and the batch-prediction CLI.

Counterpart of the JAX package's ``inference/predict.py``:

- ``load_class_dict``      the class-color CSV as rows (``csv`` module)
- ``create_colored_mask``  label map -> RGB through the class colors
- ``create_overlay``       red binary-mask overlay on the image
- ``predict_mask``         one image -> model -> ``sigmoid > 0.5``
- ``predict_batch``        batch argmax (the serving path)
- ``predict_raster``       full-resolution raster: tiles, overlap-mean stitch
- ``test_model``           predictions, colored masks, overlays and a
                           class-distribution report for a directory

``predict_mask`` keeps the reference's contract: it thresholds the sigmoid
of the multiclass logits (the JAX package documents it; ``predict_batch``
is the argmax path).  Images are NHWC.  Every function that runs the model
runs on ``cuda`` unless the caller passes ``device="cpu"``; the model must
already be on that device.  cv2 and PIL are imported only where a function
needs them.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data.tiling import (
    stitch_tiles,
    tile_image,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.verify_csv import read_csv
from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    denormalize_images,
    normalize_images,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
    make_predict_step,
    model_device,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.profiling import annotate


def _check_model_device(model, device) -> torch.device:
    dev = resolve_device(device)
    if model_device(model).type != dev.type:
        raise ValueError(f"model is on {model_device(model)}, not on {dev}")
    return model_device(model)


def _host(x) -> np.ndarray:
    """numpy view of an array-like; torch tensors (bf16 included) as float32
    when floating, numpy bfloat16 arrays as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def load_class_dict():
    """The rows ``[name, r, g, b]`` of ``<DATA_DIR>/class_dict_seg.csv`` in
    file order (row ``i`` is class ``i``), or None when it cannot be read."""
    csv_path = os.path.join(Config.DATA_DIR, "class_dict_seg.csv")
    try:
        return read_csv(csv_path)[1]
    except Exception as e:
        print(f"Error loading class dictionary: {e}")
        return None


def create_colored_mask(prediction, class_rows) -> np.ndarray:
    """Integer label map (H, W) -> uint8 (H, W, 3) RGB: the pixels of class
    ``i`` take the colour of row ``i``."""
    prediction = _host(prediction)
    h, w = prediction.shape
    colored = np.zeros((h, w, 3), dtype=np.uint8)
    for idx, row in enumerate(class_rows):
        colored[prediction == idx] = [int(row[1]), int(row[2]), int(row[3])]
    return colored


def create_overlay(image, mask, alpha: float = 0.5) -> np.ndarray:
    """Red-on-image binary overlay -> uint8 (H, W, 3).

    ``image``: HWC (or CHW) uint8, float in [0, 1], or normalized model
    input (denormalized first), numpy or torch, bf16 included; ``mask``:
    2-D, its pixels > 0 painted red at ``alpha``.
    """
    img = _host(image)
    if img.ndim == 3 and img.shape[0] == 3 and img.shape[-1] != 3:
        img = np.transpose(img, (1, 2, 0))
    if np.issubdtype(img.dtype, np.floating):
        if img.min() < -0.01:  # normalized input -> denormalize
            img = denormalize_images(torch.from_numpy(np.ascontiguousarray(img))).numpy()
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    mask = _host(mask)
    mask_colored = np.zeros((*mask.shape, 3), dtype=np.uint8)
    mask_colored[mask > 0] = [255, 0, 0]
    out = (img.astype(np.float32) * (1 - alpha)
           + mask_colored.astype(np.float32) * alpha)
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_hwc(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[:2] != (size, size):
        import cv2

        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    return img


def _prepare_input(img, image_size: int) -> np.ndarray:
    """PIL image / array / tensor -> normalized float32 (1, S, S, 3).

    The first image of a batch is taken, CHW becomes HWC; then by value
    range: above 1.5 it is uint8 (resized, then ``normalize_images``), at
    or above -0.01 floats in [0, 1] (resized, then standardized), else
    already normalized (resized only)."""
    try:
        from PIL import Image

        if isinstance(img, Image.Image):
            img = np.asarray(img.convert("RGB"))
    except ImportError:
        pass

    arr = _host(img).astype(np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC

    if arr.max() > 1.5:                      # raw uint8-ranged
        arr = _resize_hwc(arr.astype(np.uint8), image_size)
        arr = normalize_images(torch.from_numpy(np.ascontiguousarray(arr))).numpy()
    elif arr.min() >= -0.01:                 # [0,1] floats
        arr = _resize_hwc(arr, image_size)
        arr = (arr - np.asarray(Config.NORMALIZE_MEAN, np.float32)) / np.asarray(
            Config.NORMALIZE_STD, np.float32)
    else:                                    # already normalized
        arr = _resize_hwc(arr, image_size)
    return np.ascontiguousarray(arr, dtype=np.float32)[None]


def predict_mask(model, img, device=None) -> np.ndarray:
    """One image at ``Config.IMAGE_SIZE`` -> the float32 mask
    ``sigmoid(logits) > 0.5`` of every class, (S, S, C) (the batch axis
    squeezed).  The model runs in eval mode."""
    dev = _check_model_device(model, device)
    model.eval()
    x = torch.from_numpy(_prepare_input(img, Config.IMAGE_SIZE)).to(dev)
    with torch.inference_mode():
        probs = torch.sigmoid(model(x).float())
        mask = (probs > 0.5).to(torch.float32)
    return mask.squeeze().cpu().numpy()


def predict_batch(model, images, device=None) -> np.ndarray:
    """Batch argmax prediction.

    ``images``: (B, H, W, C) raw uint8 or normalized float NHWC (CHW
    accepted).  Returns int32 label maps (B, H, W) as numpy.  The model
    runs in eval mode (running BatchNorm statistics, left unchanged), as
    the JAX package's ``ModelBundle`` always does.
    """
    with annotate("uda.serve.request"):
        dev = _check_model_device(model, device)
        model.eval()
        arr = np.asarray(images)
        if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
            arr = np.transpose(arr, (0, 2, 3, 1))
        with torch.inference_mode():
            with annotate("uda.serve.upload"):
                if np.issubdtype(arr.dtype, np.integer):
                    x = normalize_images(torch.tensor(arr, device=dev))
                else:
                    x = torch.tensor(arr, dtype=torch.float32, device=dev)
            with annotate("uda.serve.forward"):
                preds = model(x).argmax(dim=-1)
        with annotate("uda.serve.download"):
            return preds.to(torch.int32).cpu().numpy()


def predict_raster(model, image, tile: int = 512, overlap: int = 64,
                   batch_size: int = 8, device=None) -> np.ndarray:
    """Full-resolution raster inference by tiling + overlap-mean stitching.

    ``image``: (H, W, 3) uint8 RGB array, or the path of an image file
    (read with cv2, BGR -> RGB).  Tiles go through the model in batches of
    ``batch_size``; per-tile LOGITS stitch back with overlap averaging, then
    one argmax.  Returns (H, W) int32.
    """
    _check_model_device(model, device)
    if isinstance(image, (str, os.PathLike)):
        import cv2

        decoded = cv2.imread(str(image))
        if decoded is None:
            raise ValueError(f"Failed to load image: {image}")
        image = cv2.cvtColor(decoded, cv2.COLOR_BGR2RGB)
    image = np.asarray(image)
    h, w = image.shape[:2]
    step = make_predict_step(model)
    tiles, origins, padded_hw = tile_image(image, tile, overlap)
    logits = [step(tiles[i:i + batch_size]).cpu().numpy()
              for i in range(0, len(tiles), batch_size)]
    full = stitch_tiles(np.concatenate(logits), origins, padded_hw, reduce="mean")
    return np.argmax(full, axis=-1).astype(np.int32)[:h, :w]


def _load_weights(model, path: str) -> None:
    """A checkpoint's ``model_state_dict`` (or the whole file), in the JAX
    layout that either package writes, into ``model`` through
    ``from_jax_state_dict``; keys the model lacks are ignored, as by the JAX
    ``load_state_dict(strict=False)``."""
    ckpt = load_checkpoint(path)
    model.load_state_dict(from_jax_state_dict(ckpt.get("model_state_dict", ckpt)), strict=False)


def test_model(model_path: str, test_dir: str, output_dir: str,
               model=None, batch_size: Optional[int] = None,
               max_images: Optional[int] = None, device=None) -> int:
    """Batch-prediction CLI.

    Loads a checkpoint into ``model`` (a fresh ``create_unet`` on ``device``
    when None), predicts every image under ``test_dir`` at
    ``Config.IMAGE_SIZE``, and writes ``predictions/`` (grayscale label
    maps), ``colored_masks/``, ``overlays/`` and a ``prediction_stats.txt``
    class-distribution report under ``output_dir``.  Returns the number of
    images predicted.
    """
    import cv2

    from uda_aerial_semantic_segmentation_research_tpu_torch.data.target_dataset import (
        TargetDataset,
    )

    batch_size = batch_size or Config.BATCH_SIZE
    output_dir = Path(output_dir)
    pred_dir = output_dir / "predictions"
    colored_dir = output_dir / "colored_masks"
    overlay_dir = output_dir / "overlays"
    for d in (pred_dir, colored_dir, overlay_dir):
        d.mkdir(parents=True, exist_ok=True)

    if model is None:
        from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet

        model = create_unet(device=resolve_device(device))
    _check_model_device(model, device)
    if model_path and os.path.exists(model_path):
        _load_weights(model, model_path)
        print(f"Loaded checkpoint from {model_path}")

    class_rows = load_class_dict()
    dataset = TargetDataset(images_dir=test_dir, verbose=False,
                            target_size=(Config.IMAGE_SIZE, Config.IMAGE_SIZE))
    names = dataset.images[:max_images] if max_images else dataset.images

    num_classes = getattr(model, "classes", Config.NUM_CLASSES)
    class_pixels = np.zeros(num_classes, dtype=np.int64)
    n_done = 0
    for start in range(0, len(names), batch_size):
        chunk = names[start:start + batch_size]
        # names is a prefix slice of dataset.images: index == position
        imgs = np.stack([dataset.load_raw(start + k) for k in range(len(chunk))])
        preds = predict_batch(model, imgs, device=device)
        for name, img, pred in zip(chunk, imgs, preds):
            stem = Path(name).stem
            cv2.imwrite(str(pred_dir / f"{stem}.png"), pred.astype(np.uint8))
            if class_rows is not None:
                colored = create_colored_mask(pred, class_rows)
                cv2.imwrite(str(colored_dir / f"{stem}.png"),
                            cv2.cvtColor(colored, cv2.COLOR_RGB2BGR))
            overlay = create_overlay(img, pred > 0)
            cv2.imwrite(str(overlay_dir / f"{stem}.png"),
                        cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            binc = np.bincount(pred.reshape(-1), minlength=num_classes)
            class_pixels += binc[:num_classes]
            n_done += 1

    total = max(int(class_pixels.sum()), 1)
    lines = [f"Prediction statistics over {n_done} images", "=" * 40]
    for c in range(num_classes):
        name = (str(class_rows[c][0]).strip()
                if class_rows is not None and c < len(class_rows) else f"class_{c}")
        frac = class_pixels[c] / total
        lines.append(f"{c:3d} {name:20s} {class_pixels[c]:>12d} ({frac:6.2%})")
    (output_dir / "prediction_stats.txt").write_text("\n".join(lines) + "\n")
    print(f"Wrote predictions for {n_done} images to {output_dir}")
    return n_done
