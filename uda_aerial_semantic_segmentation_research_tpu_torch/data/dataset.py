"""Source-domain (Semantic Drone) dataset with class-balanced sampling.

The port's copy of the JAX package's ``data/dataset.py``:

- ``WeightedRandomSampler``, ``Subset`` and ``random_split`` make the same
  numpy RNG calls, so for a seed their index sequences are identical to the
  JAX package's;
- ``DroneDataset`` pairs images and masks, computes the class statistics
  and inverse-frequency sample weights in one pass over the masks, cached
  as the same JSON file next to them, and decodes tiles as uint8 (H, W, 3)
  RGB images and int32 (H, W) masks (``load_raw``).

Decoding goes through the native decoder (``data/native.py``) where it is
available -- masks for the class statistics at their own resolution, and
image / mask pairs when ``image_size`` is set -- and through cv2 otherwise;
cv2 is imported only then.  Samples are numpy NHWC; the hot training path
pulls raw uint8 batches and augments them on the device.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from uda_aerial_semantic_segmentation_research_tpu_torch.data import native

IMG_EXTS = (".jpg", ".png", ".jpeg", ".JPG", ".PNG", ".JPEG")


class WeightedRandomSampler:
    """Sample indices ``0..len(weights)-1`` with replacement, p proportional
    to weights.  Yields positions into the weight vector, so it composes with
    ``Subset``."""

    def __init__(self, weights: np.ndarray, num_samples: int, replacement: bool = True,
                 seed: Optional[int] = None):
        weights = np.asarray(weights, dtype=np.float64)
        if weights.ndim != 1 or len(weights) == 0:
            raise ValueError("weights must be a non-empty 1-D array")
        self.probabilities = weights / weights.sum()
        self.num_samples = int(num_samples)
        self.replacement = replacement
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        idx = self._rng.choice(
            len(self.probabilities),
            size=self.num_samples,
            replace=self.replacement,
            p=self.probabilities,
        )
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class Subset:
    """View over a dataset restricted to ``indices``."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def random_split(dataset, lengths: Sequence[int], seed: int = 0):
    """Split a dataset into non-overlapping random subsets."""
    if sum(lengths) != len(dataset):
        raise ValueError(f"sum of lengths {sum(lengths)} != dataset size {len(dataset)}")
    perm = np.random.default_rng(seed).permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


def class_balance(per_sample: List[Dict[int, int]], sizes: List[int]):
    """Global pixel counts per class (in order of first appearance) and
    per-sample weights summing to 1: a sample's weight is the sum over the
    classes it holds of (its share of the sample's pixels) / (the class's
    share of all pixels)."""
    totals: Dict[int, int] = {}
    for d in per_sample:
        for k, v in d.items():
            totals[k] = totals.get(k, 0) + v
    total_pixels = sum(totals.values())
    weights = np.zeros(len(per_sample), dtype=np.float64)
    for i, d in enumerate(per_sample):
        w = 0.0
        for cls, count in d.items():
            class_freq = totals[cls] / total_pixels
            w += (count / sizes[i]) * (1.0 / class_freq)
        weights[i] = w
    return totals, weights / weights.sum()


def _mask_counts(path: str):
    """({class: pixel count} in ascending class order, pixel total) of one
    mask at its own resolution."""
    hist = native.mask_class_histogram(path, 256)
    if hist is not None:
        counts, total = hist
        present = np.nonzero(counts)[0]
        return {int(c): int(counts[c]) for c in present}, total
    import cv2

    mask = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if mask is None:
        raise ValueError(f"Failed to load mask: {path}")
    uniq, counts = np.unique(mask, return_counts=True)
    return {int(u): int(c) for u, c in zip(uniq, counts)}, int(mask.size)


class DroneDataset:
    """Paired aerial image / label-mask dataset with class balancing."""

    def __init__(
        self,
        images_dir: str,
        masks_dir: str,
        transform=None,
        balance_classes: bool = True,
        image_size: Optional[int] = None,
        verbose: bool = True,
    ):
        self.images_dir = images_dir
        self.masks_dir = masks_dir
        self.transform = transform
        self.balance_classes = balance_classes
        self.image_size = image_size

        self.images = sorted(f for f in os.listdir(images_dir) if f.endswith(IMG_EXTS))
        self.masks = sorted(f for f in os.listdir(masks_dir) if f.endswith(".png"))

        if verbose:
            print(f"Found {len(self.images)} images and {len(self.masks)} masks")
            if self.images:
                print(f"First image: {self.images[0]}")
                print(f"First mask: {self.masks[0]}")

        if len(self.images) != len(self.masks):
            raise ValueError(f"Number of images ({len(self.images)}) != "
                             f"number of masks ({len(self.masks)})")

        if balance_classes:
            if verbose:
                print("Calculating class statistics...")
            self.class_stats, self.sample_weights = self._scan_masks()

    # ------------------------------------------------------------------
    # class statistics (single decode pass, cached)
    # ------------------------------------------------------------------
    def _cache_path(self) -> Path:
        key = hashlib.sha1(
            ("|".join(self.masks) + self.masks_dir).encode()
        ).hexdigest()[:16]
        return Path(self.masks_dir) / f".class_stats_{key}.json"

    def _scan_masks(self):
        """Class pixel counts and per-sample weights (``class_balance``), read
        from the cache file when it holds one weight per mask."""
        cache = self._cache_path()
        if cache.exists():
            try:
                blob = json.loads(cache.read_text())
                stats = {int(k): int(v) for k, v in blob["class_stats"].items()}
                weights = np.asarray(blob["sample_weights"], dtype=np.float64)
                if len(weights) == len(self.masks):
                    return stats, weights
            except (json.JSONDecodeError, KeyError, ValueError):
                pass

        per_sample, sizes = [], []
        for name in self.masks:
            counts, size = _mask_counts(os.path.join(self.masks_dir, name))
            per_sample.append(counts)
            sizes.append(size)
        totals, weights = class_balance(per_sample, sizes)

        try:
            cache.write_text(json.dumps({
                "class_stats": {str(k): v for k, v in totals.items()},
                "sample_weights": weights.tolist(),
            }))
        except OSError:
            pass
        return totals, weights

    # ------------------------------------------------------------------
    def get_sampler(self, indices: Optional[Sequence[int]] = None):
        """Weighted sampler for balanced sampling; with ``indices`` (a
        ``Subset``'s) only those samples' weights are used and the yielded
        positions index into the subset."""
        if not self.balance_classes:
            return None
        w = self.sample_weights[list(indices)] if indices is not None else self.sample_weights
        w = w / w.sum()
        return WeightedRandomSampler(weights=w, num_samples=len(w), replacement=True)

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx: int):
        """Decode one (image uint8 HWC RGB, mask int32 HW) pair, resized to
        ``image_size`` when set.  With ``enable_raw_cache`` decoded pairs are
        kept in RAM after their first decode."""
        cache = getattr(self, "_raw_cache", None)
        if cache is not None and idx in cache:
            return cache[idx]
        out = self._decode_raw(idx)
        if cache is not None:
            cache[idx] = out
        return out

    def enable_raw_cache(self, max_bytes: int = 4 << 30):
        """Cache decoded tiles in RAM (skipped if the dataset exceeds
        ``max_bytes``).  Returns True when enabled."""
        if self.image_size is None:
            return False
        per = self.image_size * self.image_size * (3 + 4)
        if per * len(self.images) > max_bytes:
            return False
        self._raw_cache = {}
        return True

    def _decode_raw(self, idx: int):
        img_path = os.path.join(self.images_dir, self.images[idx])
        mask_path = os.path.join(self.masks_dir, self.masks[idx])

        if self.image_size is not None:
            s = self.image_size
            image = (native.decode_jpeg_rgb(img_path, s, s)
                     if img_path.lower().endswith((".jpg", ".jpeg")) else None)
            mask = native.decode_png_mask(mask_path, s, s)
            if image is not None and mask is not None:
                return image, mask

        import cv2

        image = cv2.imread(img_path)
        if image is None:
            raise ValueError(f"Failed to load image: {self.images[idx]}")
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        mask = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        if mask is None:
            raise ValueError(f"Failed to load mask: {self.masks[idx]}")
        if self.image_size is not None and image.shape[:2] != (self.image_size, self.image_size):
            s = (self.image_size, self.image_size)
            image = cv2.resize(image, s, interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, s, interpolation=cv2.INTER_NEAREST)
        return image, mask.astype(np.int32)

    def __getitem__(self, idx: int):
        image, mask = self.load_raw(idx)
        if self.transform is not None:
            out = self.transform(image=image, mask=mask)
            image, mask = out["image"], out["mask"]
            mask = np.asarray(mask).astype(np.int32)
        return image, mask
