"""Spatial tiling of large aerial rasters (numpy only).

The port's own copy of the JAX package's ``data/tiling.py``: fixed-size
tiles cut from the full-resolution raster feed the model in batches, and
per-tile logits stitch back with overlap averaging.

- ``tile_image``          raster -> (N, tile, tile, C) tiles + origins
- ``stitch_tiles``        per-tile predictions -> full raster (overlap-averaged)
- ``TiledRasterDataset``  every tile of every raster in a directory as one
                          indexable dataset (cv2, imported when used)
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def tile_grid(h: int, w: int, tile: int, overlap: int = 0) -> List[Tuple[int, int]]:
    """Top-left origins of a covering grid (last row/col snapped inward)."""
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be < tile {tile}")
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if not ys or ys[-1] + tile < h:
        ys.append(max(h - tile, 0))
    if not xs or xs[-1] + tile < w:
        xs.append(max(w - tile, 0))
    return [(y, x) for y in sorted(set(ys)) for x in sorted(set(xs))]


def tile_image(image: np.ndarray, tile: int, overlap: int = 0, pad_value: int = 0):
    """Cut a raster into fixed-size tiles.

    Images smaller than ``tile`` are edge-padded so every output has the
    shape (tile, tile, C).  ``pad_value`` is accepted for the JAX signature
    and unused there too: the padding repeats the edge.

    Returns (tiles (N, tile, tile, C), origins [(y, x)], padded_hw).
    """
    img = np.asarray(image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    ph, pw = max(tile - h, 0), max(tile - w, 0)
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
        h, w = img.shape[:2]
    origins = tile_grid(h, w, tile, overlap)
    tiles = np.stack([img[y:y + tile, x:x + tile] for y, x in origins])
    if squeeze:
        tiles = tiles[..., 0]
    return tiles, origins, (h, w)


def stitch_tiles(tiles: np.ndarray, origins: Sequence[Tuple[int, int]],
                 out_hw: Tuple[int, int], reduce: str = "mean") -> np.ndarray:
    """Reassemble per-tile outputs into the full raster.

    ``tiles``: (N, t, t) int label maps (last write wins on overlaps) or
    (N, t, t, C) float maps (reduce='mean' averages overlaps -- the
    right thing for logits).
    """
    tiles = np.asarray(tiles)
    t = tiles.shape[1]
    h, w = out_hw
    if tiles.ndim == 3:
        out = np.zeros((h, w), dtype=tiles.dtype)
        for tl, (y, x) in zip(tiles, origins):
            out[y:y + t, x:x + t] = tl
        return out

    if reduce != "mean":
        raise ValueError(f"unknown reduce '{reduce}' for float tiles")
    c = tiles.shape[-1]
    acc = np.zeros((h, w, c), dtype=np.float64)
    cnt = np.zeros((h, w, 1), dtype=np.float64)
    for tl, (y, x) in zip(tiles, origins):
        acc[y:y + t, x:x + t] += tl
        cnt[y:y + t, x:x + t] += 1.0
    return (acc / np.maximum(cnt, 1.0)).astype(tiles.dtype)


class TiledRasterDataset:
    """Every fixed-size tile of every raster under a directory.

    Indexable like the other datasets (``load_raw`` gives the uint8 RGB
    tile, ``__getitem__`` the transformed one), so it composes with
    ``DataLoader`` and the samplers.  Rasters smaller than ``tile`` are
    edge-padded.
    """

    def __init__(self, images_dir: str, tile: int = 512, overlap: int = 0,
                 transform=None, verbose: bool = True):
        import cv2

        from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
            IMG_EXTS,
        )

        self.images_dir = images_dir
        self.tile = tile
        self.overlap = overlap
        self.transform = transform
        self.images = sorted(f for f in os.listdir(images_dir) if f.endswith(IMG_EXTS))

        # index: (image_idx, y, x) per tile
        self._index: List[Tuple[int, int, int]] = []
        self._sizes: List[Tuple[int, int]] = []
        for i, name in enumerate(self.images):
            img = cv2.imread(os.path.join(images_dir, name))
            if img is None:
                raise ValueError(f"Failed to load {name}")
            h, w = max(img.shape[0], tile), max(img.shape[1], tile)
            self._sizes.append((img.shape[0], img.shape[1]))
            for y, x in tile_grid(h, w, tile, overlap):
                self._index.append((i, y, x))
        if verbose:
            print(f"TiledRasterDataset: {len(self.images)} rasters -> "
                  f"{len(self._index)} {tile}px tiles")

    def __len__(self):
        return len(self._index)

    def load_raw(self, idx: int) -> np.ndarray:
        import cv2

        i, y, x = self._index[idx]
        path = os.path.join(self.images_dir, self.images[i])
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        t = self.tile
        h, w = img.shape[:2]
        if h < t or w < t:
            img = np.pad(img, ((0, max(t - h, 0)), (0, max(t - w, 0)), (0, 0)), mode="edge")
        return img[y:y + t, x:x + t]

    def __getitem__(self, idx: int):
        img = self.load_raw(idx)
        if self.transform is not None:
            img = self.transform(image=img)["image"]
        return img
