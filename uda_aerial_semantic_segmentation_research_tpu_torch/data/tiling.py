"""Spatial tiling of large aerial rasters (numpy only).

The port's own copy of ``tile_grid`` / ``tile_image`` / ``stitch_tiles``
from the JAX package's ``data/tiling.py``: fixed-size tiles cut from the
full-resolution raster feed the model in batches, and per-tile logits
stitch back with overlap averaging.
"""

from __future__ import annotations

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


def tile_image(image: np.ndarray, tile: int, overlap: int = 0):
    """Cut a raster into fixed-size tiles.

    Images smaller than ``tile`` are edge-padded so every output has the
    shape (tile, tile, C).

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
