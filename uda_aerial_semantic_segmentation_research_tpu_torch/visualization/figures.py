"""The trainer's figures in numpy: curve arithmetic and drawing.

The JAX package's trainer computes its ROC and precision-recall curves
with sklearn and draws the confusion matrix and the curves with matplotlib
and seaborn.  The port does both in numpy:

- ``roc_curve``, ``auc``, ``precision_recall_curve`` and
  ``average_precision_score`` follow sklearn's arithmetic for a binary
  target (``drop_intermediate`` as sklearn's defaults: True for ROC, False
  for precision-recall; scores sorted in descending order, ties grouped,
  counts summed in float64);
- ``heatmap_image`` and ``curves_image`` draw uint8 RGB images on a fixed
  1000 x 800 canvas (matplotlib's 10 x 8 inch figure at 100 dpi): a
  white-to-blue heatmap, and polylines in the class colors inside a framed
  unit square with a legend of "class:value" rows (the AUC or AP, in a
  3 x 5 pixel digit font; a class with one label only is not drawn, so the
  values are finite).  There is no other text (no title or axis
  labels), so the pixels differ from matplotlib's; the data drawn is the
  same.
"""

from __future__ import annotations

import numpy as np

from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.utils import (
    class_colors,
)

CANVAS_H, CANVAS_W = 800, 1000
_MARGIN = 60
_BLUES_LO = np.array([247, 251, 255], np.float64)    # matplotlib "Blues" ends
_BLUES_HI = np.array([8, 48, 107], np.float64)


# ---------------------------------------------------------------------------
# curves (sklearn's arithmetic, binary targets)
# ---------------------------------------------------------------------------
def _binary_clf_curve(y_true, y_score):
    """False and true positive counts at each distinct score, from the
    highest down, and those scores."""
    y_true = np.asarray(y_true).reshape(-1).astype(bool)
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) with collinear intermediate points dropped."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if len(fps) > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Area under a monotone curve by the trapezoidal rule."""
    x, y = np.asarray(x).reshape(-1), np.asarray(y).reshape(-1)
    if x.shape[0] < 2:
        raise ValueError("at least 2 points are needed to compute an area")
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError("x is neither increasing nor decreasing")
        direction = -1
    return float(direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0))


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing, ending at (1, 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1]


def average_precision_score(y_true, y_score) -> float:
    """Step-function integral of the precision-recall curve."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------
def _canvas() -> np.ndarray:
    return np.full((CANVAS_H, CANVAS_W, 3), 255, np.uint8)


def _frame(img: np.ndarray, top: int, left: int, bottom: int, right: int) -> None:
    img[top:bottom + 1, [left, right]] = 0
    img[[top, bottom], left:right + 1] = 0


def heatmap_image(cm) -> np.ndarray:
    """A (C, C) count matrix as white-to-blue cells (rows = true, columns =
    predicted), scaled by its largest count."""
    cm = np.asarray(cm, dtype=np.float64)
    c = cm.shape[0]
    img = _canvas()
    side = min(CANVAS_H, CANVAS_W) - 2 * _MARGIN
    top, left = (CANVAS_H - side) // 2, (CANVAS_W - side) // 2
    edges = top + np.arange(c + 1) * side // c, left + np.arange(c + 1) * side // c
    share = cm / max(cm.max(), 1.0)
    colors = np.rint(_BLUES_LO + share[..., None] * (_BLUES_HI - _BLUES_LO)).astype(np.uint8)
    rows = np.repeat(np.arange(c), np.diff(edges[0]))
    cols = np.repeat(np.arange(c), np.diff(edges[1]))
    img[top:top + side, left:left + side] = colors[rows[:, None], cols[None, :]]
    _frame(img, top, left, top + side, left + side)
    return img


def _plot_box():
    return _MARGIN, _MARGIN, CANVAS_H - _MARGIN, CANVAS_W - _MARGIN   # top, left, bottom, right


def _polyline(img: np.ndarray, x, y, color, dashed: bool = False) -> None:
    """Segments through the points (x, y) in [0, 1]^2, two pixels wide."""
    top, left, bottom, right = _plot_box()
    px = left + np.asarray(x, np.float64) * (right - left)
    py = bottom - np.asarray(y, np.float64) * (bottom - top)
    ok = np.isfinite(px) & np.isfinite(py)
    px, py = px[ok], py[ok]
    if len(px) < 2:
        return
    dx, dy = np.diff(px), np.diff(py)
    steps = np.ceil(np.maximum(np.abs(dx), np.abs(dy))).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(dx)), steps)
    t = (np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps, steps)) / np.maximum(
        np.repeat(steps - 1, steps), 1)
    xs = np.rint(px[seg] + t * dx[seg]).astype(np.int64)
    ys = np.rint(py[seg] + t * dy[seg]).astype(np.int64)
    if dashed:
        keep = (xs // 12) % 2 == 0
        xs, ys = xs[keep], ys[keep]
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        img[np.clip(ys + oy, 0, CANVAS_H - 1), np.clip(xs + ox, 0, CANVAS_W - 1)] = color


# 3 x 5 glyphs, rows top to bottom
_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"), "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"), "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"), "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"), "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"), "9": ("111", "101", "111", "001", "111"),
    ".": ("000", "000", "000", "000", "010"), ":": ("000", "010", "000", "010", "000"),
}
_SCALE = 3


def _text(img: np.ndarray, top: int, left: int, text: str) -> None:
    """Black text in the digit font, each font pixel a 3 x 3 block."""
    for i, ch in enumerate(text):
        glyph = np.array([[c == "1" for c in row] for row in _GLYPHS[ch]])
        block = np.kron(glyph, np.ones((_SCALE, _SCALE), bool))
        x0 = left + i * 4 * _SCALE
        region = img[top:top + block.shape[0], x0:x0 + block.shape[1]]
        region[block[:region.shape[0], :region.shape[1]]] = 0


def curves_image(curves, num_classes: int, diagonal: bool = False) -> np.ndarray:
    """``curves``: (class, x, y, value) tuples, each drawn in its class color
    (``visualization.utils.class_colors``) and listed in the legend as
    ``class:value``; ``diagonal``: the chance line of a ROC plot, dashed."""
    img = _canvas()
    table = np.rint(class_colors(max(num_classes, 1)) * 255).astype(np.uint8)
    if diagonal:
        _polyline(img, [0.0, 1.0], [0.0, 1.0], 0, dashed=True)
    for c, x, y, _ in curves:
        _polyline(img, x, y, table[c])
    top, _, _, right = _plot_box()
    for row, (c, _, _, value) in enumerate(curves):
        y0 = top + 8 + row * 6 * _SCALE
        if y0 + 5 * _SCALE > CANVAS_H:
            break
        x0 = right - 40 * _SCALE
        img[y0:y0 + 5 * _SCALE, x0:x0 + 4 * _SCALE] = table[c]
        _text(img, y0, x0 + 6 * _SCALE, f"{c}:{value:.2f}")
    _frame(img, *_plot_box())
    return img
