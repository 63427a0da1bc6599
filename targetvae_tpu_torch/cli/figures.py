"""The clustering CLIs' figures, drawn in numpy and written as PNG
(utils/png.py): the card has neither matplotlib nor an image library. Each
figure is the JAX CLI's plot without its text (titles, axes, legends and
colour bars; there is no font renderer), under the JAX CLI's file stem with
.png for .jpg (no JPEG encoder either):

- save_tsne: the t-SNE (cli/tsne.py, on the device) scattered, coloured by
  label through matplotlib's `rainbow` under `BoundaryNorm(0..10)`, else
  in matplotlib's first colour (targetvae_tpu/cli/clustering_common.py:124);
- save_confusion_matrix: the counts as a heat map in `Blues`, each written
  in a digit bitmap of this module's own, light on dark cells as seaborn
  writes them (:146);
- save_histograms: 50-bin histograms (np.histogram's edges, which are
  plt.hist's), overlaid at alpha 0.6 where there are two
  (cli/clustering_particles.py:85-100);
- save_z_scatter: the 2-D latents coloured by cluster as save_tsne colours
  labels (cli/clustering_galaxy.py:74-85).

The colour maps are matplotlib's 256-entry lookup tables: `rainbow` is
analytic (red |2x - 0.5|, green sin(pi x), blue cos(pi x / 2)), `Blues`
linear between ColorBrewer's nine colours.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np

from ..utils.png import write_png

N_COLOURS = 256
FIRST_COLOUR = (0x1F, 0x77, 0xB4)     # matplotlib's C0
SECOND_COLOUR = (0xFF, 0x7F, 0x0E)    # C1
BLUES_TABLE = ("f7fbff", "deebf7", "c6dbef", "9ecae1", "6baed6", "4292c6",
               "2171b5", "08519c", "08306b")
DIGITS = ("01110 10001 10011 10101 11001 10001 01110",
          "00100 01100 00100 00100 00100 00100 01110",
          "01110 10001 00001 00010 00100 01000 11111",
          "11111 00010 00100 00010 00001 10001 01110",
          "00010 00110 01010 10010 11111 00010 00010",
          "11111 10000 11110 00001 00001 10001 01110",
          "00110 01000 10000 11110 10001 10001 01110",
          "11111 00001 00010 00100 01000 01000 01000",
          "01110 10001 10001 01110 10001 10001 01110",
          "01110 10001 10001 01111 00001 00010 01100")
GLYPHS = np.array([[[c == "1" for c in row] for row in d.split()]
                   for d in DIGITS])                    # (10, 7, 5) bool


def _rainbow_lut() -> np.ndarray:
    x = np.linspace(0.0, 1.0, N_COLOURS)
    rgb = np.stack([np.abs(2 * x - 0.5), np.sin(np.pi * x),
                    np.cos(np.pi * x / 2)], axis=1)
    return np.clip(rgb, 0.0, 1.0)


def _blues_lut() -> np.ndarray:
    table = np.array([[int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)]
                      for h in BLUES_TABLE])
    at = np.linspace(0.0, 1.0, len(table))
    x = np.linspace(0.0, 1.0, N_COLOURS)
    return np.stack([np.interp(x, at, table[:, c]) for c in range(3)], axis=1)


RAINBOW = _rainbow_lut()
BLUES = _blues_lut()


def _lookup(lut: np.ndarray, x) -> np.ndarray:
    """A colour map's colours at x in [0, 1], as matplotlib indexes its
    table: entry floor(x * 256), 1 in the last."""
    i = np.floor(np.asarray(x, np.float64) * N_COLOURS).astype(np.int64)
    return lut[np.clip(i, 0, N_COLOURS - 1)]


def rainbow(x) -> np.ndarray:
    """matplotlib's `rainbow` at x in [0, 1]: (..., 3) floats."""
    return _lookup(RAINBOW, x)


def blues(x) -> np.ndarray:
    """matplotlib's `Blues` at x in [0, 1]: (..., 3) floats."""
    return _lookup(BLUES, x)


def _to_uint8(rgb: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(rgb) * 255), 0, 255).astype(np.uint8)


def label_colours(labels) -> np.ndarray:
    """Colours of integer labels under `rainbow` and BoundaryNorm(0, 1,
    ..., 10) with 256 colours: label l in 0..9 takes table entry
    int(255 / 9 * l), labels from 10 the last, below 0 the first.
    (N, 3) uint8."""
    v = np.asarray(labels, np.float64)
    i = np.floor(v).astype(np.int64)
    i = (255 / 9 * np.clip(i, 0, 9)).astype(np.int16).astype(np.int64)
    i = np.where(v >= 10, N_COLOURS - 1, np.where(v < 0, 0, i))
    return _to_uint8(RAINBOW[i])


# ---- canvases ----

def _canvas(h: int, w: int) -> np.ndarray:
    return np.full((h, w, 3), 255, np.uint8)


def _frame(img: np.ndarray, top: int, left: int, bottom: int,
           right: int) -> None:
    img[top, left:right + 1] = 0
    img[bottom, left:right + 1] = 0
    img[top:bottom + 1, left] = 0
    img[top:bottom + 1, right] = 0


def _axis(values: np.ndarray, lo_px: int, hi_px: int,
          flip: bool = False) -> np.ndarray:
    """Pixel positions of values over [lo_px, hi_px] with matplotlib's 5 %
    margins on either side."""
    lo, hi = float(values.min()), float(values.max())
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    pad = 0.05 * (hi - lo)
    t = (values - (lo - pad)) / ((hi + pad) - (lo - pad))
    if flip:
        t = 1.0 - t
    return np.round(lo_px + t * (hi_px - lo_px)).astype(np.int64)


def scatter_image(points: np.ndarray, colours: Optional[np.ndarray] = None,
                  size: int = 1000, margin: int = 60,
                  radius: int = 1) -> np.ndarray:
    """The points (N, 2) as discs of `radius` pixels, drawn in order on a
    size x size canvas inside a frame, y up; colours (N, 3) uint8 or None
    (matplotlib's first colour)."""
    pts = np.asarray(points, np.float64)
    img = _canvas(size, size)
    lo, hi = margin, size - margin - 1
    _frame(img, lo - 1, lo - 1, hi + 1, hi + 1)
    if colours is None:
        colours = np.tile(np.array(FIRST_COLOUR, np.uint8), (len(pts), 1))
    px = _axis(pts[:, 0], lo, hi)
    py = _axis(pts[:, 1], lo, hi, flip=True)
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius + radius]
    ys = (py[:, None] + np.array([o[0] for o in offs])[None]).ravel()
    xs = (px[:, None] + np.array([o[1] for o in offs])[None]).ravel()
    img[ys, xs] = np.repeat(colours, len(offs), axis=0)
    return img


def histogram_image(series: Sequence[np.ndarray], bins: int = 50,
                    alpha: Optional[float] = None, width: int = 800,
                    height: int = 500, margin: int = 50) -> np.ndarray:
    """Each series' `bins`-bin histogram (np.histogram's edges) as bars
    from a shared baseline, in matplotlib's colour cycle, each bar blended
    over what lies below at `alpha` (None: opaque)."""
    hists = [np.histogram(np.asarray(s, np.float64).ravel(), bins=bins)
             for s in series]
    edges = np.concatenate([e for _, e in hists])
    top = max(int(c.max()) for c, _ in hists)
    img = _canvas(height, width).astype(np.float64)
    left, right = margin, width - margin - 1
    lo, hi = margin, height - margin - 1
    for k, (counts, e) in enumerate(hists):
        colour = np.array((FIRST_COLOUR, SECOND_COLOUR)[k % 2], np.float64)
        a = 1.0 if alpha is None else alpha
        xs = _axis(np.concatenate([edges, e]), left, right)[len(edges):]
        heights = np.round(counts / (1.05 * max(top, 1))
                           * (hi - lo)).astype(np.int64)
        for j, h in enumerate(heights):
            if h > 0:
                cell = img[hi - h + 1:hi + 1, xs[j]:max(xs[j + 1], xs[j] + 1)]
                cell[...] = (1 - a) * cell + a * colour
    img = np.round(img).astype(np.uint8)
    _frame(img, lo - 1, left - 1, hi + 1, right + 1)
    return img


def _text_width(n: int, scale: int) -> int:
    return len(str(n)) * 6 * scale - scale


def _draw_number(img: np.ndarray, n: int, cy: int, cx: int, scale: int,
                 colour) -> None:
    """n in the digit bitmap, scaled `scale` times, centred at (cy, cx)."""
    x = cx - _text_width(n, scale) // 2
    y = cy - 7 * scale // 2
    for ch in str(n):
        glyph = np.kron(GLYPHS[int(ch)], np.ones((scale, scale), bool))
        region = img[y:y + 7 * scale, x:x + 5 * scale]
        region[glyph] = colour
        x += 6 * scale


def _luminance(rgb: np.ndarray) -> np.ndarray:
    """seaborn's relative_luminance of (..., 3) floats in [0, 1]."""
    lin = np.where(rgb <= 0.03928, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return lin @ np.array([0.2126, 0.7152, 0.0722])


def confusion_image(cm: np.ndarray, scale: int = 2,
                    margin: int = 40) -> np.ndarray:
    """The counts cm (L, M) as a `Blues` heat map between their least and
    greatest, each count written in its cell, dark grey (seaborn's ".15")
    on light cells and white on dark (luminance 0.408)."""
    cm = np.asarray(cm, np.int64)
    rows, cols = cm.shape
    cell = max(48, _text_width(int(cm.max()), scale) + 12)
    img = _canvas(2 * margin + rows * cell, 2 * margin + cols * cell)
    lo, hi = int(cm.min()), int(cm.max())
    t = (cm - lo) / (hi - lo) if hi > lo else np.zeros(cm.shape)
    colours = blues(t)
    dark = np.array([38, 38, 38], np.uint8)
    light = np.array([255, 255, 255], np.uint8)
    for i in range(rows):
        for j in range(cols):
            y, x = margin + i * cell, margin + j * cell
            img[y:y + cell, x:x + cell] = _to_uint8(colours[i, j])
            text = dark if _luminance(colours[i, j]) > 0.408 else light
            _draw_number(img, int(cm[i, j]), y + cell // 2, x + cell // 2,
                         scale, text)
    return img


# ---- the CLIs' figures ----

def save_tsne(path: str, z_values: np.ndarray, labels=None, device=None,
              seed: int = 0) -> None:
    """The t-SNE of z_values on `device`, scattered (labels: coloured by
    label) to a PNG at path. Fewer than 31 points, where scikit-learn's
    perplexity of 30 cannot be met, take perplexity (N - 1) / 3."""
    from .tsne import tsne

    print("# saving tsne figure ... ", file=sys.stderr)
    n = len(z_values)
    perplexity = 30.0 if n > 30 else (n - 1) / 3
    emb, _ = tsne(z_values, 2, perplexity=perplexity, learning_rate=200.0,
                  seed=seed, device=device)
    colours = None if labels is None else label_colours(labels)
    write_png(path, scatter_image(emb, colours, radius=1))


def confusion_counts(labels: np.ndarray, cluster: np.ndarray,
                     mapping) -> np.ndarray:
    """The confusion matrix of (labels, cluster), its columns in the
    matched order mapping[1] (the JAX CLI's cm[:, mapping[1]])."""
    labels = np.asarray(labels, np.int64)
    cluster = np.asarray(cluster, np.int64)
    d = int(max(labels.max(), cluster.max())) + 1
    cm = np.zeros((d, d), np.int64)
    np.add.at(cm, (labels, cluster), 1)
    return cm[:, np.asarray(mapping[1])]


def save_confusion_matrix(path: str, labels: np.ndarray, cluster: np.ndarray,
                          mapping) -> None:
    print("# saving confusion matrix ... ", file=sys.stderr)
    write_png(path, confusion_image(confusion_counts(labels, cluster,
                                                     mapping)))


def save_histograms(path: str, series: Sequence[np.ndarray]) -> None:
    """50-bin histograms of one series (opaque) or more (alpha 0.6)."""
    write_png(path, histogram_image(series, 50,
                                    None if len(series) == 1 else 0.6))


def save_z_scatter(path: str, z_values: np.ndarray, cluster) -> None:
    """The first two latent coordinates, one pixel a point, coloured by
    cluster."""
    write_png(path, scatter_image(np.asarray(z_values)[:, :2],
                                  label_colours(cluster), radius=0))
