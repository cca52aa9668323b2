"""Native OCR for machine-printed text (the port of
``pathway_tpu/xpacks/llm/_ocr.py``: host numpy, the same engine; backs
PaddleOCRParser when the paddleocr package is absent; reference:
xpacks/llm/parsers.py PaddleOCR wrapper).  It needs pillow (and
matplotlib's bundled fonts) for its templates.

Classic pipeline, fully vectorized: binarize -> line segmentation by
horizontal projection -> glyph blocks by vertical projection -> per-block
oversegmentation DP (cuts at blank columns and ink minima, so kerned
glyphs that touch split and multi-stroke glyphs heal) -> classification
by nearest template.  The atlas renders printable ASCII black-on-white
from embedded fonts only — PIL's scalable default plus the DejaVu
sans/mono/serif/bold faces matplotlib bundles, at two sizes each — and
pushes it through the SAME binarization the document path uses, so
antialiasing artifacts cancel.  Measured on clean renders: ~1.0
char-accuracy on monospace (the terminal-screenshot case), ~0.9 on
proportional sans.

Features per glyph: an aspect-preserving BOX x BOX shape block plus
baseline-anchored scalars (glyph top/bottom relative to the line's
baseline, in cap-height units) — the cues that separate '.' from quote
marks and 'p' from 'P'.  The line's vertical scale is unknown (a line of
lowercase has no ascender reference), so classification scores two
hypotheses — median glyph height = x-height vs = cap-height — and keeps
the better-scoring line reading.  Classification is one
(n_glyphs, D) x (D, n_classes) matmul.

This is deliberately NOT a photographic-OCR model: skewed scans and
natural-scene text need paddleocr (used automatically when installed).
"""

from __future__ import annotations

import functools

import numpy as np

_CHARS = [chr(c) for c in range(33, 127)]  # printable ASCII minus space
_BOX = 16      # shape-block normalization box
_TSIZE = 32    # template render size (px)
_PITCH = 3 * _TSIZE  # px per character cell in the atlas render
_SCALAR_W = 1.5  # weight of each scalar vs the (unit-norm) shape block


def _binarize(img: np.ndarray) -> np.ndarray:
    """Grayscale -> ink mask; handles dark-on-light and light-on-dark."""
    if img.ndim == 3:
        img = img.mean(axis=2)
    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    thresh = (img.min() + img.max()) / 2.0
    mask = img > thresh
    if mask.mean() > 0.5:  # ink is the minority phase of a text raster
        mask = ~mask
    return mask.astype(np.float32)


def _resize(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor resize (dependency-free)."""
    H, W = a.shape
    yi = np.minimum((np.arange(h) * H) // h, H - 1)
    xi = np.minimum((np.arange(w) * W) // w, W - 1)
    return a[np.ix_(yi, xi)].astype(np.float32)


def _shape_block(crop: np.ndarray) -> np.ndarray:
    """Tight crop -> BOX x BOX aspect-preserving centered bitmap, unit
    l2 norm (thin 'l' stays a bar, '.' stays a blob)."""
    h, w = crop.shape
    scale = _BOX / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    box = np.zeros((_BOX, _BOX), np.float32)
    y0, x0 = (_BOX - nh) // 2, (_BOX - nw) // 2
    box[y0:y0 + nh, x0:x0 + nw] = _resize(crop, nh, nw)
    flat = box.reshape(-1)
    n = np.linalg.norm(flat)
    return flat / n if n > 0 else flat


def _feature(crop: np.ndarray, top: float, bottom: float, baseline: float,
             cap_h: float) -> np.ndarray:
    """Shape block + baseline-anchored scalars in cap-height units."""
    scalars = np.array([
        (bottom - baseline) / cap_h,   # descender depth (0 on baseline)
        (baseline - top) / cap_h,      # height above baseline
    ], np.float32) * _SCALAR_W
    return np.concatenate([_shape_block(crop), scalars])


_GLYPH_PENALTY = 0.08  # DP per-glyph split penalty (see _dp_segment)


def _match_score(seg: np.ndarray, baseline: float, cap_h: float,
                 atlas, tmpl_sq) -> tuple[float, int]:
    """(negative squared distance to nearest template, template index)."""
    ys, xs = np.nonzero(seg > 0.5)
    if len(ys) == 0:
        return -np.inf, -1
    crop = seg[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    f = _feature(crop, float(ys.min()), float(ys.max() + 1), baseline, cap_h)
    scores = f @ atlas - tmpl_sq
    b = int(scores.argmax())
    # scores = f.t - ||t||^2/2; distance^2 = ||f||^2 - 2*scores
    d2 = float(f @ f) - 2.0 * float(scores[b])
    return -d2, b


def _dp_segment(line: np.ndarray, s: int, e: int, baseline: float,
                cap_h: float, atlas, tmpl_sq):
    """Oversegmentation DP over one glyph block.

    A block may span several projection runs (an 'm' whose stems
    binarize with blank columns between them, a '"', an 'i' dot) and a
    single run may hold several kerned glyphs that touch (no blank
    column).  Candidate cuts are every blank column boundary plus the
    ink-minima inside runs; the DP picks the segmentation maximizing
    sum(match - _GLYPH_PENALTY) — the per-glyph penalty keeps an 'm'
    from being read as 'rn' unless the split genuinely matches better.
    Returns [(start, stop, template_idx, match_score)]."""
    min_w = max(1, int(cap_h * 0.12))
    max_w = max(2, int(cap_h * 1.6))
    if e - s <= min(max_w * 0.75, cap_h * 0.8):  # narrow: single glyph
        sc, b = _match_score(line[:, s:e], baseline, cap_h, atlas, tmpl_sq)
        return [(s, e, b, sc)] if b >= 0 else []
    col_ink = line[:, s:e].sum(axis=0)
    cuts = {0, e - s}
    # blank-column boundaries (run edges inside the block)
    for i in range(1, e - s):
        if (col_ink[i] == 0) != (col_ink[i - 1] == 0):
            cuts.add(i)
    # weakest-ink interior minima (kerned glyphs that touch)
    for i in range(1, e - s - 1):
        if (col_ink[i] > 0
                and col_ink[i] <= min(2.0, col_ink[col_ink > 0].min() + 1)
                and col_ink[i] <= col_ink[i - 1]
                and col_ink[i] <= col_ink[i + 1]):
            cuts.add(i)
    cuts = sorted(cuts)
    n = len(cuts)
    score = [-np.inf] * n
    back: list[tuple[int, int] | None] = [None] * n
    score[0] = 0.0
    for j in range(1, n):
        for i in range(j - 1, -1, -1):
            w = cuts[j] - cuts[i]
            if w > max_w:
                break
            if w < min_w or score[i] == -np.inf:
                continue
            m, b = _match_score(line[:, s + cuts[i]:s + cuts[j]],
                                baseline, cap_h, atlas, tmpl_sq)
            if m == -np.inf:
                continue
            cand = score[i] + m - _GLYPH_PENALTY
            if cand > score[j]:
                score[j] = cand
                back[j] = (i, b, m)
    if back[n - 1] is None:  # DP found nothing (degenerate run)
        sc, b = _match_score(line[:, s:e], baseline, cap_h, atlas, tmpl_sq)
        return [(s, e, b, sc)] if b >= 0 else []
    out = []
    j = n - 1
    while j > 0 and back[j] is not None:
        i, b, m = back[j]
        out.append((s + cuts[i], s + cuts[j], b, m))
        j = i
    return list(reversed(out))


def _segments(profile: np.ndarray, min_gap: int = 1):
    """[start, stop) runs of nonzero entries in a 1-D projection, merging
    runs separated by less than min_gap."""
    on = profile > 0
    runs, start = [], None
    for i, v in enumerate(on):
        if v and start is None:
            start = i
        elif not v and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, len(on)))
    merged = []
    for s, e in runs:
        if merged and s - merged[-1][1] < min_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _template_fonts():
    """Embedded fonts only: PIL's scalable default (Aileron) plus the
    DejaVu sans / mono / serif families matplotlib bundles — the faces
    common machine-rendered documents and terminal screenshots use."""
    from PIL import ImageFont

    fonts = []
    # several render sizes per face: small tiers match the NN-resize /
    # hinting artifacts of small-print documents, the large tier clean
    # print
    sizes = (_TSIZE, 20, 16, 14)
    for size in sizes:
        try:
            fonts.append(ImageFont.load_default(size=size))
        except TypeError:  # older pillow: bitmap-only default
            fonts.append(ImageFont.load_default())
            break
    try:
        import os

        import matplotlib

        ttf = os.path.join(os.path.dirname(matplotlib.__file__),
                           "mpl-data", "fonts", "ttf")
        for name in ("DejaVuSans.ttf", "DejaVuSansMono.ttf",
                     "DejaVuSerif.ttf", "DejaVuSans-Bold.ttf"):
            path = os.path.join(ttf, name)
            if os.path.exists(path):
                for size in sizes:
                    fonts.append(ImageFont.truetype(path, size))
    except ImportError:
        pass
    return fonts


def _render_alphabet(font):
    """Template chars at a fixed pitch, black-on-white like a document."""
    from PIL import Image, ImageDraw

    im = Image.new("L", (_PITCH * len(_CHARS) + 8, _TSIZE * 3), 255)
    d = ImageDraw.Draw(im)
    for i, ch in enumerate(_CHARS):
        d.text((4 + i * _PITCH, _TSIZE // 2), ch, fill=0, font=font)
    return np.asarray(im, np.float32)


@functools.lru_cache(maxsize=1)
def _atlas():
    """Returns (templates (D, C), chars, max_w_ratio, xh_over_cap).

    One template column per (char, font).  Baseline = bottom of 'n'; cap
    height = top-of-'H' to baseline; every template's scalars are
    measured against its own font's anchors."""
    cols, chars = [], []
    xh_ratios: list[float] = []
    for font in _template_fonts():
        ink = _binarize(_render_alphabet(font))

        def cell(i, ink=ink):
            c = ink[:, 4 + i * _PITCH - 2: 4 + (i + 1) * _PITCH - 2]
            ys, xs = np.nonzero(c > 0.5)
            if len(ys) == 0:
                return None
            return (c[ys.min():ys.max() + 1, xs.min():xs.max() + 1],
                    float(ys.min()), float(ys.max() + 1))

        n_crop = cell(_CHARS.index("n"))
        h_crop = cell(_CHARS.index("H"))
        if n_crop is None or h_crop is None:
            continue
        baseline = n_crop[2]
        cap_h = baseline - h_crop[1]
        xh_ratios.append((n_crop[2] - n_crop[1]) / cap_h)
        for i, ch in enumerate(_CHARS):
            got = cell(i)
            if got is None:
                continue
            crop, top, bottom = got
            cols.append(_feature(crop, top, bottom, baseline, cap_h))
            chars.append(ch)
    templates = np.stack(cols, axis=1)
    tmpl_sq = 0.5 * (templates * templates).sum(axis=0)
    return templates, tmpl_sq, chars, float(np.mean(xh_ratios))


def _read_line(line: np.ndarray, atlas, tmpl_sq, chars, xh_over_cap):
    """Classify one line under both scale hypotheses; return the better
    (text, mean_score) reading."""
    # provisional scale from glyph statistics
    runs0 = _segments(line.sum(axis=0))
    if not runs0:
        return "", -np.inf
    heights, bottoms = [], []
    for s, e in runs0:
        ys = np.nonzero(line[:, s:e].max(axis=1) > 0.5)[0]
        if len(ys):
            heights.append(ys.max() + 1 - ys.min())
            bottoms.append(ys.max() + 1)
    med_h = float(np.median(heights))
    baseline = float(np.median(bottoms))
    best = ("", -np.inf)
    for cap_hyp in (med_h, med_h / xh_over_cap):
        # group runs separated by sub-glyph gaps into blocks, so a
        # multi-stroke glyph split by binarization heals inside the DP
        join_gap = max(2.0, cap_hyp * 0.12)
        blocks: list[list[int]] = []
        for s, e in runs0:
            if blocks and s - blocks[-1][1] <= join_gap:
                blocks[-1][1] = e
            else:
                blocks.append([s, e])
        glyphs = []  # (start, stop, template_idx, score)
        for s, e in blocks:
            glyphs.extend(_dp_segment(line, s, e, baseline, cap_hyp,
                                      atlas, tmpl_sq))
        if not glyphs:
            continue
        # hypothesis score = mean nearest-template similarity, reusing
        # the scores the DP already computed for its chosen segmentation
        mean_score = float(np.mean([g[3] for g in glyphs]))
        gaps = [glyphs[i][0] - glyphs[i - 1][1]
                for i in range(1, len(glyphs))]
        space_w = _space_threshold(gaps, cap_hyp)
        text = []
        for i, (s, e, b, _m) in enumerate(glyphs):
            if i > 0 and gaps[i - 1] >= space_w:
                text.append(" ")
            text.append(chars[b])
        if mean_score > best[1]:
            best = ("".join(text), mean_score)
    return best


def _space_threshold(gaps: list[int], cap_h: float) -> float:
    """Word gaps sit well above the line's median (letter) gap: ~1.8x the
    median separates them for both kerned proportional text (letter gaps
    0-2, word gaps 5+) and monospace (letter ~4, word ~12).  The
    cap-height ceiling keeps wide-tracked fonts from swallowing real
    spaces; the floor keeps 1-px kerning jitter from minting them."""
    pos = [g for g in gaps if g >= 0]
    med = float(np.median(pos)) if pos else 0.0
    return max(3.0, min(1.8 * (med + 1.0), 0.6 * cap_h))


def ocr_image(img: np.ndarray) -> str:
    """Read machine-printed text from an (H, W[, 3]) array."""
    ink = _binarize(np.asarray(img))
    atlas, tmpl_sq, chars, xh_over_cap = _atlas()
    out = []
    for y0, y1 in _segments(ink.sum(axis=1), min_gap=2):
        text, _score = _read_line(ink[y0:y1], atlas, tmpl_sq, chars,
                                  xh_over_cap)
        if text:
            out.append(text)
    return "\n".join(out)
