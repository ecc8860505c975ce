"""ORB keypoints, rBRIEF descriptors and cross-checked Hamming matching in
PyTorch, on the device of the input image: the counterpart of the "orb"
backend of `scorp_tpu.pipeline.matching`, which calls OpenCV
(`cv2.ORB_create(nfeatures=4096).detectAndCompute`, then
`cv2.BFMatcher(NORM_HAMMING, crossCheck=True)` and a sort by distance),
without cv2.

It follows OpenCV's ORB at its defaults: scale factor 1.2, 8 levels, edge
threshold 31, first level 0, WTA_K 2, the Harris score, patch size 31, FAST
threshold 20. The stages, each its own function:

  1. grey image (`sift.to_gray`, cv2's fixed-point weights);
  2. `features_per_level`: the geometric split of n_features (`cvRound`),
     the last level taking the remainder;
  3. `level_sizes`: cvRound(cols / 1.2^l) in float32;
  4. `pyramid`: each level resized from the one before with
     `resize_linear_exact` (cv2.resize INTER_LINEAR_EXACT: 8-bit fixed-point
     weights, rows then columns, rounded once);
  5. `fast_scores`: FAST-9/16 at threshold 20 with its score
     (`cornerScore<16>`) and a 3x3 strict non-maximum suppression;
  6. `runByImageBorder(31)`, 7. `retainBest(2 x cap)` and 9. `retainBest(cap)`
     in `detect`, with the ties at the boundary response kept;
  8. `harris_responses`: 7x7 block, k = 0.04, OpenCV's inline Sobel in int
     sums, then its float32 expression in its order;
 10. `ic_angles`: the intensity centroid over the circle of radius 15
     (`umax`) in int moments, then `sift.fast_atan2`;
 11. pt x 1.2^level, size 31 x 1.2^level;
 12. `blur7`: GaussianBlur(7x7, sigma 2, BORDER_REFLECT_101) of each 8-bit
     level as ORB computes it on its pyramid's sub-image: float32 fused
     multiply-adds in cv2 5.0's (IPP) order, rounded half to even;
 13. `descriptors`: the 256 tests of `orb_pattern.PATTERN_31` rotated by the
     keypoint's angle (cos and sin through float64, each product float32),
     sampled at cvRound (half to even), packed into 32 bytes;
 14. `cross_check_match_hamming`: mutual nearest neighbours in Hamming
     distance, ties to the lowest index, stably sorted by distance.

The detection is integer up to the Harris score and the angle, as in
OpenCV. Every float step is one IEEE operation in OpenCV's order, or exact
in float64, but cos and sin, which go through float64; so the CPU and the
card agree (held equal on the card in `tests/test_torch_cuda.py`).
Keypoints come level by level, in raster order within a level: OpenCV's
order wherever no retainBest bites; where one does, OpenCV's order is that
of its nth_element and the port keeps its own (the set is the same).

The data-dependent sizes cost two host synchronisations per image (the
candidate corners and the retained keypoints) and one per match (the mutual
pairs).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .orb_pattern import PATTERN_31
from .sift import (
    _cv_round, _device_ints, _fp32_matmul, _reflect101, fast_atan2, mutual_nearest,
)

_f32 = np.float32
N_LEVELS = 8
SCALE_FACTOR = float(_f32(1.2))  # ORB_create takes it as a float
EDGE_THRESHOLD = 31
PATCH_SIZE = 31
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = 0.04
HALF_PATCH = PATCH_SIZE // 2
BLUR_SIGMA = 2.0

# FAST's circle of 16 (x, y) in OpenCV's order (its offsets16)
_CIRCLE16 = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
             (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))


# --- 2-3. features per level, level sizes -----------------------------------------------

def features_per_level(n_features: int = 4096) -> list[int]:
    """The cap of each level, in OpenCV's float32 arithmetic."""
    factor = _f32(1.0 / SCALE_FACTOR)
    desired = (_f32(n_features) * (_f32(1) - factor)
               / (_f32(1) - _f32(math.pow(float(factor), float(N_LEVELS)))))
    caps = []
    for _ in range(N_LEVELS - 1):
        caps.append(_cv_round(desired))
        desired = _f32(desired * factor)
    caps.append(max(n_features - sum(caps), 0))
    return caps


def level_scales() -> list:
    """float32 1.2^level of each level."""
    return [_f32(math.pow(SCALE_FACTOR, float(level))) for level in range(N_LEVELS)]


def level_sizes(h: int, w: int) -> list[tuple[int, int]]:
    """(rows, cols) of each level: cvRound(n * (1.f / scale)) in float32."""
    out = []
    for s in level_scales():
        inv = _f32(1) / s
        out.append((_cv_round(_f32(h) * inv), _cv_round(_f32(w) * inv)))
    return out


# --- 4. pyramid -------------------------------------------------------------------------

def _exact_taps(src: int, dst: int, device):
    """cv2.resize(INTER_LINEAR_EXACT)'s taps per output index: f = (src /
    dst) (d + 0.5) - 0.5 in float64, s = floor(f), the weights 256 -
    round(256 frac) and round(256 frac); before the first and from the last
    source pixel on, the edge pixel with weight 256."""
    d = torch.arange(dst, device=device, dtype=torch.float64)
    f = (d + 0.5) * (1.0 / (dst / src)) - 0.5
    s = torch.floor(f)
    c1 = torch.round((f - s) * 256).to(torch.int32)
    s = s.to(torch.int64)
    low, high = s < 0, (s >= src - 1) | (src == 1)
    s0 = torch.where(low, torch.zeros_like(s), torch.where(high, torch.full_like(s, src - 1), s))
    c1 = torch.where(low | high, torch.zeros_like(c1), c1)
    return s0, torch.clamp(s0 + 1, max=src - 1), 256 - c1, c1


def resize_linear_exact(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[H, W] uint8 -> [rows, cols] uint8, as cv2.resize(img, (cols, rows),
    interpolation=INTER_LINEAR_EXACT): each row as sum w_i s_i (8.8 fixed
    point), then the columns' sum w_j h_j (16.16), + 2^15, >> 16."""
    h, w = img.shape
    sx, sx1, a0, a1 = _exact_taps(w, cols, img.device)
    x = img.to(torch.int32)
    rows_h = x[:, sx] * a0 + x[:, sx1] * a1
    sy, sy1, b0, b1 = _exact_taps(h, rows, img.device)
    out = rows_h[sy] * b0[:, None] + rows_h[sy1] * b1[:, None]
    return ((out + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    """[N_LEVELS] uint8 level images, each resized from the one before."""
    levels = [gray]
    for rows, cols in level_sizes(*gray.shape)[1:]:
        levels.append(resize_linear_exact(levels[-1], rows, cols))
    return levels


# --- 5. FAST ----------------------------------------------------------------------------

def fast_scores(img: torch.Tensor) -> torch.Tensor:
    """[H, W] uint8 -> [H, W] int32: the FAST-9/16 score of every corner
    that survives the 3x3 non-maximum suppression (a score strictly above
    its 8 neighbours'), else 0, as FastFeatureDetector(20, True).

    A pixel 3 px inside the border is a corner when 9 contiguous circle
    pixels are all brighter than v + t or all darker than v - t; its score
    (cornerScore<16>) is the largest such t, less 1: the most, over the 16
    arcs, of the arc's least |v - p| on one side."""
    h, w = img.shape
    out = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    if h < 7 or w < 7:
        return out
    x = img.to(torch.int16)
    v = x[3:h - 3, 3:w - 3]
    d = torch.stack([v - x[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] for dx, dy in _CIRCLE16])

    def arc9_min(a):  # [16, ...] -> min over each circular arc of 9 from k
        m2 = torch.minimum(a, a.roll(-1, 0))
        m4 = torch.minimum(m2, m2.roll(-2, 0))
        m8 = torch.minimum(m4, m4.roll(-4, 0))
        return torch.minimum(m8, a.roll(-8, 0))

    score = torch.maximum(arc9_min(d).amax(0), arc9_min(-d).amax(0)).to(torch.int32)
    score = torch.where(score > FAST_THRESHOLD, score - 1, torch.zeros_like(score))
    out[3:h - 3, 3:w - 3] = score
    pad = torch.nn.functional.pad(out, (1, 1, 1, 1))
    nb = torch.stack([pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]).amax(0)
    return torch.where(out > nb, out, torch.zeros_like(out))


# --- 6-9. border, retainBest, Harris ----------------------------------------------------

def _segment_kth(values, seg, n_seg: int, k: torch.Tensor):
    """Per segment s of `values` (segments given by `seg`, any order), the
    k[s]-th largest value (1-based), or -inf when the segment has at most k[s]
    values; on the device, without a host synchronisation."""
    order = torch.sort(values, descending=True, stable=True).indices
    order = order[torch.sort(seg[order], stable=True).indices]
    counts = torch.zeros(n_seg, dtype=torch.int64, device=seg.device).index_add_(
        0, seg, torch.ones_like(seg))  # bincount would synchronise on the card
    starts = torch.cumsum(counts, 0) - counts
    pos = (starts + k - 1).clamp(0, max(len(values) - 1, 0))
    kth = values[order][pos] if len(values) else torch.zeros_like(k, dtype=values.dtype)
    return torch.where(counts > k, kth.to(torch.float32), torch.full_like(kth, -math.inf,
                                                                          dtype=torch.float32))


def retain_best(response, level, caps: torch.Tensor) -> torch.Tensor:
    """KeyPointsFilter::retainBest(cap) within each level, as a mask: every
    keypoint whose response reaches its level's cap-th largest (all where
    the level has at most cap; none where the cap is 0)."""
    boundary = _segment_kth(response, level, len(caps), caps)
    return (response.to(torch.float32) >= boundary[level]) & (caps[level] > 0)


class _Levels:
    """Level images laid end to end in one flat buffer, so one gather
    serves keypoints of every level."""

    def __init__(self, levels: list[torch.Tensor]):
        dev = levels[0].device
        self.shapes = [tuple(v.shape) for v in levels]
        self.data = torch.cat([v.reshape(-1) for v in levels]).to(torch.int32)
        sizes = [h * w for h, w in self.shapes]
        self.off = _device_ints(np.cumsum([0] + sizes[:-1]), dev)
        self.w = _device_ints([w for _, w in self.shapes], dev)

    def at(self, level, y, x):
        return self.data[self.off[level] + y * self.w[level] + x]


def harris_responses(lv: _Levels, level, y, x) -> torch.Tensor:
    """[N] float32 Harris responses of OpenCV's ORB (HarrisResponses, block
    7, k 0.04): Sobel Ix, Iy at each pixel of the 7x7 block in ints, a =
    sum Ix^2, b = sum Iy^2, c = sum Ix Iy, then ((float)a * b - (float)c * c
    - k * ((float)a + b) * ((float)a + b)) * scale^4 in float32 in that
    order, scale = 1 / (4 * 7 * 255)."""
    r = HARRIS_BLOCK // 2
    g = torch.arange(-r - 1, r + 2, device=y.device)
    win = lv.at(level[:, None, None], y[:, None, None] + g[:, None], x[:, None, None] + g)
    ix = ((win[:, 1:-1, 2:] - win[:, 1:-1, :-2]) * 2 + (win[:, :-2, 2:] - win[:, :-2, :-2])
          + (win[:, 2:, 2:] - win[:, 2:, :-2]))
    iy = ((win[:, 2:, 1:-1] - win[:, :-2, 1:-1]) * 2 + (win[:, 2:, :-2] - win[:, :-2, :-2])
          + (win[:, 2:, 2:] - win[:, :-2, 2:]))
    a = (ix * ix).sum((1, 2)).to(torch.float32)
    b = (iy * iy).sum((1, 2)).to(torch.float32)
    cc = (ix * iy).sum((1, 2)).to(torch.float32)
    scale = _f32(1) / (_f32(4 * HARRIS_BLOCK) * _f32(255))
    sss = float(scale * scale * scale * scale)
    s = a + b
    return ((a * b - cc * cc) - (s * float(_f32(HARRIS_K))) * s) * sss


# --- 10. angle --------------------------------------------------------------------------

def umax(half: int = HALF_PATCH) -> list[int]:
    """The half-width of each row of OpenCV's circular patch, made symmetric
    as ORB's computeKeyPoints makes it."""
    vmax = math.floor(_f32(half) * _f32(math.sqrt(2.0)) / _f32(2) + _f32(1))
    vmin = math.ceil(_f32(half) * _f32(math.sqrt(2.0)) / _f32(2))
    u = [0] * (half + 2)
    for v in range(vmax + 1):
        u[v] = _cv_round(math.sqrt(float(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while u[v0] == u[v0 + 1]:
            v0 += 1
        u[v] = v0
        v0 += 1
    return u[:half + 1]


def _circle() -> np.ndarray:
    """[2, M] (u, v) of every pixel of the circular patch."""
    um = umax()
    return np.array([(u, v) for v in range(-HALF_PATCH, HALF_PATCH + 1)
                     for u in range(-um[abs(v)], um[abs(v)] + 1)], np.int64).T


def ic_angles(lv: _Levels, level, y, x) -> torch.Tensor:
    """[N] float32 degrees: fastAtan2(m01, m10) of the int moments m10 =
    sum u I(u, v) and m01 = sum v I(u, v) over the circular patch."""
    u, v = _constants(y.device)["circle"]
    win = lv.at(level[:, None], y[:, None] + v, x[:, None] + u)
    m10 = (win * u).sum(1).to(torch.float32)
    m01 = (win * v).sum(1).to(torch.float32)
    return fast_atan2(m01, m10)


_CONSTANTS: dict = {}


def _constants(device) -> dict:
    """The circle's offsets and the pattern on `device`, made once per
    device."""
    key = str(device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = {"circle": torch.as_tensor(_circle(), device=device),
                           "pattern": torch.as_tensor(PATTERN_31, device=device)}
    return _CONSTANTS[key]


# --- 11. detect -------------------------------------------------------------------------

def detect(levels: list[torch.Tensor], n_features: int = 4096) -> dict:
    """ORB's computeKeyPoints on a pyramid: FAST per level, the border, the
    two retainBest, Harris, the angle. Returns octave (the level), the
    level's integer (y, x), pt [N, 2] (x, y) in image pixels, size, angle
    and response, level by level, in raster order within a level."""
    dev = levels[0].device
    caps = _device_ints(features_per_level(n_features), dev)
    scores, masks = [], []
    for img in levels:
        h, w = img.shape
        s = fast_scores(img)
        keep = torch.zeros_like(s, dtype=torch.bool)
        e = EDGE_THRESHOLD
        if h > 2 * e and w > 2 * e:
            keep[e:h - e, e:w - e] = s[e:h - e, e:w - e] > 0
        scores.append(s.reshape(-1))
        masks.append(keep.reshape(-1))
    flat = torch.cat(masks).nonzero()[:, 0]
    score = torch.cat(scores)[flat]
    lv = _Levels(levels)
    sizes = _device_ints([h * w for h, w in lv.shapes], dev)
    level = torch.searchsorted(torch.cumsum(sizes, 0), flat, right=True)
    rest = flat - lv.off[level]
    y, x = rest // lv.w[level], rest % lv.w[level]
    first = retain_best(score, level, 2 * caps)
    response = harris_responses(lv, level, y, x)
    # the second retainBest among the first's survivors: the rest go to an
    # extra level with cap 0
    rest_level = torch.where(first, level, torch.full_like(level, N_LEVELS))
    second = retain_best(response, rest_level, torch.cat([caps, caps[:1] * 0]))
    keep = second.nonzero()[:, 0]
    level, y, x, response = level[keep], y[keep], x[keep], response[keep]
    angle = ic_angles(lv, level, y, x)
    scale = torch.stack([torch.full((), float(s), dtype=torch.float32, device=dev)
                         for s in level_scales()])[level]
    pt = torch.stack([x.to(torch.float32), y.to(torch.float32)], 1) * scale[:, None]
    return {"octave": level, "y": y, "x": x, "pt": pt, "size": scale * float(PATCH_SIZE),
            "angle": angle, "response": response}


# --- 12-13. blur, descriptors -----------------------------------------------------------

def blur_kernel() -> np.ndarray:
    """[7] float32, as cv2.getGaussianKernel(7, 2, CV_32F)."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-x * x / (2 * BLUR_SIGMA ** 2))
    return (k / k.sum()).astype(np.float32)


def _fma(p: torch.Tensor, k: float, acc: torch.Tensor) -> torch.Tensor:
    """float32 p * k + acc rounded once, as a fused multiply-add: the
    product is exact in float64 and so, here, is the sum."""
    return (p.double() * k + acc.double()).to(torch.float32)


def blur7(img: torch.Tensor) -> torch.Tensor:
    """[H, W] uint8 -> the same, as OpenCV's ORB blurs each level in place
    (GaussianBlur(7x7, sigma 2, BORDER_REFLECT_101) on an 8-bit sub-image,
    which cv2's IPP build computes in float32): the rows as fused
    multiply-adds of the float32 kernel from the first tap to the last, the
    columns from the centre tap out, adding each pair of rows before its
    multiply-add, then rounded half to even and saturated."""
    h, w = img.shape
    k = [float(v) for v in blur_kernel()]
    x = img.to(torch.float32).index_select(1, _reflect101(w, 3, img.device))
    rows = x[:, 0:w] * k[0]
    for t in range(1, 7):
        rows = _fma(x[:, t:t + w], k[t], rows)
    y = rows.index_select(0, _reflect101(h, 3, img.device))
    out = y[3:3 + h] * k[3]
    for t in (2, 1, 0):
        out = _fma(y[t:t + h] + y[6 - t:6 - t + h], k[t], out)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def descriptors(blurred: _Levels, level, y, x, angle) -> torch.Tensor:
    """[N, 32] uint8 rBRIEF descriptors: test i compares the blurred level
    at the pattern's two points, rotated by the angle, x = px cos - py sin,
    y = px sin + py cos in float32 at cvRound; bit i % 8 of byte i // 8 is
    1 when the first is darker."""
    rad = angle * float(_f32(math.pi / 180.0))
    a = torch.cos(rad.double()).to(torch.float32)[:, None]
    b = torch.sin(rad.double()).to(torch.float32)[:, None]
    p = _constants(angle.device)["pattern"].reshape(1, 512, 2).to(torch.float32)
    px, py = p[..., 0], p[..., 1]
    ix = torch.round(px * a - py * b).to(torch.int64)
    iy = torch.round(px * b + py * a).to(torch.int64)
    vals = blurred.at(level[:, None], y[:, None] + iy, x[:, None] + ix).reshape(-1, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32).reshape(-1, 32, 8)
    weights = torch.pow(2, torch.arange(8, device=angle.device, dtype=torch.int32))
    return (bits * weights).sum(2).to(torch.uint8)


# --- detect and compute, match ----------------------------------------------------------

def detect_and_compute(gray: torch.Tensor, n_features: int = 4096) -> dict:
    """[H, W] uint8 on any device -> keypoints and descriptors on that
    device, as cv2.ORB_create(nfeatures=n_features).detectAndCompute: pt
    [N, 2] (x, y), size, angle, response, octave (the level) and desc
    [N, 32] uint8."""
    levels = pyramid(gray)
    kp = detect(levels, n_features)
    blurred = _Levels([blur7(img) for img in levels])
    kp["desc"] = descriptors(blurred, kp["octave"], kp["y"], kp["x"], kp["angle"])
    return {k: kp[k] for k in ("pt", "size", "angle", "response", "octave", "desc")}


def compute(gray: torch.Tensor, pt: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """ORB.compute on level-0 keypoints at integer positions pt [N, 2] (x,
    y), 31 px or more inside the border, with the given angles: [N, 32]
    uint8."""
    lv = _Levels([blur7(gray)])
    level = torch.zeros(len(pt), dtype=torch.int64, device=gray.device)
    xy = torch.round(pt).to(torch.int64)
    return descriptors(lv, level, xy[:, 1], xy[:, 0], angle.to(torch.float32))


def hamming(d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """[N0, N1] int32 Hamming distances of packed descriptors: |a| + |b| -
    2 a.b over their bits, one full-float32 product (0/1 entries and sums
    below 2^24, so exact)."""
    shifts = torch.arange(8, device=d0.device, dtype=torch.uint8)
    a = ((d0[:, :, None] >> shifts) & 1).reshape(len(d0), -1).to(torch.float32)
    b = ((d1[:, :, None] >> shifts) & 1).reshape(len(d1), -1).to(torch.float32)
    with _fp32_matmul():
        dot = a @ b.T
    return (a.sum(1)[:, None] + b.sum(1)[None, :] - 2 * dot).to(torch.int32)


def cross_check_match_hamming(d0: torch.Tensor, d1: torch.Tensor):
    """BFMatcher(NORM_HAMMING, crossCheck=True).match, sorted by distance as
    `sorted(..., key=distance)` sorts it: (query, train, distance) of every
    mutual nearest pair, ties to the lowest index."""
    dist = hamming(d0, d1)
    q, t = mutual_nearest(dist)
    d = dist[q, t].to(torch.float32)
    order = torch.sort(d, stable=True).indices
    return q[order], t[order], d[order]


def match_orb(gray0, gray1, n_features: int = 4096, device=None):
    """Grey images ([H, W] uint8, numpy or tensors) -> (uv0 [M,2], uv1
    [M,2], dist [M]) on `device` (default: gray0's, the CPU for numpy): the
    keypoint positions of the cross-checked ORB matches, sorted by Hamming
    distance, as the JAX package's cv2 "orb" backend lists them before
    post-processing. Empty when either image has fewer than 4 keypoints."""
    g0 = torch.as_tensor(gray0, device=device)
    g1 = torch.as_tensor(gray1, device=g0.device)
    k0 = detect_and_compute(g0, n_features)
    k1 = detect_and_compute(g1, n_features)
    if len(k0["size"]) < 4 or len(k1["size"]) < 4:
        empty = torch.zeros((0, 2), dtype=torch.float32, device=g0.device)
        return empty, empty.clone(), torch.zeros(0, dtype=torch.float32, device=g0.device)
    q, t, dist = cross_check_match_hamming(k0["desc"], k1["desc"])
    return k0["pt"][q], k1["pt"][t], dist
