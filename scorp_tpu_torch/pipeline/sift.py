"""SIFT keypoints, descriptors and cross-checked matching in PyTorch, on the
device of the input image: the counterpart of the "sift" backend of
`scorp_tpu.pipeline.matching`, which calls OpenCV
(`cv2.SIFT_create(nfeatures=4096).detectAndCompute`, then
`cv2.BFMatcher(NORM_L2, crossCheck=True)` and a sort by distance), without
cv2.

It follows OpenCV's float SIFT (`sift_wt = float`) at its defaults: 3 layers
per octave, contrast threshold 0.04, edge threshold 10, sigma 1.6, the first
octave at twice the image size. The stages, each its own function:

  1. grey image (`views.rgba_to_gray`, cv2's fixed-point weights) as float32;
  2. `gaussian_kernel` (`cv2.getGaussianKernel`: float64 coefficients,
     normalised, cast to float32) and a separable `blur` with
     BORDER_REFLECT_101, in float32 shifted adds (no convolution, so no TF32);
  3. `upscale2x` (`cv2.resize(INTER_LINEAR)` at 2x: weights 0.25 / 0.75,
     edge pixels repeated), then a blur to sigma 1.6;
  4. `gaussian_pyramid` and its differences of Gaussians;
  5. `scale_space_extrema`: 3x3x3 maxima (minima) with >= (<=), |v| > 1
     (floor(0.5 * 0.04 / 3 * 255)), a 5-pixel border, layers 1..3;
  6. `refine_extrema`: up to 5 Newton steps, batched over the candidates
     (OpenCV's derivative scales and its 3x3 Cramer solve), the contrast and
     edge tests; the packed octave word, point, size and response;
  7. `orientations`: the 36-bin gradient histogram (`fast_atan2`, OpenCV's
     polynomial), smoothed with [1, 4, 6, 4, 1] / 16, a keypoint per local
     peak >= 0.8 x max, parabolic interpolation;
  8. `filter_keypoints`: `removeDuplicatedSorted`, `retainBest(n)` (ties
     with the boundary response kept) and the scale back from the doubled
     image;
  9. `descriptors`: 4 x 4 cells x 8 bins with trilinear weights, clipped at
     0.2 x the norm, renormalised, x 512 and saturated to 0..255 (kept as
     float32);
 10. `cross_check_match`: mutual nearest neighbours in L2, ties to the
     lowest index, stably sorted by distance.

Every histogram is a dense per-keypoint window summed over a fixed axis (no
atomics), so one device gives the same result on every run. Squared
descriptor distances are integers below 2^24 and are computed in float64,
where every product and partial sum is exact.

The data-dependent sizes cost a few host synchronisations per image: the
candidates, the orientation peaks, the duplicate and `retainBest` filters,
the descriptor window radii and the mutual matches.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .views import rgba_to_gray

N_OCTAVE_LAYERS = 3
CONTRAST_THRESHOLD = 0.04
EDGE_THRESHOLD = 10.0
SIGMA = 1.6
FIRST_OCTAVE = -1
INIT_SIGMA = 0.5
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 4.5  # 3 x ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
# the largest window radii the refined scales allow: scale < 1.6 * 2^(3.5/3)
MAX_ORI_RADIUS = 16
FLT_EPSILON = float(np.finfo(np.float32).eps)

_f32 = np.float32
# cv::fastAtan2's coefficients (float products, as OpenCV's constants)
_ATAN_P = [float(_f32(c) * _f32(180.0 / math.pi)) for c in
           (0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
            -0.04432655554792128)]
_DBL_EPS_F32 = float(_f32(np.finfo(np.float64).eps))


def _cv_round(x: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(np.rint(x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device (PyTorch's
    vectorised CPU sqrt is not): through float64, where rounding twice is
    exact for a square root."""
    return torch.sqrt(x.double()).to(torch.float32)


@contextlib.contextmanager
def _fp32_matmul():
    """Matrix products in full float32 on the card (no TF32), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# --- 1-3. grey image, Gaussian blur, upscale --------------------------------------

def to_gray(image) -> np.ndarray:
    """PIL image -> [H,W] uint8, as cv2.cvtColor(RGB2GRAY) of its RGB."""
    return rgba_to_gray(np.asarray(image.convert("RGB")))


def gaussian_ksize(sigma: float) -> int:
    """GaussianBlur's kernel size for a float image: cvRound(8 sigma + 1) | 1."""
    return _cv_round(sigma * 4 * 2 + 1) | 1


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """[ksize] float32, as cv2.getGaussianKernel(ksize, sigma, CV_32F):
    the half kernel's exponentials and their normalisation in float64, in
    OpenCV's order (x = 2i - (n-1) against -0.125 / sigma^2), then float32."""
    n2 = (ksize - 1) // 2
    scale2x = -0.125 / (sigma * sigma)
    values = [math.exp(float(x * x) * scale2x) for x in range(1 - ksize, 1 - ksize + 2 * n2, 2)]
    total = 0.0
    for v in values:
        total += v
    total = total * 2.0 + 1.0
    if ksize % 2 == 0:
        total += 1.0
    mul = 1.0 / total
    out = np.empty(ksize, np.float64)
    for i, v in enumerate(values):
        out[i] = out[ksize - 1 - i] = v * mul
    out[n2] = mul
    if ksize % 2 == 0:
        out[n2 + 1] = mul
    return out.astype(np.float32)


def _reflect101(length: int, pad: int, device) -> torch.Tensor:
    """Source indices of [-pad, length + pad) under BORDER_REFLECT_101
    (cv::borderInterpolate, reflected as often as needed), made on the
    device (a host-to-device copy would synchronise)."""
    p = torch.arange(-pad, length + pad, device=device)
    if length == 1:
        return torch.zeros_like(p)
    q = torch.remainder(p, 2 * (length - 1))
    return torch.where(q < length, q, 2 * (length - 1) - q)


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """[..., H, W] float32 -> the same, as cv2.GaussianBlur(img, (0, 0),
    sigma) on a float image: the row filter summed tap by tap, then the
    symmetric column filter (centre, then pairs), BORDER_REFLECT_101."""
    k = gaussian_kernel(gaussian_ksize(sigma), sigma)
    r = len(k) // 2
    h, w = img.shape[-2:]
    xp = img.index_select(-1, _reflect101(w, r, img.device))
    acc = xp[..., 0:w] * float(k[0])
    for t in range(1, len(k)):
        acc = acc + xp[..., t:t + w] * float(k[t])
    yp = acc.index_select(-2, _reflect101(h, r, img.device))
    out = yp[..., r:r + h, :] * float(k[r])
    for t in range(1, r + 1):
        out = out + (yp[..., r + t:r + t + h, :] + yp[..., r - t:r - t + h, :]) * float(k[r + t])
    return out


def _linear_taps(src: int, dst: int, device):
    """cv2.resize(INTER_LINEAR)'s source indices and weights per output
    index: fx = (float)((d + 0.5) * src / dst - 0.5), sx = floor(fx), the
    weights 1 - frac and frac; clamped to (sx 0, weights 1, 0) before the
    first and after the last source pixel."""
    d = torch.arange(dst, device=device, dtype=torch.float64)
    f = ((d + 0.5) * (src / dst) - 0.5).to(torch.float32)
    s = torch.floor(f)
    f = f - s
    s = s.to(torch.int64)
    low, high = s < 0, s >= src - 1
    f = torch.where(low | high, torch.zeros_like(f), f)
    s = torch.where(low, torch.zeros_like(s), torch.where(high, torch.full_like(s, src - 1), s))
    a0 = 1 - f
    return s, torch.clamp(s + 1, max=src - 1), a0, 1 - a0


def upscale2x(img: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 -> [2H, 2W], as cv2.resize(img, (2W, 2H),
    interpolation=INTER_LINEAR) on a float image: rows, then columns."""
    h, w = img.shape
    sx, sx1, a0, a1 = _linear_taps(w, 2 * w, img.device)
    rows = img[:, sx] * a0 + img[:, sx1] * a1
    sy, sy1, b0, b1 = _linear_taps(h, 2 * h, img.device)
    return rows[sy] * b0[:, None] + rows[sy1] * b1[:, None]


def initial_image(gray: torch.Tensor) -> torch.Tensor:
    """[H, W] uint8 -> the first octave's base [2H, 2W] float32: the image
    doubled and blurred from the assumed 0.5 (1.0 doubled) to sigma 1.6."""
    sig_diff = float(np.sqrt(max(_f32(SIGMA) * _f32(SIGMA) - _f32(INIT_SIGMA * INIT_SIGMA * 4),
                                 _f32(0.01))).astype(np.float32))
    return blur(upscale2x(gray.to(torch.float32)), sig_diff)


# --- 4. pyramids ---------------------------------------------------------------------

def n_octaves_of(h2: int, w2: int) -> int:
    """Octaves of the doubled image: cvRound(log2(min side) - 2) + 1."""
    return _cv_round(math.log(min(h2, w2)) / math.log(2.0) - 2) - FIRST_OCTAVE


def layer_sigmas() -> list[float]:
    """The incremental blur of each layer of an octave (float64, OpenCV's)."""
    k = 2.0 ** (1.0 / N_OCTAVE_LAYERS)
    sig = [SIGMA]
    for i in range(1, N_OCTAVE_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def gaussian_pyramid(base: torch.Tensor, n_octaves: int) -> list[torch.Tensor]:
    """[n_octaves] of [layers + 3, H_o, W_o]: each layer blurred from the
    one before; an octave's base is every second pixel of the previous
    octave's layer `N_OCTAVE_LAYERS` (cv2.resize INTER_NEAREST at half)."""
    sig = layer_sigmas()
    pyr = []
    for o in range(n_octaves):
        if o == 0:
            layer = base
        else:
            prev = pyr[-1][N_OCTAVE_LAYERS]
            h, w = prev.shape
            layer = prev[0:2 * (h // 2):2, 0:2 * (w // 2):2]
        layers = [layer]
        for i in range(1, N_OCTAVE_LAYERS + 3):
            layers.append(blur(layers[-1], sig[i]))
        pyr.append(torch.stack(layers))
    return pyr


def _device_ints(values, device) -> torch.Tensor:
    """[len(values)] int64 on `device`, filled there (no host-to-device copy,
    which would synchronise)."""
    return torch.stack([torch.full((), int(v), dtype=torch.int64, device=device)
                        for v in values])


class _Flat:
    """Per-octave [layers, H_o, W_o] volumes laid end to end in one flat
    buffer, so one gather serves points of every octave."""

    def __init__(self, vols: list[torch.Tensor]):
        dev = vols[0].device
        self.shapes = [tuple(v.shape) for v in vols]
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.data = torch.cat([v.reshape(-1) for v in vols])
        self.off_t = _device_ints(self.offsets[:-1], dev)
        self.h_t = _device_ints([s[1] for s in self.shapes], dev)
        self.w_t = _device_ints([s[2] for s in self.shapes], dev)

    def index(self, o, layer, r, c):
        return self.off_t[o] + (layer * self.h_t[o] + r) * self.w_t[o] + c


def dog_pyramid(gpyr: list[torch.Tensor]) -> list[torch.Tensor]:
    """[n_octaves] of [layers + 2, H_o, W_o]: adjacent layers' differences."""
    return [g[1:] - g[:-1] for g in gpyr]


# --- 5. extrema ------------------------------------------------------------------

def contrast_floor() -> int:
    """The DoG pre-threshold: cvFloor(0.5 * 0.04 / 3 * 255)."""
    return math.floor(0.5 * CONTRAST_THRESHOLD / N_OCTAVE_LAYERS * 255)


def scale_space_extrema(dogs: list[torch.Tensor]):
    """(octave, layer, row, col) int64 [M] of every DoG sample in layers
    1..3, 5 px inside the border, with |v| > 1 that is >= its 26 neighbours
    and > 0, or <= them and < 0."""
    thr = contrast_floor()
    masks = []
    for d in dogs:
        _, h, w = d.shape
        ext = torch.zeros((N_OCTAVE_LAYERS, h, w), dtype=torch.bool, device=d.device)
        if h > 2 * IMG_BORDER and w > 2 * IMG_BORDER:
            vol = d[None, None]
            mx = torch.nn.functional.max_pool3d(vol, 3, 1)[0, 0]
            mn = -torch.nn.functional.max_pool3d(-vol, 3, 1)[0, 0]
            b = IMG_BORDER
            v = d[1:N_OCTAVE_LAYERS + 1, b:h - b, b:w - b]
            inner = (slice(None), slice(b - 1, h - b - 1), slice(b - 1, w - b - 1))
            mx, mn = mx[inner], mn[inner]
            ext[:, b:h - b, b:w - b] = (v.abs() > thr) & (((v > 0) & (v >= mx))
                                                          | ((v < 0) & (v <= mn)))
        masks.append(ext.reshape(-1))
    flat = torch.cat(masks).nonzero()[:, 0]
    sizes = [N_OCTAVE_LAYERS * d.shape[1] * d.shape[2] for d in dogs]
    starts = _device_ints(np.cumsum([0] + sizes[:-1]), flat.device)
    o = torch.searchsorted(starts, flat, right=True) - 1
    rest = flat - starts[o]
    hw = _device_ints([d.shape[1] * d.shape[2] for d in dogs], flat.device)[o]
    w = _device_ints([d.shape[2] for d in dogs], flat.device)[o]
    layer = rest // hw + 1
    r = (rest % hw) // w
    c = rest % w
    return o, layer, r, c


# --- 6. sub-pixel refinement ----------------------------------------------------------

def _derivatives(dog: _Flat, o, layer, r, c):
    """dD (x, y, s), the Hessian entries and the centre value at the points,
    with OpenCV's scales and its order of float operations."""
    h, w = dog.h_t[o], dog.w_t[o]
    base = dog.index(o, layer, r, c)[:, None]
    steps = torch.arange(-1, 2, device=base.device)
    # the 3x3x3 neighbourhood in one gather: [M, 27] by (layer, row, col)
    offs = ((steps[:, None, None] * (h * w)[:, None, None, None]
             + steps[None, :, None] * w[:, None, None, None])
            + steps[None, None, :]).reshape(len(o), 27)
    cube = dog.data[base + offs]

    def at(dl, dr, dc):
        return cube[:, (dl + 1) * 9 + (dr + 1) * 3 + dc + 1]

    img_scale = _f32(1.0) / _f32(255.0)
    deriv_scale = float(img_scale * _f32(0.5))
    second = float(img_scale)
    cross = float(img_scale * _f32(0.25))
    v = at(0, 0, 0)
    dx = (at(0, 0, 1) - at(0, 0, -1)) * deriv_scale
    dy = (at(0, 1, 0) - at(0, -1, 0)) * deriv_scale
    ds = (at(1, 0, 0) - at(-1, 0, 0)) * deriv_scale
    v2 = v * 2
    dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * second
    dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * second
    dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * second
    dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cross
    dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * cross
    dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * cross
    return v, (dx, dy, ds), (dxx, dyy, dss, dxy, dxs, dys)


def _solve3(hess, b):
    """Matx33f::solve(DECOMP_LU) for one right-hand side: Cramer's rule in
    float32 in OpenCV's order; a zero determinant gives 0."""
    dxx, dyy, dss, dxy, dxs, dys = hess
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = dxx, dxy, dxs, dxy, dyy, dys, dxs, dys, dss
    b0, b1, b2 = b
    det = (a00 * (a11 * a22 - a21 * a12) - a01 * (a10 * a22 - a20 * a12)
           + a02 * (a10 * a21 - a20 * a11))
    ok = det != 0
    d = 1 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * (b0 * (a11 * a22 - a12 * a21) - a01 * (b1 * a22 - a12 * b2)
              + a02 * (b1 * a21 - a11 * b2))
    x1 = d * (a00 * (b1 * a22 - a12 * b2) - b0 * (a10 * a22 - a12 * a20)
              + a02 * (a10 * b2 - b1 * a20))
    x2 = d * (a00 * (a11 * b2 - b1 * a21) - a01 * (a10 * b2 - b1 * a20)
              + b0 * (a10 * a21 - a11 * a20))
    zero = torch.zeros_like(det)
    return torch.where(ok, x0, zero), torch.where(ok, x1, zero), torch.where(ok, x2, zero)


def refine_extrema(dog: _Flat, o, layer, r, c):
    """OpenCV's adjustLocalExtrema on every candidate at once. Returns the
    survivors' dict: o, layer, r, c (the refined integer sample), pt [M,2]
    and size in doubled-image pixels, response, octave (the packed word,
    pyramid octave in the low byte) and scl_octv (the scale in the
    octave's pixels)."""
    keep = torch.ones_like(o, dtype=torch.bool)
    done = torch.zeros_like(keep)
    xi = xr = xc = torch.zeros(o.shape, dtype=torch.float32, device=o.device)
    hs = dog.h_t[o]
    ws = dog.w_t[o]
    lim = float(_f32(2**31 - 1) / _f32(3))  # (float)(INT_MAX / 3)
    for _ in range(MAX_INTERP_STEPS):
        act = keep & ~done
        _, dD, hess = _derivatives(dog, o, layer, r, c)
        x0, x1, x2 = _solve3(hess, dD)
        ni, nr, nc = -x2, -x1, -x0
        xi, xr, xc = (torch.where(act, new, old) for new, old in ((ni, xi), (nr, xr), (nc, xc)))
        conv = (ni.abs() < 0.5) & (nr.abs() < 0.5) & (nc.abs() < 0.5)
        done = done | (act & conv)
        move = act & ~conv
        huge = (ni.abs() > lim) | (nr.abs() > lim) | (nc.abs() > lim)
        keep = keep & ~(move & huge)
        move = move & ~huge
        step = [torch.where(move, torch.round(v).to(torch.int64), torch.zeros_like(o))
                for v in (nc, nr, ni)]
        c, r, layer = c + step[0], r + step[1], layer + step[2]
        out = ((layer < 1) | (layer > N_OCTAVE_LAYERS) | (c < IMG_BORDER)
               | (c >= ws - IMG_BORDER) | (r < IMG_BORDER) | (r >= hs - IMG_BORDER))
        keep = keep & ~(move & out)
        # park the rejected on a valid sample so later gathers stay in range
        bad = ~keep
        layer = torch.where(bad, torch.ones_like(layer), layer)
        r = torch.where(bad, torch.full_like(r, IMG_BORDER), r)
        c = torch.where(bad, torch.full_like(c, IMG_BORDER), c)
    keep = keep & done

    v, dD, hess = _derivatives(dog, o, layer, r, c)
    img_scale = float(_f32(1.0) / _f32(255.0))
    t = dD[0] * xc + dD[1] * xr + dD[2] * xi
    contr = v * img_scale + t * 0.5
    keep = keep & ~(contr.abs() * N_OCTAVE_LAYERS < float(_f32(CONTRAST_THRESHOLD)))
    dxx, dyy, _, dxy, _, _ = hess
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = float(_f32(EDGE_THRESHOLD))
    keep = keep & ~((det <= 0) | (tr * tr * e >= float(_f32((e + 1) * (e + 1))) * det))

    sel = keep.nonzero()[:, 0]
    o, layer, r, c = o[sel], layer[sel], r[sel], c[sel]
    xi, xr, xc, contr = xi[sel], xr[sel], xc[sel], contr[sel]
    octv = (2 ** o).to(torch.float32)
    pt = torch.stack([(c.to(torch.float32) + xc) * octv, (r.to(torch.float32) + xr) * octv], 1)
    word = o + (layer << 8) + (torch.round((xi.double() + 0.5) * 255).to(torch.int64) << 16)
    size = (torch.pow(2.0, (layer.to(torch.float32) + xi) / N_OCTAVE_LAYERS) * float(_f32(SIGMA))
            * octv * 2)
    return {"o": o, "layer": layer, "r": r, "c": c, "pt": pt, "size": size,
            "response": contr.abs(), "octave": word, "scl_octv": size * 0.5 / octv}


# --- 7. orientation --------------------------------------------------------------------

def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 in degrees, [0, 360]: OpenCV's 7th-order polynomial
    (within ~0.01 deg of atan2), in float32 in its order."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + _DBL_EPS_F32)
    c2 = c * c
    p1, p3, p5, p7 = _ATAN_P
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def gradient_maps(gpyr: list[torch.Tensor]) -> tuple[_Flat, _Flat]:
    """Magnitude and fastAtan2 angle of (I(r,c+1) - I(r,c-1),
    I(r-1,c) - I(r+1,c)) on layers 1..3 of each octave (0 on the border,
    where OpenCV takes no sample)."""
    mags, oris = [], []
    for g in gpyr:
        img = g[1:N_OCTAVE_LAYERS + 1]
        dx = torch.zeros_like(img)
        dy = torch.zeros_like(img)
        dx[:, 1:-1, 1:-1] = img[:, 1:-1, 2:] - img[:, 1:-1, :-2]
        dy[:, 1:-1, 1:-1] = img[:, :-2, 1:-1] - img[:, 2:, 1:-1]
        mags.append(_sqrt(dx * dx + dy * dy))
        oris.append(fast_atan2(dy, dx))
    return _Flat(mags), _Flat(oris)


def _window(radius: int, device):
    i, j = torch.meshgrid(torch.arange(-radius, radius + 1, device=device),
                          torch.arange(-radius, radius + 1, device=device), indexing="ij")
    return i.reshape(-1), j.reshape(-1)


def orientation_histograms(mag: _Flat, ori: _Flat, kp, chunk: int = 1024) -> torch.Tensor:
    """[M, 36] smoothed gradient-orientation histograms around the refined
    samples (OpenCV's calcOrientationHist): radius cvRound(4.5 scl),
    Gaussian weight sigma 1.5 scl, bins cvRound(ori / 10) mod 36."""
    dev = kp["o"].device
    n = ORI_HIST_BINS
    scl = kp["scl_octv"]
    radius = torch.round(scl * float(_f32(ORI_RADIUS))).to(torch.int64)
    sig = scl * float(_f32(ORI_SIG_FCTR))
    expf_scale = -1.0 / (sig * sig * 2.0)
    wi, wj = _window(MAX_ORI_RADIUS, dev)
    wr2 = (wi * wi + wj * wj).to(torch.float32)
    bins = torch.arange(n, device=dev)
    hists = []
    for s in range(0, len(scl), chunk):
        sl = slice(s, s + chunk)
        o, layer = kp["o"][sl, None], kp["layer"][sl, None] - 1
        y, x = kp["r"][sl, None] + wi, kp["c"][sl, None] + wj
        h, w = mag.h_t[o], mag.w_t[o]
        rad = radius[sl, None]
        valid = ((wi.abs() <= rad) & (wj.abs() <= rad) & (y > 0) & (y < h - 1)
                 & (x > 0) & (x < w - 1))
        idx = mag.index(o, layer, y.clamp(min=0), x.clamp(min=0))
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        weight = torch.exp(wr2 * expf_scale[sl, None])
        val = torch.where(valid, weight * mag.data[idx], torch.zeros((), device=dev))
        b = torch.round(ori.data[idx] * float(_f32(n) / _f32(360.0))).to(torch.int64)
        b = torch.where(b >= n, b - n, b)
        hists.append(((b[:, :, None] == bins) * val[:, :, None]).sum(1))
    t = torch.cat(hists) if hists else torch.zeros((0, n), device=dev)
    return ((t.roll(2, 1) + t.roll(-2, 1)) * (1.0 / 16.0)
            + (t.roll(1, 1) + t.roll(-1, 1)) * (4.0 / 16.0) + t * (6.0 / 16.0))


def orientations(mag: _Flat, ori: _Flat, kp) -> dict:
    """One keypoint per histogram peak: a local maximum >= 0.8 x the
    largest bin, its bin refined by a parabola, angle = 360 - 10 x bin (0
    for 360). Returns kp's fields repeated per peak, with `angle`."""
    n = ORI_HIST_BINS
    hist = orientation_histograms(mag, ori, kp)
    thr = hist.max(1, keepdim=True).values * float(_f32(ORI_PEAK_RATIO)) if len(hist) else hist
    left, right = hist.roll(1, 1), hist.roll(-1, 1)
    peak = (hist > left) & (hist > right) & (hist >= thr)
    j = torch.arange(n, device=hist.device, dtype=torch.float32)
    b = j + 0.5 * (left - right) / (left - 2 * hist + right)
    b = torch.where(b < 0, n + b, torch.where(b >= n, b - n, b))
    angle = 360.0 - float(_f32(360.0) / _f32(n)) * b
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON, torch.zeros_like(angle), angle)
    k, jj = peak.nonzero(as_tuple=True)
    out = {key: v[k] for key, v in kp.items()}
    out["angle"] = angle[k, jj]
    return out


# --- 8. filtering ---------------------------------------------------------------------

def filter_keypoints(kp: dict, n_features: int) -> dict:
    """KeyPointsFilter::removeDuplicatedSorted (sorted by x, y, size desc,
    angle, response desc, octave desc; equal x, y, size and angle dropped),
    retainBest(n_features) (every keypoint whose response reaches the
    n-th largest), then the first octave's scale back: pt and size x 0.5,
    octave byte - 1."""
    order = torch.arange(len(kp["size"]), device=kp["size"].device)
    for key, desc in (("octave", True), ("response", True), ("angle", False),
                      ("size", True), ("y", False), ("x", False)):
        v = kp["pt"][:, 1] if key == "y" else kp["pt"][:, 0] if key == "x" else kp[key]
        order = order[torch.sort(v[order], stable=True, descending=desc).indices]
    kp = {key: v[order] for key, v in kp.items()}
    if len(order) > 1:
        same = ((kp["pt"][1:] == kp["pt"][:-1]).all(1) & (kp["size"][1:] == kp["size"][:-1])
                & (kp["angle"][1:] == kp["angle"][:-1]))
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=same.device), ~same])
        kp = {key: v[first] for key, v in kp.items()}
    if n_features > 0 and len(kp["size"]) > n_features:
        boundary = torch.sort(kp["response"], descending=True).values[n_features - 1]
        best = kp["response"] >= boundary
        kp = {key: v[best] for key, v in kp.items()}
    kp = dict(kp)
    kp["pt"] = kp["pt"] * 0.5
    kp["size"] = kp["size"] * 0.5
    kp["octave"] = (kp["octave"] & ~255) | ((kp["octave"] + FIRST_OCTAVE) & 255)
    return kp


# --- 9. descriptors --------------------------------------------------------------------

def descriptors(mag: _Flat, ori: _Flat, kp: dict, samples: int = 1 << 21) -> torch.Tensor:
    """[N, 128] float32 (integers 0..255): OpenCV's calcSIFTDescriptor at
    each keypoint on its layer, 4 x 4 cells x 8 orientation bins, trilinear
    weights. Each chunk of keypoints (sorted by window radius, about
    `samples` window samples in all) sums its window as a product of the
    samples' (cell) and (bin) weights."""
    dev = kp["size"].device
    d, n = DESCR_WIDTH, DESCR_HIST_BINS
    octave = kp["octave"] & 255
    octave = torch.where(octave < 128, octave, octave - 256)
    layer = (kp["octave"] >> 8) & 255
    o = octave - FIRST_OCTAVE
    scale = torch.pow(2.0, -octave.to(torch.float32))
    scl = kp["size"] * scale * 0.5
    ptf = kp["pt"] * scale[:, None]
    ang = 360.0 - kp["angle"]
    ang = torch.where((ang - 360.0).abs() < FLT_EPSILON, torch.zeros_like(ang), ang)
    cos_t = torch.cos(ang * float(_f32(math.pi / 180)))
    sin_t = torch.sin(ang * float(_f32(math.pi / 180)))
    hist_width = scl * float(_f32(DESCR_SCL_FCTR))
    radius = torch.round(hist_width * float(_f32(1.4142135623730951)) * float(d + 1) * 0.5)
    h, w = mag.h_t[o], mag.w_t[o]
    diag = torch.sqrt((w * w + h * h).double()).to(torch.int64)
    radius = torch.minimum(radius.to(torch.int64), diag)
    cos_t, sin_t = cos_t / hist_width, sin_t / hist_width
    pt = torch.round(ptf).to(torch.int64)
    bins_per_rad = float(_f32(n) / _f32(360.0))

    order = torch.sort(radius, stable=True).indices
    rad_sorted = radius[order].cpu().numpy()
    out = torch.zeros((len(order), d * d * n), dtype=torch.float32, device=dev)
    s = 0
    while s < len(order):
        chunk = max(1, samples // (2 * int(rad_sorted[s]) + 1) ** 2)
        R = int(rad_sorted[min(s + chunk, len(order)) - 1])
        chunk = max(1, min(chunk, samples // (2 * R + 1) ** 2))
        R = int(rad_sorted[min(s + chunk, len(order)) - 1])
        sel = order[s:s + chunk]
        s += chunk
        wi, wj = _window(R, dev)
        ct, st = cos_t[sel, None], sin_t[sel, None]
        c_rot = wj * ct - wi * st
        r_rot = wj * st + wi * ct
        rbin = r_rot + d // 2 - 0.5
        cbin = c_rot + d // 2 - 0.5
        y, x = pt[sel, 1:2] + wi, pt[sel, 0:1] + wj
        hh, ww, rad = h[sel, None], w[sel, None], radius[sel, None]
        valid = ((wi.abs() <= rad) & (wj.abs() <= rad) & (rbin > -1) & (rbin < d)
                 & (cbin > -1) & (cbin < d) & (y > 0) & (y < hh - 1) & (x > 0) & (x < ww - 1))
        idx = mag.index(o[sel, None], layer[sel, None] - 1, y.clamp(min=0), x.clamp(min=0))
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        weight = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
        obin = (ori.data[idx] - ang[sel, None]) * bins_per_rad
        m = torch.where(valid, mag.data[idx] * weight, torch.zeros((), device=dev))
        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
        r0, c0, o0 = r0.to(torch.int64), c0.to(torch.int64), o0.to(torch.int64)
        o0 = torch.where(o0 < 0, o0 + n, torch.where(o0 >= n, o0 - n, o0))
        v_r1 = m * rbin
        v_r0 = m - v_r1
        v_rc11 = v_r1 * cbin
        v_rc01 = v_r0 * cbin
        cells, vals = [], []
        for dr, dc, v in ((0, 0, v_r0 - v_rc01), (0, 1, v_rc01), (1, 0, v_r1 - v_rc11),
                          (1, 1, v_rc11)):
            ci, cj = r0 + dr, c0 + dc
            inside = valid & (ci >= 0) & (ci < d) & (cj >= 0) & (cj < d)
            cells.append(torch.where(inside, ci * d + cj, torch.full_like(ci, d * d)))
            vals.append(v)
        rc = torch.zeros(cbin.shape + (d * d + 1,), dtype=torch.float32, device=dev)
        rc.scatter_(2, torch.stack(cells, 2), torch.stack(vals, 2))
        ob = torch.zeros(cbin.shape + (n,), dtype=torch.float32, device=dev)
        ob.scatter_(2, torch.stack([o0, (o0 + 1) % n], 2), torch.stack([1 - obin, obin], 2))
        with _fp32_matmul():
            hist = torch.bmm(rc.transpose(1, 2), ob)[:, :d * d]
        out[sel] = hist.reshape(len(sel), d * d * n)
    thr = _sqrt((out * out).sum(1, keepdim=True)) * float(_f32(DESCR_MAG_THR))
    out = torch.minimum(out, thr)
    nrm = float(INT_DESCR_FCTR) / torch.clamp(_sqrt((out * out).sum(1, keepdim=True)),
                                              min=FLT_EPSILON)
    return torch.round(out * nrm).clamp(0, 255)


# --- detect and compute, match -----------------------------------------------------------

def detect_and_compute(gray: torch.Tensor, n_features: int = 4096) -> dict:
    """[H, W] uint8 on any device -> keypoints and descriptors on that
    device, as cv2.SIFT_create(nfeatures=n_features).detectAndCompute:
    pt [N,2] (x, y), size, angle, response, octave (packed int) and desc
    [N,128] float32. The order is the duplicate filter's (x, y, ...), not
    OpenCV's, which is unspecified after retainBest."""
    base = initial_image(gray)
    gpyr = gaussian_pyramid(base, n_octaves_of(*base.shape))
    dog = _Flat(dog_pyramid(gpyr))
    mag, ori = gradient_maps(gpyr)
    del gpyr, base
    o, layer, r, c = scale_space_extrema(
        [dog.data[dog.offsets[i]:dog.offsets[i + 1]].view(s) for i, s in enumerate(dog.shapes)])
    kp = refine_extrema(dog, o, layer, r, c)
    del dog
    kp = orientations(mag, ori, kp)
    kp = filter_keypoints({k: kp[k] for k in ("pt", "size", "angle", "response", "octave")},
                          n_features)
    kp["desc"] = descriptors(mag, ori, kp)
    return kp


def mutual_nearest(dist: torch.Tensor):
    """(query, train) of every query whose nearest train (in the [N0, N1]
    distances) has it as its own nearest query, ties to the lowest index,
    in query order: BFMatcher's cross-check."""
    nearest_train = dist.argmin(1)
    nearest_query = dist.argmin(0)
    mutual = nearest_query[nearest_train] == torch.arange(len(dist), device=dist.device)
    q = mutual.nonzero()[:, 0]
    return q, nearest_train[q]


def cross_check_match(d0: torch.Tensor, d1: torch.Tensor):
    """BFMatcher(NORM_L2, crossCheck=True).match, sorted by distance as
    `sorted(..., key=distance)` sorts it: (query, train, distance) of every
    mutual nearest pair (`mutual_nearest`). The squared distances are
    integers < 2^24 (entries 0..255, 128 of them), exact in float64."""
    a, b = d0.double(), d1.double()
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    q, t = mutual_nearest(sq)
    dist = torch.sqrt(sq[q, t]).to(torch.float32)
    order = torch.sort(dist, stable=True).indices
    return q[order], t[order], dist[order]


def match_sift(gray0, gray1, n_features: int = 4096, device=None):
    """Grey images ([H, W] uint8, numpy or tensors) -> (uv0 [M,2], uv1
    [M,2], dist [M]) on `device` (default: gray0's, the CPU for numpy): the
    keypoint positions of the cross-checked SIFT matches, sorted by
    descriptor distance, as the JAX package's cv2 "sift" backend lists them
    before post-processing. Empty when either image has fewer than 4
    keypoints."""
    g0 = torch.as_tensor(gray0, device=device)
    g1 = torch.as_tensor(gray1, device=g0.device)
    k0 = detect_and_compute(g0, n_features)
    k1 = detect_and_compute(g1, n_features)
    if len(k0["size"]) < 4 or len(k1["size"]) < 4:
        empty = torch.zeros((0, 2), dtype=torch.float32, device=g0.device)
        return empty, empty.clone(), torch.zeros(0, dtype=torch.float32, device=g0.device)
    q, t, dist = cross_check_match(k0["desc"], k1["desc"])
    return k0["pt"][q], k1["pt"][t], dist
