"""Port parity, SIFT matching: scorp_tpu_torch.pipeline.sift (PyTorch, no
cv2) against OpenCV, whose SIFT the JAX package's "sift" backend calls. Each
stage is held against cv2's own primitive (Gaussian kernel, blur, resize,
fastAtan2), the keypoints and descriptors against
`cv2.SIFT_create(nfeatures=4096)`, and the matches against
`scorp_tpu.pipeline.matching.CV2Matcher("sift")` before its
post-processing. Keypoint order after retainBest is unspecified in OpenCV,
so keypoints and matches are compared as sets. All on the CPU, on inputs
made from numpy.random.default_rng(seed)."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage
from scipy.spatial import cKDTree

from scorp_tpu.pipeline import matching as jmatching
from scorp_tpu_torch.pipeline import matching as tmatching
from scorp_tpu_torch.pipeline import sift
from tests.synth import build_dataset

torch.set_num_threads(2)


def smooth_texture(h, w, seed, sigma=3.0):
    a = ndimage.gaussian_filter(np.random.default_rng(seed).uniform(0, 255, (h, w)), sigma)
    return ((a - a.min()) / (a.max() - a.min()) * 255).astype(np.uint8)


def high_contrast(h, w, seed):
    a = ndimage.gaussian_filter(np.random.default_rng(seed).uniform(0, 1, (h, w)), 1.5)
    return ((a > np.median(a)) * 200 + 30).astype(np.uint8)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Lists of grey images: a smoothed-noise texture, the 8 views of
    tests/synth.py's scene at 320x240 (smooth blobs: 9-23 keypoints each),
    and a high-contrast texture with more than 4096 keypoints."""
    root = str(tmp_path_factory.mktemp("sift_scene"))
    build_dataset(root, n_views=8, width=320, height=240)
    renders = []
    for i in range(8):
        with Image.open(os.path.join(root, "images", f"img_{i:03d}.png")) as im:
            renders.append(sift.to_gray(im))
    return {"texture": [smooth_texture(240, 320, 0)], "synth_render": renders,
            "high_contrast": [high_contrast(480, 640, 1)]}


# --- stages against cv2's primitives ----------------------------------------------------

@pytest.mark.parametrize("sigma", [0.8, 1.0, 1.2489996, 1.2262735, 1.5450561, 1.9465877,
                                   2.452547, 3.0900155, 5.3])
def test_gaussian_kernel_bit_equal_to_cv2(sigma):
    k = sift.gaussian_ksize(sigma)
    np.testing.assert_array_equal(sift.gaussian_kernel(k, sigma),
                                  cv2.getGaussianKernel(k, sigma, cv2.CV_32F)[:, 0])


@pytest.mark.parametrize("shape", [(240, 320), (7, 12)])
def test_blur_and_upscale_match_cv2(shape):
    """Within 1e-3 on the 0..255 scale (measured: 4.6e-5)."""
    img = ndimage.gaussian_filter(np.random.default_rng(3).uniform(0, 255, shape), 2)
    img = img.astype(np.float32)
    t = torch.from_numpy(img)
    for s in sift.layer_sigmas()[1:] + [1.2489996]:
        err = np.abs(sift.blur(t, s).numpy() - cv2.GaussianBlur(img, (0, 0), s)).max()
        print(f"blur sigma {s:.4f}: max |diff| {err:.3g}")
        assert err <= 1e-3, (s, err)
    up = cv2.resize(img, (2 * shape[1], 2 * shape[0]), interpolation=cv2.INTER_LINEAR)
    err = np.abs(sift.upscale2x(t).numpy() - up).max()
    print(f"upscale: max |diff| {err:.3g}")
    assert err <= 1e-3


def test_fast_atan2_matches_cv2():
    """On a grid over all quadrants, axes and the diagonals: within 1e-4 deg
    (measured: equal)."""
    v = np.concatenate([-np.logspace(-3, 2, 40), [0.0], np.logspace(-3, 2, 40)])
    v = v.astype(np.float32)
    y, x = (a.ravel() for a in np.meshgrid(v, v, indexing="ij"))
    ref = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)], np.float32)
    got = sift.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    print(f"fastAtan2: max |diff| {np.abs(got - ref).max():.3g} deg")
    assert np.abs(got - ref).max() <= 1e-4


# --- keypoints and descriptors against detectAndCompute ----------------------------------

def pair_keypoints(kps, port):
    """cv2 keypoint index -> port index, pairing each cv2 keypoint with an
    unused port keypoint of the same octave word, pt within 0.01 px, size
    within 1e-3 relative, angle within 0.1 deg and response within 1e-3
    relative."""
    pt = port["pt"].numpy()
    tree = cKDTree(pt)
    used, pairs = set(), {}
    for i, k in enumerate(kps):
        for j in tree.query_ball_point(k.pt, 0.01):
            da = abs(float(port["angle"][j]) - k.angle)
            if (j not in used and int(port["octave"][j]) == k.octave
                    and abs(float(port["size"][j]) - k.size) <= 1e-3 * k.size
                    and min(da, 360 - da) <= 0.1
                    and abs(float(port["response"][j]) - k.response) <= 1e-3 * k.response):
                used.add(j)
                pairs[i] = j
                break
    return pairs


@pytest.mark.parametrize("name", ["texture", "synth_render", "high_contrast"])
def test_keypoints_and_descriptors_match_cv2(images, name):
    """>= 95% of cv2's keypoints paired, <= 5% extra; on the paired, >= 95%
    of descriptors with every entry within +-1 and a mean |diff| <= 0.05
    (measured: texture 632 of 634 paired, synth_render all, high_contrast
    4096 of 4096; every descriptor within +-1). The synth views are
    counted together."""
    n_cv2 = n_port = 0
    diffs = []
    for gray in images[name]:
        kps, des = cv2.SIFT_create(nfeatures=4096).detectAndCompute(gray, None)
        port = sift.detect_and_compute(torch.from_numpy(gray))
        if name == "high_contrast":  # retainBest bites
            assert len(cv2.SIFT_create(nfeatures=0).detect(gray, None)) > 4096
            assert len(kps) == 4096
        pairs = pair_keypoints(kps, port)
        n_cv2, n_port = n_cv2 + len(kps), n_port + len(port["size"])
        i, j = np.array(list(pairs.keys()), int), np.array(list(pairs.values()), int)
        diffs.append(np.abs(port["desc"].numpy()[j] - des[i]))
        assert port["desc"].dtype == torch.float32
        assert torch.equal(port["desc"], port["desc"].round().clamp(0, 255))
    diff = np.concatenate(diffs)
    print(f"{name}: cv2 {n_cv2} keypoints, port {n_port}, paired {len(diff)}; descriptors "
          f"within +-1 {np.mean(diff.max(1) <= 1):.4f}, mean |diff| {diff.mean():.6f}")
    assert n_cv2 >= 100
    assert len(diff) >= 0.95 * n_cv2, (len(diff), n_cv2)
    assert n_port - len(diff) <= 0.05 * n_cv2, (n_port, len(diff))
    assert np.mean(diff.max(1) <= 1) >= 0.95
    assert diff.mean() <= 0.05, diff.mean()


# --- matches ----------------------------------------------------------------------------

def test_cross_check_match_equals_bfmatcher():
    """On integer descriptors with many equal distances, the same (query,
    train, distance) list as BFMatcher(NORM_L2, crossCheck=True) sorted by
    distance."""
    rng = np.random.default_rng(5)
    d0 = rng.integers(0, 4, (300, 128)).astype(np.float32)
    d1 = np.concatenate([d0[rng.permutation(300)[:150]], rng.integers(0, 4, (200, 128))])
    d1 = d1.astype(np.float32)
    d1[:20] = d1[20:40]  # exact duplicates: ties to the lowest index
    ms = sorted(cv2.BFMatcher(cv2.NORM_L2, crossCheck=True).match(d0, d1),
                key=lambda m: m.distance)
    q, t, dist = sift.cross_check_match(torch.from_numpy(d0), torch.from_numpy(d1))
    assert q.tolist() == [m.queryIdx for m in ms]
    assert t.tolist() == [m.trainIdx for m in ms]
    np.testing.assert_array_equal(dist.numpy(), np.float32([m.distance for m in ms]))


def _rgb(gray):
    return Image.fromarray(np.dstack([gray] * 3))


def test_matches_match_cv2_matcher(monkeypatch):
    """A texture against its cv2.warpAffine copy (15 deg, scale 0.8):
    >= 90% of the JAX package's cv2 pairs (before post-processing) present,
    both ends within 0.5 px, and the share of pairs the known affine maps
    within 2 px within 0.05 of cv2's."""
    img = smooth_texture(240, 320, 7, sigma=2.0)
    A = cv2.getRotationMatrix2D((160, 120), 15, 0.8)
    warped = cv2.warpAffine(img, A, (320, 240), borderMode=cv2.BORDER_REFLECT_101)
    seen = {}

    def record(uv0, uv1, *a):
        seen["uv"] = (uv0, uv1)
        return uv0.astype(int), uv1.astype(int)

    def inliers(a, b):
        return np.mean(np.linalg.norm(a @ A[:, :2].T + A[:, 2] - b, axis=1) <= 2.0)

    monkeypatch.setattr(jmatching, "_postprocess", record)
    jmatching.CV2Matcher("sift")(_rgb(img), _rgb(warped))
    ref0, ref1 = seen["uv"]
    uv0, uv1, dist = sift.match_sift(img, warped)
    uv0, uv1 = uv0.numpy().astype(np.float64), uv1.numpy().astype(np.float64)
    assert torch.equal(dist, torch.sort(dist).values)
    assert len(ref0) >= 50
    d = (np.linalg.norm(ref0[:, None] - uv0[None], axis=2) <= 0.5) & (
        np.linalg.norm(ref1[:, None] - uv1[None], axis=2) <= 0.5)
    shared = d.any(1).mean()
    print(f"cv2 {len(ref0)} pairs, port {len(uv0)}, shared {shared:.4f}; inlier share "
          f"port {inliers(uv0, uv1):.4f}, cv2 {inliers(ref0, ref1):.4f}")
    assert shared >= 0.90, shared

    assert abs(inliers(uv0, uv1) - inliers(ref0, ref1)) <= 0.05


def test_sift_matcher_runs_without_cv2(monkeypatch, tmp_path):
    """get_matcher("sift") and "auto" (no MASt3R checkpoint) give the
    SIFTMatcher on the asked device and match with cv2 unimportable; so
    does "orb" with the ORBMatcher."""
    img = smooth_texture(120, 160, 11, sigma=2.0)
    shifted = np.roll(img, (4, 6), axis=(0, 1))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.chdir(tmp_path)
    for backend in ("sift", "auto"):
        m = tmatching.get_matcher(backend, device="cpu")
        assert isinstance(m, tmatching.SIFTMatcher) and m.device == torch.device("cpu")
    uv0, uv1 = m(_rgb(img), _rgb(shifted), n_points_per_cam=16)
    assert uv0.shape == uv1.shape and 0 < len(uv0) <= 16
    assert np.issubdtype(uv0.dtype, np.integer)
    # a circular shift: most pairs are displaced by (6, 4) px
    assert np.mean(np.abs(uv1 - uv0 - [6, 4]).max(1) <= 1) >= 0.8
    m = tmatching.get_matcher("orb", device="cpu")
    assert isinstance(m, tmatching.ORBMatcher) and m.device == torch.device("cpu")
    uv0, uv1 = m(_rgb(img), _rgb(shifted), n_points_per_cam=16)
    assert uv0.shape == uv1.shape and 0 < len(uv0) <= 16
    assert np.issubdtype(uv0.dtype, np.integer)
    assert np.mean(np.abs(uv1 - uv0 - [6, 4]).max(1) <= 1) >= 0.8


def test_sift_matcher_picks_equal_jax_on_synth_views(images):
    """SIFTMatcher's picks equal the JAX package's CV2Matcher("sift")'s on
    tests/synth.py's 8 views at 320x240, view i against view i + 1 (the
    last against the first), n_points_per_cam=16."""
    views = [_rgb(g) for g in images["synth_render"]]
    ours = tmatching.SIFTMatcher(device="cpu")
    theirs = jmatching.CV2Matcher("sift")
    for i in range(len(views)):
        j = (i + 1) % len(views)
        ref = theirs(views[i], views[j], n_points_per_cam=16)
        got = ours(views[i], views[j], n_points_per_cam=16)
        assert len(ref[0]) >= 4
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"views {i}, {j}")
