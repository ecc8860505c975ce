"""Port parity, ORB matching: scorp_tpu_torch.pipeline.orb (PyTorch, no cv2)
against OpenCV, whose ORB the JAX package's "orb" backend calls. Each stage
is held against cv2's own primitive (resize, FAST, the blur, the rBRIEF
table by impulse probes, ORB.compute), the keypoints and descriptors against
`cv2.ORB_create(nfeatures=4096).detectAndCompute`, the cross-check against
`cv2.BFMatcher(NORM_HAMMING, crossCheck=True)`, and the matcher against
`scorp_tpu.pipeline.matching.CV2Matcher("orb")`. Where a level's retainBest
bites, OpenCV's keypoint order is that of its nth_element, so keypoints are
compared as sets there. All on the CPU, on inputs made from
numpy.random.default_rng(seed)."""

import re

import cv2
import numpy as np
import pytest
import torch

from scorp_tpu.pipeline import matching as jmatching
from scorp_tpu_torch.pipeline import matching as tmatching
from scorp_tpu_torch.pipeline import orb
from scorp_tpu_torch.pipeline.orb_pattern import PATTERN_31
from tests.test_torch_sift import _rgb, high_contrast, smooth_texture

torch.set_num_threads(2)

IMAGES = {
    # no level reaches its cap (150 / 212 / 228 / 191 / 143 / 86 / 27 / 4)
    "texture": lambda: smooth_texture(240, 320, 0),
    # every level reaches its cap (the size of the alignment's crops)
    "texture_824": lambda: smooth_texture(568, 824, 1),
    "high_contrast": lambda: high_contrast(480, 640, 1),
}


def cv2_keypoints(kps):
    """(octave, x, y, angle, response, size) per keypoint, as float32."""
    return [tuple(np.float32(v) for v in (k.octave, k.pt[0], k.pt[1], k.angle, k.response,
                                           k.size)) for k in kps]


def port_keypoints(k):
    cols = [k["octave"].numpy(), k["pt"][:, 0].numpy(), k["pt"][:, 1].numpy(),
            k["angle"].numpy(), k["response"].numpy(), k["size"].numpy()]
    return [tuple(np.float32(c[i]) for c in cols) for i in range(len(cols[0]))]


# --- stages against cv2's primitives ----------------------------------------------------

def test_levels_and_caps_match_cv2():
    """ORB_create(nfeatures=4096)'s per-level caps and sizes."""
    assert orb.features_per_level() == [890, 741, 618, 515, 429, 357, 298, 248]
    assert orb.level_sizes(568, 824)[1] == (473, 687)


@pytest.mark.parametrize("name", ["texture", "texture_824"])
def test_pyramid_bit_equal_to_cv2_resize(name):
    """Each level bit-equal to cv2.resize(INTER_LINEAR_EXACT) of the one
    before."""
    img = IMAGES[name]()
    levels = orb.pyramid(torch.from_numpy(img))
    prev = img
    for level, (rows, cols) in enumerate(orb.level_sizes(*img.shape)[1:], 1):
        prev = cv2.resize(prev, (cols, rows), interpolation=cv2.INTER_LINEAR_EXACT)
        np.testing.assert_array_equal(levels[level].numpy(), prev)


@pytest.mark.parametrize("name", ["texture", "texture_824", "high_contrast"])
def test_fast_bit_equal_to_cv2(name):
    """Corners, scores and their (raster) order equal
    FastFeatureDetector_create(20, True)'s on the full-size level."""
    img = IMAGES[name]()
    kps = cv2.FastFeatureDetector_create(20, True).detect(img, None)
    s = orb.fast_scores(torch.from_numpy(img)).numpy()
    ys, xs = np.nonzero(s)
    assert len(kps) > 200
    assert [(int(k.pt[1]), int(k.pt[0]), k.response) for k in kps] == [
        (y, x, float(s[y, x])) for y, x in zip(ys, xs)]


def test_blur_matches_cv2_gaussian_blur():
    """`blur7` is ORB's blur of a level: OpenCV blurs the level inside its
    pyramid buffer (a sub-image), which cv2's IPP build computes in float32
    (bit-equal through ORB.compute, see the descriptor tests). A stand-alone
    cv2.GaussianBlur(img, (7, 7), 2, 2, BORDER_REFLECT_101) of a whole 8-bit
    image takes OpenCV's fixed-point path instead (taps 18, 34, 48, 56 /
    256), which Python cannot send a sub-image to: held within +-1 there,
    on <= 25% of the pixels (measured: at most 1, on 1.4%, 15.0% and 19.7%
    of the three images' pixels)."""
    for img in (smooth_texture(240, 320, 0), high_contrast(480, 640, 1),
                np.random.default_rng(0).integers(0, 256, (300, 401)).astype(np.uint8)):
        ref = cv2.GaussianBlur(img, (7, 7), 2, 2, borderType=cv2.BORDER_REFLECT_101)
        diff = np.abs(orb.blur7(torch.from_numpy(img)).numpy().astype(int) - ref)
        print(f"{img.shape}: max |diff| {diff.max()}, share differing {np.mean(diff > 0):.4f}")
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.25


def test_pattern_reproduces_impulse_probes():
    """A sample of the probes the table was read with: a bright or a dark
    pixel at an offset within 17 px of a level-0 keypoint at angle 0 on a
    flat grey image flips exactly the bits whose point pairs the table and
    the blur predict (ORB.compute's bits against blur7's comparisons)."""
    rng = np.random.default_rng(3)
    offsets = rng.integers(-17, 18, (150, 2))
    probes = [(q, v) for v in (255, 0) for q in offsets]
    g, step = int(np.ceil(np.sqrt(len(probes)))), 44
    img = np.full((64 + step * g, 64 + step * g), 128, np.uint8)
    centres = []
    for k, ((qx, qy), v) in enumerate(probes):
        cx, cy = 40 + step * (k % g), 40 + step * (k // g)
        img[cy + qy, cx + qx] = v
        centres.append((cx, cy))
    kps = [cv2.KeyPoint(float(x), float(y), 31, 0.0, 0, 0) for x, y in centres]
    _, des = cv2.ORB_create(nfeatures=4096).compute(img, kps)
    bits = np.unpackbits(des, axis=1, bitorder="little")
    blurred = orb.blur7(torch.from_numpy(img)).numpy().astype(int)
    c = np.array(centres)
    p = PATTERN_31
    v1 = blurred[c[:, 1:2] + p[:, 1], c[:, 0:1] + p[:, 0]]
    v2 = blurred[c[:, 1:2] + p[:, 3], c[:, 0:1] + p[:, 2]]
    assert bits.sum() > 5 * len(probes)  # measured: 2993 flipped bits of 300 probes
    np.testing.assert_array_equal(bits, (v1 < v2).astype(np.uint8))


@pytest.mark.parametrize("angles", ["zero", "random", "axes"])
def test_descriptors_of_given_keypoints_bit_equal(angles):
    """`orb.compute` on given level-0 keypoints equals ORB.compute's
    descriptors, at angle 0, at random angles and near the axes."""
    rng = np.random.default_rng(11)
    img = cv2.GaussianBlur(rng.integers(0, 256, (200, 240)).astype(np.uint8), (0, 0), 1.2)
    pts = np.array([(x, y) for y in range(40, 160, 3) for x in range(40, 200, 3)])
    ang = {"zero": np.zeros(len(pts)),
           "random": rng.uniform(0, 360, len(pts)),
           "axes": rng.choice([0.0, 45.0, 90.0, 180.0, 270.0, 359.99, 0.01], len(pts))}[angles]
    ang = ang.astype(np.float32)
    kps = [cv2.KeyPoint(float(x), float(y), 31, float(a), 0, 0) for (x, y), a in zip(pts, ang)]
    kept, des = cv2.ORB_create(nfeatures=4096).compute(img, kps)
    assert len(kept) == len(pts)
    got = orb.compute(torch.from_numpy(img), torch.from_numpy(pts.astype(np.float32)),
                      torch.from_numpy(ang))
    assert got.dtype == torch.uint8 and got.shape == (len(pts), 32)
    np.testing.assert_array_equal(got.numpy(), des)


# --- detect and compute -----------------------------------------------------------------

def test_detect_and_compute_bit_equal_where_no_cap_bites():
    """Keypoints in cv2's order with pt, angle, response, octave and size
    bit-equal, and descriptors bit-equal."""
    img = IMAGES["texture"]()
    kps, des = cv2.ORB_create(nfeatures=4096).detectAndCompute(img, None)
    port = orb.detect_and_compute(torch.from_numpy(img))
    counts = np.bincount([k.octave for k in kps], minlength=8)
    assert (counts < orb.features_per_level()).all() and len(kps) > 500
    assert port_keypoints(port) == cv2_keypoints(kps)
    np.testing.assert_array_equal(port["desc"].numpy(), des)


@pytest.mark.parametrize("name", ["texture_824", "high_contrast"])
def test_detect_and_compute_sets_equal_where_caps_bite(name):
    """The keypoint sets equal (every field bit-equal) and the descriptors
    of paired keypoints bit-equal."""
    img = IMAGES[name]()
    kps, des = cv2.ORB_create(nfeatures=4096).detectAndCompute(img, None)
    port = orb.detect_and_compute(torch.from_numpy(img))
    assert len(kps) == 4096
    ref, got = cv2_keypoints(kps), port_keypoints(port)
    assert sorted(ref) == sorted(got)
    index = {k: i for i, k in enumerate(ref)}
    assert len(index) == len(ref)
    pair = np.array([index[k] for k in got])
    np.testing.assert_array_equal(port["desc"].numpy(), des[pair])


# --- matching ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 6])
def test_cross_check_hamming_equals_bfmatcher(seed):
    """On tie-heavy packed descriptors (each byte 0..3), the same (query,
    train, distance) list as BFMatcher(NORM_HAMMING, crossCheck=True) sorted
    by distance."""
    rng = np.random.default_rng(seed)
    d0 = rng.integers(0, 4, (300, 32)).astype(np.uint8)
    d1 = np.concatenate([d0[rng.permutation(300)[:150]], rng.integers(0, 4, (200, 32))])
    d1 = d1.astype(np.uint8)
    d1[:20] = d1[20:40]  # exact duplicates: ties to the lowest index
    ms = sorted(cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(d0, d1),
                key=lambda m: m.distance)
    q, t, dist = orb.cross_check_match_hamming(torch.from_numpy(d0), torch.from_numpy(d1))
    assert q.tolist() == [m.queryIdx for m in ms]
    assert t.tolist() == [m.trainIdx for m in ms]
    np.testing.assert_array_equal(dist.numpy(), np.float32([m.distance for m in ms]))


@pytest.mark.parametrize("n_points", [16, 100])
def test_orb_matcher_picks_equal_jax_cv2_matcher(n_points):
    """A texture against its circularly shifted copy, no cap biting: the
    same picks as the JAX package's CV2Matcher("orb")."""
    img = IMAGES["texture"]()
    shifted = np.roll(img, (4, 6), axis=(0, 1))
    ref = jmatching.CV2Matcher("orb")(_rgb(img), _rgb(shifted), n_points_per_cam=n_points)
    got = tmatching.ORBMatcher(device="cpu")(_rgb(img), _rgb(shifted),
                                             n_points_per_cam=n_points)
    assert len(ref[0]) == n_points
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_matches_match_cv2_matcher_where_caps_bite(monkeypatch):
    """The 824x568 texture against its cv2.warpAffine copy (10 deg, scale
    0.9): >= 90% of the JAX package's cv2 pairs (before post-processing)
    present, both ends within 0.5 px, and the share of pairs the known
    affine maps within 2 px within 0.05 of cv2's."""
    img = IMAGES["texture_824"]()
    A = cv2.getRotationMatrix2D((412, 284), 10, 0.9)
    warped = cv2.warpAffine(img, A, (824, 568), borderMode=cv2.BORDER_REFLECT_101)
    seen = {}

    def record(uv0, uv1, *a):
        seen["uv"] = (uv0, uv1)
        return uv0.astype(int), uv1.astype(int)

    def inliers(a, b):
        return np.mean(np.linalg.norm(a @ A[:, :2].T + A[:, 2] - b, axis=1) <= 2.0)

    monkeypatch.setattr(jmatching, "_postprocess", record)
    jmatching.CV2Matcher("orb")(_rgb(img), _rgb(warped))
    ref0, ref1 = seen["uv"]
    uv0, uv1, dist = orb.match_orb(img, warped)
    uv0, uv1 = uv0.numpy().astype(np.float64), uv1.numpy().astype(np.float64)
    assert torch.equal(dist, torch.sort(dist).values)
    assert len(ref0) >= 200
    d = (np.linalg.norm(ref0[:, None] - uv0[None], axis=2) <= 0.5) & (
        np.linalg.norm(ref1[:, None] - uv1[None], axis=2) <= 0.5)
    shared = d.any(1).mean()
    print(f"cv2 {len(ref0)} pairs, port {len(uv0)}, shared {shared:.4f}; inlier share "
          f"port {inliers(uv0, uv1):.4f}, cv2 {inliers(ref0, ref1):.4f}")
    assert shared >= 0.90, shared
    assert abs(inliers(uv0, uv1) - inliers(ref0, ref1)) <= 0.05


def test_orb_modules_import_no_cv2_jax_or_reference():
    """pipeline/orb.py, orb_pattern.py and matching.py import no cv2, no jax
    and nothing of scorp_tpu."""
    import importlib

    for name in ("orb", "orb_pattern", "matching"):
        mod = importlib.import_module(f"scorp_tpu_torch.pipeline.{name}")
        with open(mod.__file__) as f:
            src = f.read()
        imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M)
        assert not [m for m in imports if m.split(".")[0] in ("cv2", "jax", "scorp_tpu")], (
            name, imports)
