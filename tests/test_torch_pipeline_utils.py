"""Port parity, SCORP utilities: scorp_tpu_torch's quaternion helpers,
geometry, SH rotation, Gaussian transforms, rotation bank, ICP, RANSAC,
9-DoF Adam, cv2-free view scoring, view selection and crop/restore (all on
the CPU) against scorp_tpu's on the same numpy inputs, and the view scoring
against cv2 itself."""

import os
import tempfile

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from scorp_tpu.core import quat as jquat
from scorp_tpu.pipeline import geometry as jgeo
from scorp_tpu.pipeline import graphic as jgraphic
from scorp_tpu.pipeline import gs_transform as jgst
from scorp_tpu.pipeline import icp as jicp
from scorp_tpu.pipeline import image_utils as jimg
from scorp_tpu.pipeline import sh_rotation as jsh
from scorp_tpu.pipeline import solvers as jsol
from scorp_tpu.pipeline import views as jviews
from scorp_tpu_torch.core import quat as tquat
from scorp_tpu_torch.core.plyio import GaussianData as TGaussianData
from scorp_tpu_torch.pipeline import geometry as tgeo
from scorp_tpu_torch.pipeline import graphic as tgraphic
from scorp_tpu_torch.pipeline import gs_transform as tgst
from scorp_tpu_torch.pipeline import icp as ticp
from scorp_tpu_torch.pipeline import image_utils as timg
from scorp_tpu_torch.pipeline import sh_rotation as tsh
from scorp_tpu_torch.pipeline import solvers as tsol
from scorp_tpu_torch.pipeline import views as tviews
from tests.synth import make_gt_gaussians

torch.set_num_threads(1)


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return np.asarray(jquat.quat_to_rotmat(jnp.asarray(q, jnp.float32)))


def branch_rotations(rng):
    """Rotations whose largest quaternion component is w, x, y and z in turn
    (every branch of rotmat_to_quat), plus random ones."""
    qs = [np.eye(4)[k] + 0.1 * rng.normal(size=4) for k in range(4)]
    qs += list(rng.normal(size=(12, 4)))
    return np.asarray(jquat.quat_to_rotmat(jnp.asarray(np.stack(qs), jnp.float32)))


# --- quaternions and geometry (tolerance 1e-6: f32 rounding) -----------------

def test_rotmat_to_quat_and_quat_multiply_match_jax():
    rng = np.random.default_rng(0)
    m = branch_rotations(rng)
    ref = np.asarray(jquat.rotmat_to_quat(jnp.asarray(m)))
    got = tquat.rotmat_to_quat(torch.as_tensor(np.array(m))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    a = rng.normal(size=(20, 4)).astype(np.float32)
    b = rng.normal(size=(20, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tquat.quat_multiply(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jquat.quat_multiply(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-6)


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4))
    np.testing.assert_allclose(tgeo.quaternion_to_matrix_np(q), jgeo.quaternion_to_matrix_np(q),
                               rtol=0, atol=1e-6)
    m = branch_rotations(rng)
    np.testing.assert_allclose(tgeo.matrix_to_quaternion_np(m), jgeo.matrix_to_quaternion_np(m),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_rotate_sh_matches_jax(deg):
    rng = np.random.default_rng(6 + deg)
    R = random_rotations(rng, 1)[0].astype(np.float64)
    sh = rng.normal(size=(5, (deg + 1) ** 2 - 1, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rotate_sh(sh, R), jsh.rotate_sh(sh, R), rtol=0, atol=1e-6)


def _both_gaussians(seed, sh_degree=3):
    rng = np.random.default_rng(seed)
    g = make_gt_gaussians(n=24, seed=seed, sh_degree=sh_degree)
    g.f_rest = rng.normal(0, 0.05, size=g.f_rest.shape).astype(np.float32)
    g.rotation = rng.normal(size=g.rotation.shape).astype(np.float32)
    t = TGaussianData(**{k: getattr(g, k).copy() for k in
                         ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")})
    return g, t


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("fix_center", [False, True])
def test_gs_transform_matches_jax(sh_degree, fix_center):
    rng = np.random.default_rng(10)
    g, t = _both_gaussians(11, sh_degree)
    R = random_rotations(rng, 1)[0].astype(np.float64)
    for mod, x in ((jgst, g), (tgst, t)):
        mod.gaussians_scale(x, [0.7, 1.2, 0.9], fix_center=fix_center)
        mod.gaussians_rotate(x, R, fix_center=fix_center)
        mod.gaussians_translate(x, np.array([0.3, -0.2, 0.5]))
    for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        np.testing.assert_allclose(getattr(t, k), getattr(g, k), rtol=0, atol=1e-6, err_msg=k)


# --- rotation bank: the same picks, so ICP starts from the same inits ----------

def _bank_picks(bank, candidates):
    """Each bank matrix's candidate: the nearest by max-abs difference."""
    d = np.abs(bank[:, None] - candidates[None]).reshape(len(bank), len(candidates), -1)
    return d.max(-1).argmin(1)


@pytest.mark.parametrize("n", [16, 32])
def test_rotation_bank_equals_jax(n):
    """The same candidates picked in the same order, the matrices within
    1e-6: the f32 matrices of torch and of XLA's CPU code (which depends
    on the host) may differ by 1-2 ulp, so bit-equality is not asked."""
    got = tgraphic.get_incremental_rotation_matrices(n, 1.0, 1.0)
    ref = jgraphic.get_incremental_rotation_matrices(n, 1.0, 1.0)
    rng = np.random.default_rng(2025)  # the banks' own candidate draw
    q = rng.normal(size=(n * 128, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    candidates = tquat.quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()
    picks = _bank_picks(ref, candidates)
    assert len(set(picks.tolist())) == n
    np.testing.assert_array_equal(_bank_picks(got, candidates), picks)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_rotation_bank_is_generated_and_cached():
    from scorp_tpu_torch.assets import load_rotation_bank

    with tempfile.TemporaryDirectory() as d:
        bank = load_rotation_bank(d, 8)
        assert os.path.exists(os.path.join(d, "rotations_8.npz"))
        np.testing.assert_array_equal(load_rotation_bank(d, 8), bank)
    assert bank.shape == (8, 3, 3)


# --- ICP (TestICP's rods; transforms within 1e-4) ------------------------------

@pytest.fixture(scope="module")
def rods():
    rng = np.random.default_rng(0)
    rods = [
        np.stack([np.linspace(0, 2.0, 200), np.zeros(200), np.zeros(200)], 1),
        np.stack([np.zeros(150), np.linspace(0, 1.2, 150), np.zeros(150)], 1),
        np.stack([np.zeros(100), np.zeros(100), np.linspace(0, 0.6, 100)], 1),
    ]
    target = (np.concatenate(rods) + rng.normal(0, 0.005, (450, 3))).astype(np.float32)
    q = rng.normal(size=4)
    R = np.asarray(jquat.quat_to_rotmat(jnp.asarray(q[None] / np.linalg.norm(q),
                                                    jnp.float32)))[0]
    t = np.array([0.4, -0.3, 0.6])
    source = ((target - t) @ R).astype(np.float32)
    bank = tgraphic.get_incremental_rotation_matrices(16, 1.0, 1.0)
    return target, source, bank


def test_best_icp_transform_matches_jax(rods):
    target, source, bank = rods
    ref = jicp.best_icp_transform(target, source, bank, threshold=0.2, max_iteration=200)
    got = ticp.best_icp_transform(target, source, bank, threshold=0.2, max_iteration=200,
                                  device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    aligned = source @ got[:3, :3].T + got[:3, 3]
    assert np.abs(aligned - target).mean() < 0.02  # TestICP's criterion


def test_registration_icp_matches_jax(rods):
    target, source, _ = rods
    init = np.eye(4)
    init[:3, 3] = target.mean(0) - source.mean(0)
    ref = jicp.registration_icp(source, target, 0.5, init=init, max_iteration=60)
    got = ticp.registration_icp(source, target, 0.5, init=init, max_iteration=60, device="cpu")
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(ref.transformation),
                               rtol=0, atol=1e-4)
    assert float(got.fitness) == pytest.approx(float(ref.fitness), abs=1e-3)
    assert float(got.inlier_rmse) == pytest.approx(float(ref.inlier_rmse), abs=1e-4)


def test_icp_nearest_search_is_f32_exact_on_cuda():
    """TF32 matmuls keep ~3 decimal digits: the distance matrix's cross term
    would change which target wins the argmin. The package turns TF32 off
    when it is imported; this fails if anything turns it back on."""
    import scorp_tpu_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


# --- RANSAC and 9-DoF Adam ------------------------------------------------------

def _similarity_pairs(seed, n=128, outliers=0.2):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, 3))
    R = random_rotations(rng, 1)[0].astype(np.float64)
    s, t = 1.3, np.array([0.5, -0.2, 0.9])
    Q = s * (P @ R.T) + t
    bad = rng.choice(n, int(outliers * n), replace=False)
    Q[bad] += rng.normal(size=(len(bad), 3)) * 5.0
    return P, Q, R, s, t, bad


def test_ransac_matches_jax():
    """Different random hypotheses (jax.random vs a torch.Generator), the
    same result on clean correspondences with 20% outliers: the best
    hypothesis's inlier mask equal, R, t, s within 1e-5."""
    P, Q, R, s, t, bad = _similarity_pairs(4)
    res_j = np.asarray(jsol._ransac_hypotheses(jnp.asarray(P, jnp.float32),
                                               jnp.asarray(Q, jnp.float32), 0, 2000)[0])
    res_t = tsol._ransac_hypotheses(torch.as_tensor(P, dtype=torch.float32),
                                    torch.as_tensor(Q, dtype=torch.float32), 0, 2000)[0]
    mask_j = (res_j < 0.05)[np.argmax((res_j < 0.05).sum(1))]
    inl_t = (res_t < 0.05).numpy()
    mask_t = inl_t[np.argmax(inl_t.sum(1))]
    np.testing.assert_array_equal(mask_t, mask_j)
    assert not mask_t[bad].any() and mask_t.sum() == len(P) - len(bad)
    ref = jsol.pc_align_ransac(P, Q, threshold=0.05, max_iterations=2000)
    got = tsol.pc_align_ransac(P, Q, threshold=0.05, max_iterations=2000, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], R, atol=1e-5)


def test_adam_9dof_matches_jax():
    """200 Adam steps: R, t, s within 1e-4 of the JAX package's (R2, the
    scale frame, is weakly determined while the scales are still near
    equal, and is not compared)."""
    rng = np.random.default_rng(5)
    P = rng.normal(size=(300, 3)).astype(np.float32)
    angle = 0.2
    R = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                  [0, 0, 1.0]])
    Q = (R @ (np.array([1.1, 0.9, 1.2]) * P).T).T + np.array([0.1, -0.2, 0.15])
    ref = jsol.adam_algorithm_3d3d_9dof(P, Q, iterations=200, lr=5e-3)
    got = tsol.adam_algorithm_3d3d_9dof(P, Q, iterations=200, lr=5e-3, device="cpu")
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_adam_9dof_nan_at_identity_matches_jax():
    """A fault of the reference, kept (ROADMAP section 3): where the path
    crosses the identity rotation, the regularizer's arccos gradient is
    0 x inf = NaN. The port gives the JAX package's result there."""
    rng = np.random.default_rng(0)
    P = rng.normal(size=(128, 3))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(0.5) * kx + (1 - np.cos(0.5)) * kx @ kx
    Q = 1.2 * P @ R.T + np.array([0.3, -0.2, 0.15])
    ref = jsol.adam_algorithm_3d3d_9dof(P, Q, iterations=100)
    got = tsol.adam_algorithm_3d3d_9dof(P, Q, iterations=100, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.isnan(got[0]).all()


@pytest.mark.parametrize("ninedof", [False, True])
def test_adam_3d2d_matches_jax(ninedof):
    rng = np.random.default_rng(7)
    P = rng.normal(size=(60, 3)).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 6.0
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    cam = P @ w2c[:3, :3].T + w2c[:3, 3]
    uv = ((cam @ K.T) / cam[:, 2:3])[:, :2]
    kw = dict(iterations=150, init_rotation=np.eye(3), init_translation=[0.05, 0.0, 0.0])
    name = "adam_algorithm_3d2d_9dof" if ninedof else "adam_algorithm_3d2d_7dof"
    ref = getattr(jsol, name)(P, uv, w2c, K, **kw)
    got = getattr(tsol, name)(P, uv, w2c, K, device="cpu", **kw)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)


# --- cv2-free view scoring: exactly equal to cv2's ------------------------------

def _mask(kind, rng):
    h, w = (int(v) for v in rng.integers(8, 48, 2))
    yy, xx = np.ogrid[:h, :w]
    if kind == "empty":
        return np.zeros((h, w), bool)
    if kind == "single_pixels":
        m = np.zeros((h, w), bool)
        m[rng.integers(0, h, 3), rng.integers(0, w, 3)] = True
        return m
    if kind == "thin_lines":
        m = np.zeros((h, w), bool)
        m[rng.integers(0, h), :] = True
        m[:, rng.integers(0, w)] = True
        m[np.arange(min(h, w)), np.arange(min(h, w))] = True
        return m
    if kind == "blobs_with_holes":
        # disks with holes, islands inside the holes, speckle
        m = np.zeros((h, w), bool)
        for _ in range(3):
            cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 12)
            d = (yy - cy) ** 2 + (xx - cx) ** 2
            m |= d <= r * r
            m &= ~(d <= (r // 2) ** 2)
            m |= d <= (r // 5) ** 2
        return m | (rng.uniform(size=(h, w)) < 0.03)
    return ndimage.binary_opening(rng.uniform(size=(h, w)) < 0.55)  # "noise"


def _cv2_shape_quality(alpha):
    contours, _ = cv2.findContours((alpha == 255).astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return 0.0
    area = sum(cv2.contourArea(c) for c in contours)
    hull = cv2.contourArea(cv2.convexHull(np.vstack(contours)))
    return 0.0 if hull == 0 else area / hull


@pytest.mark.parametrize("kind", ["empty", "single_pixels", "thin_lines",
                                  "blobs_with_holes", "noise"])
def test_mask_shape_quality_equals_cv2(kind):
    rng = np.random.default_rng(["empty", "single_pixels", "thin_lines",
                                 "blobs_with_holes", "noise"].index(kind))
    for _ in range(40):
        m = _mask(kind, rng)
        alpha = np.where(m, 255, rng.integers(0, 255, m.shape)).astype(np.uint8)
        got = tviews.evaluate_mask_shape_quality(alpha)
        assert got == jviews.evaluate_mask_shape_quality(alpha) == _cv2_shape_quality(alpha)


def test_external_contours_match_cv2_areas():
    """Each traced outer border has cv2's area, and there are as many."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        m = _mask("blobs_with_holes", rng)
        ref, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        got = tviews.external_contours(m)
        assert sorted(cv2.contourArea(c) for c in ref) == sorted(
            tviews._shoelace_area(c) for c in got)


def test_image_quality_equals_cv2():
    rng = np.random.default_rng(4)
    for _ in range(20):
        h, w = rng.integers(1, 60, 2)
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        img[..., 3] = np.where(rng.uniform(size=(h, w)) < 0.5, 255, img[..., 3])
        gray = cv2.cvtColor(img, cv2.COLOR_RGBA2GRAY)
        np.testing.assert_array_equal(tviews.rgba_to_gray(img), gray)
        np.testing.assert_array_equal(tviews.laplacian(gray), cv2.Laplacian(gray, cv2.CV_64F))
        assert tviews.calculate_image_quality(img) == jviews.calculate_image_quality(img)


def test_select_views_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    names = [f"v{i}" for i in range(7)]
    yy, xx = np.ogrid[:40, :50]
    for i, name in enumerate(names):
        img = rng.integers(0, 256, (40, 50, 4)).astype(np.uint8)
        r = 4 + 2 * i
        img[..., 3] = np.where((yy - 20) ** 2 + (xx - 25) ** 2 < r * r, 255, 0)
        Image.fromarray(img).save(tmp_path / f"{name}.png")
    r_w2c = random_rotations(rng, len(names)).astype(np.float64)
    t_w2c = rng.normal(size=(len(names), 3))
    ref_idx, ref_imgs = jviews.select_views(str(tmp_path), names, 3, t_w2c, r_w2c)
    got_idx, got_imgs = tviews.select_views(str(tmp_path), names, 3, t_w2c, r_w2c)
    assert got_idx == ref_idx and len(got_idx) == 3
    for a, b in zip(got_imgs, ref_imgs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tviews.post_process_rgba_imgs(got_imgs),
                    jviews.post_process_rgba_imgs(ref_imgs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_crop_with_alpha_and_restore_coords_match_jax():
    rng = np.random.default_rng(13)
    rgb = rng.uniform(size=(3, 100, 120)).astype(np.float32)
    depth = rng.uniform(size=(1, 100, 120)).astype(np.float32)
    alpha = np.zeros((1, 100, 120), np.float32)
    alpha[0, 40:60, 50:80] = 1.0
    for border, dfactor in ((16, 8), (200, 8), (0, 16), (-1, 8)):
        ref = jimg.crop_with_alpha(rgb, alpha, depth, border=border, dfactor=dfactor)
        got = timg.crop_with_alpha(rgb, alpha, depth, border=border, dfactor=dfactor)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
        pts = rng.integers(0, 50, (10, 2))
        np.testing.assert_array_equal(timg.restore_coords(pts, got[2]),
                                      jimg.restore_coords(pts, ref[2]))
