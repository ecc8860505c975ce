"""Port parity, the auxiliary modules: MiniCam and the novel-view paths,
image export, LPIPS and its proxy, the metrics app, the offline 2D
segmentation (no cv2), image_ops, the network viewer, random_patch_loss and
safe_state, each on the CPU against scorp_tpu's function on the same numpy
inputs."""

import json
import os
import shutil
import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from scorp_tpu.apps import metrics as jmetrics
from scorp_tpu.core.plyio import GaussianData as JaxGaussianData
from scorp_tpu.apps import segmentation_2d as jseg
from scorp_tpu.ops import image_ops as jops
from scorp_tpu.ops import losses as jlosses
from scorp_tpu.ops import perceptual as jperc
from scorp_tpu.pipeline import perception as jperception
from scorp_tpu.pipeline import render_paths as jpaths
from scorp_tpu.render import render as j_render
from scorp_tpu.scene.cameras import Camera as JaxCamera
from scorp_tpu.viewer import network_gui as jgui
from scorp_tpu_torch.apps import metrics as tmetrics
from scorp_tpu_torch.apps import segmentation_2d as tseg
from scorp_tpu_torch.core.plyio import GaussianData
from scorp_tpu_torch.ops import image_ops as tops
from scorp_tpu_torch.ops import losses as tlosses
from scorp_tpu_torch.ops import perceptual as tperc
from scorp_tpu_torch.pipeline import perception as tperception
from scorp_tpu_torch.pipeline import render_paths as tpaths
from scorp_tpu_torch.render import render
from scorp_tpu_torch.scene import MiniCam
from scorp_tpu_torch.scene.cameras import Camera as TorchCamera
from scorp_tpu_torch.utils.safe_state import safe_state
from scorp_tpu_torch.viewer import network_gui as tgui
from tests.synth import build_dataset, orbit_pose
from tests import test_aux as jaux
from tests.test_raster import make_scene

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


# --- MiniCam and the novel-view paths -------------------------------------


def _cams(cls, n=10, height=0.0, size=(64, 48)):
    out = []
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False)):
        R, T = orbit_pose(a, radius=3.0, height=height * np.sin(3 * a))
        out.append(cls(0, R, T, 0.9, 0.75, size, "/dev/null", image_name=f"c{i}"))
    return out


def _same_minicam(got: MiniCam, ref):
    assert (got.image_width, got.image_height) == (ref.image_width, ref.image_height)
    assert (got.fovx, got.fovy, got.znear, got.zfar) == (ref.fovx, ref.fovy, ref.znear,
                                                         ref.zfar)
    for name in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("path", ["ellipse", "spiral"])
def test_render_paths_match_jax_and_render(path):
    """The path's MiniCams equal JAX's within 1e-6 (TestRenderPaths'
    checks too); a device camera of each equals to_jax()'s leaves, and a
    render of the first through it equals JAX's render at 2e-5."""
    kw = {"n_frames": 12}
    if path == "ellipse":
        fn_j, fn_t = jpaths.generate_ellipse_path, tpaths.generate_ellipse_path
        kw["z_offset"] = 0.1
    else:
        fn_j, fn_t = jpaths.generate_spiral_path, tpaths.generate_spiral_path
    ref = fn_j(_cams(JaxCamera, height=0.3), **kw)
    got = fn_t(_cams(TorchCamera, height=0.3), **kw)
    assert len(got) == len(ref) == 12
    for g, r in zip(got, ref):
        _same_minicam(g, r)
        cj, ct = r.to_jax(), g.to_torch("cpu")
        assert (ct.width, ct.height) == (cj.width, cj.height) == (64, 48)
        for name in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy"):
            np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
    centers = np.stack([c.camera_center for c in got])
    assert 1.5 < np.linalg.norm(centers, axis=1).mean() < 4.5
    xyz, scales, quats, opa, shs = (np.asarray(a) for a in make_scene(n=64, seed=2))
    kw = dict(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
              opacity=np.log(opa / (1 - opa))[:, None].astype(np.float32),
              scaling=np.log(scales), rotation=quats)
    bg = np.zeros(3, np.float32)
    jr = np.asarray(j_render(ref[0].to_jax(), JaxGaussianData(**kw), jnp.asarray(bg))["render"])
    tr = render(got[0].to_torch("cpu"), GaussianData(**kw), bg)["render"].numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=2e-5)
    assert tr.max() > 0.05


def test_minicam_to_torch_raises_without_gpu(monkeypatch):
    cam = tpaths.generate_ellipse_path(_cams(TorchCamera), n_frames=2)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cam.to_torch()


@pytest.mark.parametrize("shape", [(3, 20, 30), (20, 30, 3), (1, 20, 30), (20, 30),
                                   (20, 30, 4)])
def test_save_img_u8_matches_jax(tmp_path, shape):
    """The PNG's decoded pixels equal the JAX writer's (cv2, BGR order)."""
    pytest.importorskip("cv2")
    img = np.random.default_rng(0).uniform(-0.2, 1.2, shape)
    img.flat[0] = np.nan
    jpaths.save_img_u8(img, str(tmp_path / "j.png"))
    tpaths.save_img_u8(img, str(tmp_path / "t.png"))
    with Image.open(tmp_path / "j.png") as a, Image.open(tmp_path / "t.png") as b:
        assert a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    tpaths.save_img_f32(img, str(tmp_path / "f"))
    jpaths.save_img_f32(img, str(tmp_path / "g.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), np.load(tmp_path / "g.npy"))


def test_create_videos(tmp_path):
    pytest.importorskip("cv2")
    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        tpaths.save_img_u8(rng.uniform(size=(3, 32, 32)), str(frame_dir / f"f_{i:03d}.png"))
    out = tpaths.create_videos(str(frame_dir), str(tmp_path / "out.mp4"), fps=5)
    assert os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="No frames"):
        tpaths.create_videos(str(tmp_path), str(tmp_path / "none.mp4"))


# --- LPIPS and the metrics app ----------------------------------------------


def test_lpips_proxy_matches_jax_and_orders_degradations():
    """TestPerceptualProxy.test_lpips_proxy_orders_degradations on the
    port, and each distance within 1e-5 relative of JAX's."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    small = np.clip(img + 0.02 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
    big = np.clip(img + 0.3 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
    shift = np.roll(img, 3, axis=2)
    d = {}
    for name, other in (("0", img), ("small", small), ("big", big), ("shift", shift)):
        d[name] = float(tperc.lpips_proxy(t(img), t(other)))
        ref = float(jperc.lpips_proxy(jnp.asarray(img), jnp.asarray(other)))
        assert d[name] == pytest.approx(ref, rel=1e-5, abs=1e-7), name
    assert d["0"] < 1e-6
    assert d["0"] < d["small"] < d["big"]
    assert d["shift"] > d["small"]
    assert d["big"] == float(tperc.lpips_proxy(t(img), t(big)))
    for a, b in zip(tperc._filters(), jperc._filters()):
        np.testing.assert_array_equal(a, b)


def _proxy_f64(a, b):
    """lpips_proxy's definition in numpy float64, with the seeded banks."""
    x, y = (np.asarray(v, np.float64)[None] * 2.0 - 1.0 for v in (a, b))
    total = 0.0
    for w in jperc._filters():
        w = w.astype(np.float64)

        def conv(z):
            c, h, wd = z.shape[1:]
            zp = np.pad(z[0], ((0, 0), (1, 1), (1, 1)))
            out = sum(np.einsum("oi,ihw->ohw", w[:, :, dy, dx], zp[:, dy:dy + h, dx:dx + wd])
                      for dy in range(3) for dx in range(3))
            return np.where(out > 0, out, 0.2 * out)[None]

        def norm(f):
            return f / np.sqrt((f * f).sum(axis=1, keepdims=True) + 1e-10)

        def pool(f):
            h, wd = f.shape[2] // 2 * 2, f.shape[3] // 2 * 2
            f = f[:, :, :h, :wd]
            return f.reshape(f.shape[0], f.shape[1], h // 2, 2, wd // 2, 2).mean(axis=(3, 5))

        x, y = conv(x), conv(y)
        d = norm(x) - norm(y)
        total += (d * d).sum(axis=1).mean()
        x, y = pool(x), pool(y)
    return total / 4


def test_lpips_proxy_is_float64_exact_on_flat_areas():
    """On an image pair with flat areas (a textured patch on black, a white
    band in the other) the port's proxy equals the float64 definition within
    1e-6 relative; JAX's f32 value is off by more than 1e-4 there (the
    rounding of the zero-mean banks' features on flat regions, scaled up by
    the unit normalisation), which is why the port computes in float64."""
    rng = np.random.default_rng(0)
    a = np.zeros((3, 96, 128), np.float32)
    a[:, 24:72, 32:96] = rng.uniform(0, 1, (3, 48, 64))
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    b[:, :20] = 1.0
    ref = _proxy_f64(a, b)
    got = float(tperc.lpips_proxy(t(a), t(b)))
    assert got == pytest.approx(ref, rel=1e-6)
    assert abs(float(jperc.lpips_proxy(jnp.asarray(a), jnp.asarray(b))) - ref) > 1e-4 * ref
    assert tperc.lpips_proxy(t(a), t(b)).dtype == torch.float32


def _weights():
    return jaux.TestPerceptualProxy()._random_lpips_weights()


def test_lpips_matches_jax():
    """LPIPS-VGG on fixture weights of the true shapes (random values) within
    1e-4 relative of JAX's and of test_aux's independent reference."""
    w = _weights()
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, 48, 64)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    got = float(tperc.lpips(t(a), t(b), w))
    ref = float(jperc.lpips(a, b, w))
    assert got == pytest.approx(ref, rel=1e-4)
    assert got == pytest.approx(jaux.TestPerceptualProxy()._torch_lpips_reference(w, a, b),
                                rel=1e-4)
    assert float(tperc.lpips(t(a), t(a), tperc.lpips_weights_to(w, "cpu"))) < 1e-6
    assert got > 0


def test_lpips_weight_loading(tmp_path, monkeypatch):
    """npz and torch state_dict files load to the same weights as JAX's
    loader; the discovery order is JAX's."""
    w = _weights()
    npz = str(tmp_path / "lpips_vgg.npz")
    np.savez(npz, **w)
    state = {}
    for i, tv in enumerate(tperc._TORCHVISION_CONV_IDX):
        state[f"net.features.{tv}.weight"] = torch.from_numpy(w[f"conv{i}_w"])
        state[f"net.features.{tv}.bias"] = torch.from_numpy(w[f"conv{i}_b"])
    for j in range(5):
        state[f"lins.{j}.model.1.weight"] = torch.from_numpy(w[f"lin{j}"].reshape(1, -1, 1, 1))
    pth = str(tmp_path / "lpips_vgg.pth")
    torch.save({"state_dict": state}, pth)
    for path in (npz, pth):
        got, ref = tperc.load_lpips_weights(path), jperc.load_lpips_weights(path)
        assert sorted(got) == sorted(ref) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(got[k], ref[k])
    bad = dict(w, lin2=w["lin2"][:10])
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="lin2"):
        tperc.load_lpips_weights(str(tmp_path / "bad.npz"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("SCORP_LPIPS_WEIGHTS", raising=False)
    assert tperc.default_lpips_weights_path() is None is jperc.default_lpips_weights_path()
    os.makedirs(tmp_path / ".cache" / "scorp_tpu")
    shutil.copy(npz, tmp_path / ".cache" / "scorp_tpu" / "lpips_vgg.npz")
    assert tperc.default_lpips_weights_path() == jperc.default_lpips_weights_path()
    monkeypatch.setenv("SCORP_LPIPS_WEIGHTS", pth)
    assert tperc.default_lpips_weights_path() == pth == jperc.default_lpips_weights_path()


def _image_dirs(root, n=2, size=(24, 32), alpha=False):
    rng = np.random.default_rng(1)
    for d in ("pred", "gt"):
        (root / d).mkdir()
    for i in range(n):
        a = rng.integers(0, 255, size + (4 if alpha else 3,), np.uint8)
        Image.fromarray(a).save(root / "gt" / f"im{i}.png")
        noisy = np.clip(a.astype(int) + rng.integers(-20, 20, a.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(root / "pred" / f"im{i}.png")
    return str(root / "pred"), str(root / "gt")


@pytest.mark.parametrize("backend", ["lpips_proxy", "lpips"])
def test_evaluate_dirs_matches_jax(tmp_path, monkeypatch, backend):
    """The metrics app's result against JAX's on the same PNGs: the same
    keys, PSNR and SSIM within 1e-5, LPIPS (either backend) within 1e-4
    relative; --use_alpha masks both."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("SCORP_LPIPS_WEIGHTS", raising=False)
    weights = None
    if backend == "lpips":
        weights = str(tmp_path / "w.npz")
        np.savez(weights, **_weights())
    for use_alpha in (False, True):
        root = tmp_path / f"alpha{int(use_alpha)}"
        root.mkdir()
        pred, gt = _image_dirs(root, alpha=use_alpha)
        ref = jmetrics.evaluate_dirs(pred, gt, use_alpha, lpips_weights=weights)
        got = tmetrics.evaluate_dirs(pred, gt, use_alpha, lpips_weights=weights, device="cpu")
        assert sorted(got) == sorted(ref) and got["lpips_backend"] == backend
        assert got["n_images"] == ref["n_images"] == 2
        for k in ("psnr", "ssim"):
            assert got[k] == pytest.approx(ref[k], rel=1e-5), k
        assert got[backend] == pytest.approx(ref[backend], rel=1e-4) and got[backend] > 0
    argv = ["--pred", pred, "--gt", gt, "--device", "cpu"]
    if weights:
        argv += ["--lpips_weights", weights]
    assert tmetrics.main(argv)["lpips_backend"] == backend


def test_metrics_raise_without_gpu(tmp_path, monkeypatch):
    pred, gt = _image_dirs(tmp_path, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.evaluate_dirs(pred, gt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.main(["--pred", pred, "--gt", gt])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.generate_grid(0, 1, 4, 0, 1, 3)


# --- offline 2D segmentation -------------------------------------------------


def _seg_fixture(root):
    """TestOfflineSegmentation's fixture: 4 random frames, a rectangle mask
    each, written with cv2."""
    cv2 = pytest.importorskip("cv2")
    img_dir = root / "images"
    mask_dir = root / "premasks" / "cup"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        name = f"img_{i:03d}"
        cv2.imwrite(str(img_dir / f"{name}.png"), rng.integers(0, 255, (32, 48, 3), np.uint8))
        mask = np.zeros((32, 48), np.uint8)
        mask[8:24, 12 + i:30 + i] = 255
        cv2.imwrite(str(mask_dir / f"{name}.png"), mask)
        paths.append(str(img_dir / f"{name}.png"))
    return paths


def _written(root):
    out = {}
    base = root / "masked_image_rgba"
    for d in sorted(os.listdir(base)):
        for f in sorted(os.listdir(base / d)):
            with Image.open(base / d / f) as im:
                out[f"{d}/{f}"] = (im.mode, np.asarray(im))
    return out


def test_get_mask2d_matches_jax(tmp_path):
    """TestOfflineSegmentation.test_maskdir_backend through both packages:
    the same files, each RGBA PNG's pixels equal to the JAX app's."""
    for name, mod, perc in (("jax", jseg, jperception), ("torch", tseg, tperception)):
        root = tmp_path / name
        paths = _seg_fixture(root)
        mod.get_mask2d(
            prompt_list=["cup"], data_dir=str(root), image_path_list=paths,
            first_image_name="img_001",
            detector=perc.BoxfileDetector({"cup": [0.5, 0.5, 0.6, 0.6]}),
            segmenter=perc.MaskdirSegmenter(str(root / "premasks"), ["cup"]),
        )
    ref, got = _written(tmp_path / "jax"), _written(tmp_path / "torch")
    assert sorted(got) == sorted(ref) and len(got) == 8
    for k in ref:
        assert got[k][0] == ref[k][0] == "RGBA", k
        np.testing.assert_array_equal(got[k][1], ref[k][1], err_msg=k)
    assert (got["cup/img_000.png"][1][..., 3] > 0).sum() > 50


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_mask_matches_cv2_at_the_border(seed):
    """cv2's open-then-close with its 5x5 ellipse, on random 40x50 masks
    that touch every border, equal to the port's scipy morphology (scipy's
    binary_opening/closing defaults differ there)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(40, 50)) < 0.55
    mask[:, :3] = True
    mask[-4:, :] = rng.uniform(size=(4, 50)) < 0.8
    np.testing.assert_array_equal(tseg.ELLIPSE_5X5,
                                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5)) > 0)
    ref = jseg._clean_mask(mask)
    got = tseg._clean_mask(mask)
    np.testing.assert_array_equal(got, ref)
    from scipy import ndimage

    scipy_default = ndimage.binary_closing(ndimage.binary_opening(mask, tseg.ELLIPSE_5X5),
                                           tseg.ELLIPSE_5X5)
    assert (scipy_default != ref).sum() > 100  # the borders matter on these masks
    assert 0 < got.sum() < got.size and got[:, 0].any()


def _write_modes(d, rng, h=20, w=30):
    """Masks in the PNG modes cv2 and PIL decode differently."""
    cv2 = pytest.importorskip("cv2")
    idx = rng.integers(0, 4, (h, w)).astype(np.uint8)
    pal = Image.fromarray(idx, "P")
    pal.putpalette([0, 0, 0, 0, 0, 9, 7, 0, 0, 0, 5, 0] + [0] * 756)
    pal.save(d / "palette.png")
    pal.save(d / "palette_trns.png", transparency=1)
    la = np.dstack([rng.integers(0, 3, (h, w)), rng.integers(0, 2, (h, w))]).astype(np.uint8)
    Image.fromarray(la, "LA").save(d / "la.png")
    cv2.imwrite(str(d / "grey16.png"), (rng.integers(0, 3, (h, w)) * 100).astype(np.uint16))
    Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool)).save(d / "bits.png")
    rgba = rng.integers(0, 2, (h, w, 4)).astype(np.uint8) * 7
    Image.fromarray(rgba, "RGBA").save(d / "rgba.png")
    Image.fromarray(rgba[..., :3], "RGB").save(d / "rgb.png")
    Image.fromarray(rgba[..., 0], "L").save(d / "grey.png")
    return ["palette", "palette_trns", "la", "grey16", "bits", "rgba", "rgb", "grey"]


def test_maskdir_reads_masks_as_cv2(tmp_path):
    """MaskdirSegmenter's masks from palette, palette+tRNS, LA, 16-bit grey,
    1-bit, RGBA, RGB and grey PNGs, equal to the JAX backend's (cv2); a
    16-bit colour mask raises."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path / "masks" / "obj"
    d.mkdir(parents=True)
    names = _write_modes(d, np.random.default_rng(0))
    paths = [str(tmp_path / f"{n}.png") for n in names]
    outs = []
    for perc in (jperception, tperception):
        seg = perc.MaskdirSegmenter(str(tmp_path / "masks"), ["obj"])
        seg.init(paths)
        outs.append(list(seg.propagate(0, False)))
    ref, got = outs
    assert len(got) == len(ref) == len(names)
    for (fi, ids, masks), (rfi, rids, rmasks), name in zip(got, ref, names):
        assert (fi, ids) == (rfi, rids)
        assert masks[0].dtype == bool
        np.testing.assert_array_equal(masks[0], rmasks[0], err_msg=name)
        assert 0 < masks[0].sum() < masks[0].size, name
    cv2.imwrite(str(d / "rgb16.png"), np.full((4, 4, 3), 100, np.uint16))
    with pytest.raises(ValueError, match="16-bit colour"):
        tperception.read_mask(str(d / "rgb16.png"))


def test_segmentation_app_matches_jax(tmp_path):
    """segmentation_2d's CLI on a COLMAP scene with description.yml and
    --mask_dir, through both packages: equal RGBA files; without
    checkpoints and without --mask_dir it raises."""
    base = tmp_path / "base"
    build_dataset(str(base), n_views=3, width=32, height=24, n_gauss=8)
    with open(base / "description.yml", "w") as f:
        yaml.safe_dump({"prompts": "a, b", "ext": "png", "detect_conf": 0.3,
                        "first_image_name": "img_001"}, f)
    rng = np.random.default_rng(4)
    for p in ("a", "b"):
        (base / "masks" / p).mkdir(parents=True)
        for i in range(3):
            m = (rng.uniform(size=(24, 32)) < 0.6).astype(np.uint8) * 255
            Image.fromarray(m).save(base / "masks" / p / f"img_{i:03d}.png")
    for name, mod in (("jax", jseg), ("torch", tseg)):
        shutil.copytree(base, tmp_path / name)
        mod.main(["-s", str(tmp_path / name), "--mask_dir", str(tmp_path / name / "masks")])
    ref, got = _written(tmp_path / "jax"), _written(tmp_path / "torch")
    assert sorted(got) == sorted(ref) and len(got) == 9
    for k in ref:
        np.testing.assert_array_equal(got[k][1], ref[k][1], err_msg=k)
    with pytest.raises(RuntimeError, match="--mask_dir"):
        tseg.main(["-s", str(tmp_path / "torch")])


# --- image_ops ---------------------------------------------------------------


def test_image_ops_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 3, 20, 24)).astype(np.float32)
    gray = rng.uniform(0, 1, (2, 1, 20, 24)).astype(np.float32)
    xy = rng.uniform(0, 1, (50, 2)).astype(np.float32)

    def close(got, ref, atol=1e-6):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)

    close(tops.generate_grid(0.0, 1.0, 5, -1.0, 2.0, 4, device="cpu"),
          jops.generate_grid(0.0, 1.0, 5, -1.0, 2.0, 4))
    close(tops.interpolate(t(img[0]), t(xy)), jops.interpolate(img[0], xy))
    close(tops.rgb_to_gray(t(img)), jops.rgb_to_gray(img))
    for a, b in zip(tops.compute_gradient(t(img), rgb2gray=True),
                    jops.compute_gradient(jnp.asarray(img), rgb2gray=True)):
        close(a, b)
    for a, b in zip(tops.compute_gradient(t(gray)), jops.compute_gradient(jnp.asarray(gray))):
        close(a, b)
    with pytest.raises(ValueError, match="grayscale"):
        tops.compute_gradient(t(img))
    close(tops.blur(t(img)), jops.blur(jnp.asarray(img)))
    close(tops.blur(t(gray[0, 0])), jops.blur(jnp.asarray(gray[0, 0])))
    close(tops.gradient_map(t(img[0])), jops.gradient_map(jnp.asarray(img[0])))
    close(tops.depth_normalize(t(gray)), jops.depth_normalize(jnp.asarray(gray)))
    close(tops.colormap(t(gray[0])), jops.colormap(jnp.asarray(gray[0])))
    pkg = {"render": img[0], "render_alpha": gray[0], "render_normal": img[1] * 2 - 1,
           "render_depth": gray[1]}
    items = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]
    for mode in range(len(items)):
        close(tops.render_net_image({k: t(v) for k, v in pkg.items()}, items, mode, None),
              jops.render_net_image({k: jnp.asarray(v) for k, v in pkg.items()}, items, mode,
                                    None))


# --- the network viewer ------------------------------------------------------


def _payload(w, h, smod=1.5):
    rng = np.random.default_rng(7)
    return {
        "resolution_x": w, "resolution_y": h, "train": 1,
        "fov_y": 0.8, "fov_x": 0.9, "z_near": 0.01, "z_far": 100.0,
        "shs_python": 0, "rot_scale_python": 0, "keep_alive": 1,
        "scaling_modifier": smod,
        "view_matrix": [float(x) for x in rng.normal(size=16)],
        "view_projection_matrix": [float(x) for x in rng.normal(size=16)],
    }


def _client(port, payload, expected, received):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    msg = json.dumps(payload).encode()
    s.sendall(len(msg).to_bytes(4, "little") + msg)
    buf = b""
    while len(buf) < expected:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    received["buf"] = buf
    s.close()


def _serve(mod, payload, w, h):
    """One gui_tick round of `mod` against a client thread: (the client's
    bytes, the MiniCam and scaling modifier render_fn saw)."""
    gui = mod.maybe_create_gui("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    received, calls = {}, {}
    th = threading.Thread(target=_client, args=(port, payload, w * h * 3 + 4 + 3, received),
                          daemon=True)
    th.start()

    def render_fn(minicam, smod):
        calls["cam"], calls["smod"] = minicam, smod
        img = np.zeros((3, h, w), np.float32)
        img[0] = np.linspace(-0.5, 1.5, w)[None]
        img[2, ::2] = 0.5
        return img

    deadline = time.time() + 10
    while time.time() < deadline and not calls:
        mod.gui_tick(gui, render_fn, "src", iteration=5, max_iterations=100)
        time.sleep(0.01)
    th.join(timeout=10)
    assert not th.is_alive()
    gui.conn.close()
    gui.listener.close()
    return received["buf"], calls["cam"], calls["smod"]


def test_gui_tick_matches_jax():
    """TestNetworkGUI's service round through both packages: the same bytes
    on the wire (frame, verify length, verify string), the same MiniCam
    (the Y/Z column flips) and scaling modifier."""
    w, h = 16, 8
    payload = _payload(w, h)
    ref_buf, ref_cam, ref_smod = _serve(jgui, payload, w, h)
    buf, cam, smod = _serve(tgui, payload, w, h)
    assert buf == ref_buf and len(buf) == w * h * 3 + 4 + 3
    assert buf[w * h * 3:] == (3).to_bytes(4, "little") + b"src"
    assert smod == ref_smod == 1.5
    assert isinstance(cam, MiniCam)
    _same_minicam(cam, ref_cam)
    wvt = np.asarray(payload["view_matrix"], np.float32).reshape(4, 4)
    assert cam.world_view_transform[0, 1] == -wvt[0, 1] and cam.world_view_transform[0, 0] == \
        wvt[0, 0]


def test_viewer_protocol_roundtrip_and_close():
    """TestNetworkGUI.test_protocol_roundtrip on the port; a zero
    resolution asks for no frame; the viewer closes its sockets."""
    gui = tgui.NetworkGUI()
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    received = {}
    payload = _payload(32, 24)
    th = threading.Thread(target=_client, args=(port, payload, 32 * 24 * 3 + 6, received),
                          daemon=True)
    th.start()
    for _ in range(200):
        gui.try_connect()
        if gui.conn is not None:
            break
        time.sleep(0.02)
    assert gui.conn is not None
    cam, do_training, *_ = gui.receive()
    assert cam.image_width == 32 and do_training
    img = tgui.NetworkGUI.encode_image(np.zeros((3, 24, 32), np.float32))
    assert img == jgui.NetworkGUI.encode_image(np.zeros((3, 24, 32), np.float32))
    gui.send(img, "ok")
    th.join(timeout=10)
    assert not th.is_alive() and len(received["buf"]) == 32 * 24 * 3 + 6
    gui.close()
    assert gui.conn is None and gui.listener.fileno() == -1
    assert tgui.maybe_create_gui(None, 6009) is None


# --- random_patch_loss and safe_state -------------------------------------


@pytest.mark.parametrize("loss_func", ["l1", "l2", "pearson"])
def test_random_patch_loss_on_jax_offsets(loss_func):
    """The port's patch loss on the corners JAX draws (its internal helper
    takes them) within 1e-6 relative; the generator's draw is in range."""
    rng = np.random.default_rng(2)
    src = rng.uniform(0.5, 4, (1, 40, 56)).astype(np.float32)
    tgt = rng.uniform(0.5, 4, (1, 40, 56)).astype(np.float32)
    box, p = 8, 0.5
    key = jax.random.PRNGKey(3)
    ref = float(jlosses.random_patch_loss(jnp.asarray(src), jnp.asarray(tgt), box, p, key,
                                          loss_func))
    n = int(p * (40 // box) * (56 // box))
    kx, ky = jax.random.split(key)
    x0 = np.array(jax.random.randint(kx, (n,), 0, 40 - box))
    y0 = np.array(jax.random.randint(ky, (n,), 0, 56 - box))
    got = float(tlosses._patch_loss(t(src), t(tgt), torch.from_numpy(x0), torch.from_numpy(y0),
                                    box, loss_func))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
    gen = torch.Generator().manual_seed(0)
    a = tlosses.random_patch_loss(t(src), t(tgt), box, p, gen, loss_func)
    assert torch.isfinite(a) and a > 0
    gen.manual_seed(0)
    assert float(tlosses.random_patch_loss(t(src), t(tgt), box, p, gen, loss_func)) == float(a)
    with pytest.raises(ValueError, match="Unknown"):
        tlosses.random_patch_loss(t(src), t(tgt), box, p, gen, "l3")


def test_safe_state(capsys):
    old = sys.stdout
    try:
        gen = safe_state(seed=5)
        print("hello")
        x = np.random.rand()
        y = torch.rand(1)
        z = torch.rand(1, generator=gen)
        safe_state(silent=True, seed=5)
        print("quiet")
    finally:
        sys.stdout = old
    out = capsys.readouterr().out
    assert out.startswith("hello [") and out.endswith("]\n") and "quiet" not in out
    np.random.seed(5)
    assert x == np.random.rand()
    assert torch.equal(y, torch.manual_seed(5) and torch.rand(1))
    assert torch.equal(z, torch.rand(1, generator=torch.Generator().manual_seed(5)))
