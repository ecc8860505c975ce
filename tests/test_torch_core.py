"""Port parity, core layer: scorp_tpu_torch's SH, quaternion, camera, PLY,
COLMAP and config code against scorp_tpu's on the same numpy inputs; plus
the port's isolation from JAX and its device rule."""

import ast
import subprocess
import sys
from argparse import ArgumentParser
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.core import camera as jcam
from scorp_tpu.core import colmap as jcolmap
from scorp_tpu.core import plyio as jply
from scorp_tpu.core import quat as jquat
from scorp_tpu.core import sh as jsh
from scorp_tpu_torch import config as tconfig
from scorp_tpu_torch.core import camera as tcam
from scorp_tpu_torch.core import colmap as tcolmap
from scorp_tpu_torch.core import plyio as tply
from scorp_tpu_torch.core import quat as tquat
from scorp_tpu_torch.core import sh as tsh
from scorp_tpu_torch.device import resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "scorp_tpu_torch"


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(300, 25, 3)).astype(np.float32)
    dirs = _dirs(rng, 300)
    ref = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    got = tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_rgb_sh_roundtrip_matches_jax():
    rgb = np.random.default_rng(1).uniform(0, 1, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))))
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(rgb)), rgb, atol=1e-6)


def test_quat_to_rotmat_matches_jax_and_zero_quat_is_safe():
    q = np.random.default_rng(2).normal(size=(200, 4)).astype(np.float32)
    q[0] = 0.0  # a dead padded row
    ref = np.asarray(jquat.quat_to_rotmat(jnp.asarray(q)))
    qt = torch.from_numpy(q).requires_grad_(True)
    got = tquat.quat_to_rotmat(qt)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.eye(3, dtype=np.float32))
    got.sum().backward()
    assert torch.isfinite(qt.grad).all()
    np.testing.assert_array_equal(qt.grad[0].numpy(), np.zeros(4, np.float32))



@pytest.mark.parametrize("modifier", [1.0, 0.7])
def test_scaling_rotation_and_covariance_match_jax(modifier):
    rng = np.random.default_rng(5)
    s = np.exp(rng.normal(-3.0, 0.5, size=(300, 3))).astype(np.float32)
    q = rng.normal(size=(300, 4)).astype(np.float32)
    L = tquat.build_scaling_rotation(torch.from_numpy(s), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(
        L, np.asarray(jquat.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q))),
        atol=1e-7, rtol=1e-6)
    got = tquat.covariance_from_scaling_rotation(torch.from_numpy(s), modifier,
                                                 torch.from_numpy(q)).numpy()
    ref = np.asarray(jquat.covariance_from_scaling_rotation(jnp.asarray(s), modifier,
                                                            jnp.asarray(q)))
    assert got.shape == (300, 6)
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=1e-5)

def _jax_cam_fields(c):
    return [np.asarray(c.viewmatrix), np.asarray(c.projmatrix), np.asarray(c.campos),
            np.asarray(c.tanfovx), np.asarray(c.tanfovy)]


def _torch_cam_fields(c):
    return [c.viewmatrix.numpy(), c.projmatrix.numpy(), c.campos.numpy(),
            c.tanfovx.numpy(), c.tanfovy.numpy()]


def test_camera_matrices_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=4)
    R = jcolmap.qvec2rotmat(q / np.linalg.norm(q))
    T = rng.normal(size=3)
    ref = jcam.make_camera_jax(R, T, 0.9, 0.7, 80, 60, trans=np.array([0.1, 0.0, -0.2]),
                               scale=1.3)
    got = tcam.make_camera(R, T, 0.9, 0.7, 80, 60, trans=np.array([0.1, 0.0, -0.2]),
                           scale=1.3, device="cpu")
    for a, b in zip(_torch_cam_fields(got), _jax_cam_fields(ref)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert (got.width, got.height) == (ref.width, ref.height)

    ref = jcam.look_at_camera([0.3, 0.5, -4], [0, 0, 0], [0, 1, 0], 0.8, 0.6, 64, 48)
    got = tcam.look_at_camera([0.3, 0.5, -4], [0, 0, 0], [0, 1, 0], 0.8, 0.6, 64, 48,
                              device="cpu")
    for a, b in zip(_torch_cam_fields(got), _jax_cam_fields(ref)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tcam.projection_matrix(0.01, 100.0, 0.8, 0.6),
                                  jcam.projection_matrix(0.01, 100.0, 0.8, 0.6))
    assert tcam.fov2focal(0.8, 64) == jcam.fov2focal(0.8, 64)
    assert tcam.focal2fov(70.0, 64) == jcam.focal2fov(70.0, 64)


def test_camera_from_numpy_of_jax_camera():
    ref = jcam.look_at_camera([0, 0.2, -3], [0, 0, 0], [0, 1, 0], 0.9, 0.7, 32, 24)
    fovx = 2 * np.arctan(float(ref.tanfovx))
    fovy = 2 * np.arctan(float(ref.tanfovy))
    got = tcam.camera_from_numpy(np.asarray(ref.viewmatrix), np.asarray(ref.projmatrix),
                                 fovx, fovy, 32, 24, np.asarray(ref.campos), device="cpu")
    for a, b in zip(_torch_cam_fields(got), _jax_cam_fields(ref)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def _gaussians(n=37, deg=3, seed=4):
    rng = np.random.default_rng(seed)
    k = (deg + 1) ** 2
    arrays = dict(
        xyz=rng.normal(size=(n, 3)), f_dc=rng.normal(size=(n, 1, 3)),
        f_rest=rng.normal(size=(n, k - 1, 3)), opacity=rng.normal(size=(n, 1)),
        scaling=rng.normal(size=(n, 3)), rotation=rng.normal(size=(n, 4)),
    )
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def test_gaussian_ply_is_byte_identical(tmp_path):
    arrays = _gaussians()
    jply.save_gaussian_ply(str(tmp_path / "jax.ply"), jply.GaussianData(**arrays))
    tply.save_gaussian_ply(str(tmp_path / "torch.ply"), tply.GaussianData(**arrays))
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "torch.ply").read_bytes()
    back = tply.load_gaussian_ply(str(tmp_path / "jax.ply"), max_sh_degree=3)
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(back, k), v)


def test_colmap_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    q = rng.normal(size=4)
    img = tcolmap.ColmapImage(3, q / np.linalg.norm(q), rng.normal(size=3), 1, "a.png",
                              rng.normal(size=(2, 2)), np.array([7, 9], np.int64))
    cam = tcolmap.ColmapCamera(1, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0]))
    tcolmap.write_extrinsics_binary({3: img}, str(tmp_path / "images.bin"))
    tcolmap.write_intrinsics_binary({1: cam}, str(tmp_path / "cameras.bin"))
    pts = rng.normal(size=(5, 3))
    tcolmap.write_points3D_binary(pts, rng.integers(0, 255, (5, 3), dtype=np.uint8),
                                  np.zeros((5, 1)), str(tmp_path / "points3D.bin"))
    for mod in (jcolmap, tcolmap):
        e = mod.read_extrinsics_binary(str(tmp_path / "images.bin"))[3]
        np.testing.assert_array_equal(e.qvec, img.qvec)
        np.testing.assert_array_equal(e.xys, img.xys)
        assert e.name == "a.png"
        c = mod.read_intrinsics_binary(str(tmp_path / "cameras.bin"))[1]
        np.testing.assert_array_equal(c.params, cam.params)
        np.testing.assert_array_equal(mod.read_points3D_binary(str(tmp_path / "points3D.bin"))[0],
                                      pts)
    R = tcolmap.qvec2rotmat(img.qvec)
    np.testing.assert_allclose(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R), atol=1e-12)


def test_combined_args_merge_cfg_args(tmp_path):
    (tmp_path / "cfg_args").write_text("Namespace(sh_degree=2, images='imgs', eval=True, iterations=7)")
    parser = ArgumentParser()
    tconfig.ModelParams.add_to_parser(parser, "m")
    args = tconfig.get_combined_args(parser, ["-m", str(tmp_path), "-r", "2"])
    # CLI values (defaults included) win; keys only in cfg_args survive
    assert (args.images, args.eval, args.resolution) == ("images", False, 2)
    assert args.iterations == 7
    dataset = tconfig.ModelParams.extract(args)
    assert dataset.model_path == str(tmp_path)


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'scorp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_port_file_imports_jax_or_the_jax_package():
    """Nor cv2: the port's last cv2 call (video export) is pipeline/video.py."""
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "scorp_tpu", "cv2"), (path, name)


def test_cuda_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tcam.look_at_camera([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.8, 0.8, 16, 16)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.main([]) == 2
