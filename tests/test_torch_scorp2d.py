"""Port parity, the 2DGS object path on a synthetic scene (tests/test_torch_scorp.py's
scene, its 48 Gaussians as surfels at iteration 25000): the surfel vote of
the three methods, segmentation_2dgs, align_2dgs_clpe_9dof, the proxy
stages (trellis_img2gs --proxy_dir, truncate_opacity) and a surfel PLY's
load, all on the CPU, against scorp_tpu's on the same inputs."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.apps import align_2dgs_clpe_9dof as jalign2d
from scorp_tpu.apps import align_3dgs_clpe_9dof as jalign
from scorp_tpu.apps import segmentation_2dgs as jseg2d
from scorp_tpu.apps import trellis_img2gs as jtrellis
from scorp_tpu.apps import truncate_opacity as jtrunc
from scorp_tpu.core.plyio import GaussianData, save_gaussian_ply
from scorp_tpu.pipeline import mask3d as jmask
from scorp_tpu.render import default_raster_config as jcfg
from scorp_tpu.scene import Scene as JScene
from scorp_tpu.train import from_gaussian_data as jfrom_gd
from scorp_tpu_torch.apps import align_2dgs_clpe_9dof as talign2d
from scorp_tpu_torch.apps import segmentation_2dgs as tseg2d
from scorp_tpu_torch.apps import trellis_img2gs as ttrellis
from scorp_tpu_torch.apps import truncate_opacity as ttrunc
from scorp_tpu_torch.core import plyio as tply
from scorp_tpu_torch.pipeline import mask3d as tmask
from scorp_tpu_torch.render import default_raster_config as tcfg
from scorp_tpu_torch.scene import Scene as TScene
from scorp_tpu_torch.train import state as tstate
from tests.test_torch_scorp import _proxy, _recording, model_args, scene  # noqa: F401

torch.set_num_threads(1)

KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


@pytest.fixture(scope="module")
def scene2d(scene):  # noqa: F811 (the imported module fixture)
    """The scene's Gaussians as surfels (their first two scales) at
    iteration 25000, in a JAX and a port model directory."""
    g = scene.g
    g2 = GaussianData(xyz=g.xyz, f_dc=g.f_dc, f_rest=g.f_rest, opacity=g.opacity,
                      scaling=np.ascontiguousarray(g.scaling[:, :2]), rotation=g.rotation)
    models = {}
    for name in ("jax", "torch"):
        models[name] = os.path.join(scene.root, f"model2d_{name}")
        save_gaussian_ply(os.path.join(models[name], "point_cloud", "iteration_25000",
                                       "point_cloud.ply"), g2)
    jscene = JScene(model_args(scene.root, models["jax"]), load_iteration=25000, shuffle=False)
    tscene = TScene(model_args(scene.root, models["torch"]), load_iteration=25000,
                    shuffle=False)
    return SimpleNamespace(root=scene.root, g=g2, obj_mask=scene.obj_mask, models=models,
                           jscene=jscene, tscene=tscene)


def _states(s):
    js = jfrom_gd(s.jscene.gaussians)
    ts = tstate.from_gaussian_data(s.tscene.gaussians, device="cpu")
    return js, ts


def test_surfel_ply_loads_like_jax(scene2d):
    """A PLY with two scale columns: the same GaussianData and the same
    padded state (capacity, alive, every parameter) as the JAX package's."""
    js, ts = _states(scene2d)
    for k in KEYS:
        np.testing.assert_array_equal(getattr(scene2d.tscene.gaussians, k),
                                      getattr(scene2d.jscene.gaussians, k), err_msg=k)
    assert ts.capacity == js.capacity and ts.params["scaling"].shape == (ts.capacity, 2)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for k in KEYS:
        np.testing.assert_array_equal(ts.params[k].numpy(), np.asarray(js.params[k]), err_msg=k)
    ref = tstate.state_from_numpy({k: np.asarray(v) for k, v in js.params.items()},
                                  np.asarray(js.alive), device="cpu")
    assert ref.capacity == ts.capacity and ref.params["scaling"].shape[1] == 2


@pytest.mark.parametrize("method", ["gradient", "binary", "projection"])
def test_surfel_vote_vectors_match_jax(scene2d, method):
    """Each camera's raw surfel vote vector within 2e-5 · max(|v|, 1) of the
    JAX package's `_vote_step(surfel=True)` (its plain surfel rasterizer)
    and `_projection_vote_step`."""
    js, ts = _states(scene2d)
    jc, tc = jcfg(js.capacity), tcfg(ts.capacity)
    bg = np.zeros(3, np.float32)
    largest = 0.0
    for jcam, tcam in zip(scene2d.jscene.get_train_cameras(),
                          scene2d.tscene.get_train_cameras()):
        mask = jmask.load_mask_rgba(os.path.join(scene2d.root, "masked_image_rgba", "cup",
                                                 f"{jcam.image_name}.png"), jcam.resolution)
        cam = jcam.to_jax()
        if method == "projection":
            ref = jmask._projection_vote_step(js.params, js.alive, cam, jnp.asarray(mask),
                                              cfg=jc)
        elif method == "binary":
            m = jnp.asarray(mask.astype(np.float32))
            v_in = jmask._vote_step(js.params, js.alive, cam, m, jnp.asarray(bg), cfg=jc,
                                    surfel=True)
            v_out = jmask._vote_step(js.params, js.alive, cam, 1.0 - m, jnp.asarray(bg),
                                     cfg=jc, surfel=True)
            ref = (v_in > 0).astype(jnp.float32) - (v_out > 0).astype(jnp.float32)
        else:
            signed = jnp.asarray(np.where(mask, 1.0, -1.0).astype(np.float32))
            ref = jmask._vote_step(js.params, js.alive, cam, signed, jnp.asarray(bg), cfg=jc,
                                   surfel=True)
        ref = np.asarray(ref)
        got = tmask.camera_votes(ts, tcam.to_torch("cpu"), mask, torch.zeros(3), method, tc,
                                 surfel=True).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=jcam.image_name)
        largest = max(largest, np.abs(ref).max())
    assert largest > 0


def test_segmentation_2dgs_matches_jax_app(scene2d):
    """Both CLIs: gs_seg/cup.ply and remained.ply the same bytes, the
    selection mostly the object (TestSegmentation3D's IoU)."""
    ref = jseg2d.mask3d(model_args(scene2d.root, scene2d.models["jax"]), None)
    got = tseg2d.main(["-s", scene2d.root, "-m", scene2d.models["torch"], "--eval",
                       "--split_yml_name", "split.yml", "--device", "cpu"])
    np.testing.assert_array_equal(got, ref)
    iou = (got[0] & scene2d.obj_mask).sum() / (got[0] | scene2d.obj_mask).sum()
    assert iou > 0.5, iou
    for name in ("cup.ply", "remained.ply"):
        paths = [os.path.join(scene2d.models[n], "gs_seg", name) for n in ("torch", "jax")]
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read(), name


@pytest.fixture(scope="module")
def aligned2d(scene2d):
    """The surfel object (the JAX app's segmentation) and a 3DGS SH0 proxy of
    it (a third scale column), in both model directories."""
    seg = jseg2d.mask3d(model_args(scene2d.root, scene2d.models["jax"]), None)[0]
    obj = scene2d.g.select(seg)
    proxy = _proxy(GaussianData(xyz=obj.xyz, f_dc=obj.f_dc, f_rest=obj.f_rest,
                                opacity=obj.opacity,
                                scaling=np.concatenate([obj.scaling, obj.scaling[:, 1:]], 1),
                                rotation=obj.rotation))
    for m in scene2d.models.values():
        save_gaussian_ply(os.path.join(m, "gs_seg", "cup.ply"), obj)
        save_gaussian_ply(os.path.join(m, "generated", "cup.ply"), proxy)
    return obj, proxy


def test_align_2dgs_with_sift_matches_jax_coarse_init(scene2d, aligned2d, monkeypatch):
    """The coarse init (bbox scale, centroid shift, 67-init ICP) within 1e-4
    of the JAX app's, the ICP's inputs within 1e-5 (their depths come from
    the surfel renders of the scene object); after the rounds,
    TestAlignment's criterion."""
    obj, _ = aligned2d
    bank_dir = os.path.join(scene2d.root, "rotation_matrices")
    logs = {"jax": {}, "torch": {}}
    monkeypatch.setattr(jalign, "best_icp_transform",
                        _recording(jalign.best_icp_transform, logs["jax"]))
    import scorp_tpu_torch.apps.align_3dgs_clpe_9dof as talign

    monkeypatch.setattr(talign, "best_icp_transform",
                        _recording(talign.best_icp_transform, logs["torch"]))
    renders = []
    scene_render = talign2d._scene_render_2d
    monkeypatch.setattr(talign2d, "_scene_render_2d",
                        lambda *a: renders.append(1) or scene_render(*a))
    talign2d.align(model_args(scene2d.root, scene2d.models["torch"]), None, "cup",
                   num_iterations=2, opt_12dof_iterations=[1], rotations_path=bank_dir,
                   matcher_backend="sift", device="cpu")
    jalign2d.align(model_args(scene2d.root, scene2d.models["jax"]), None, "cup",
                   num_iterations=2, opt_12dof_iterations=[1], rotations_path=bank_dir,
                   matcher_backend="sift")
    assert len(renders) > 0  # the scene object went through the surfel renderer
    for a, b in zip(logs["torch"]["inputs"], logs["jax"]["inputs"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logs["torch"]["T"], logs["jax"]["T"], rtol=0, atol=1e-4)
    got = tply.load_gaussian_ply(os.path.join(scene2d.models["torch"], "generated_aligned",
                                              "cup.ply"))
    c_err = np.linalg.norm(got.xyz.mean(0) - obj.xyz.mean(0))
    assert c_err < 0.35 * obj.xyz.std(), (c_err, obj.xyz.std())


# --- the proxy stages (host-side) ------------------------------------------------------

def _proxy_models(root, tag):
    """Two model dirs with the same generated/ PLYs, about a third of their
    Gaussians below opacity 0.1."""
    rng = np.random.default_rng(9)
    objs = {}
    for obj, n in (("cup", 60), ("bowl", 45)):
        objs[obj] = GaussianData(
            xyz=rng.normal(size=(n, 3)).astype(np.float32),
            f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
            f_rest=np.zeros((n, 0, 3), np.float32),
            opacity=rng.normal(-1.5, 1.5, (n, 1)).astype(np.float32),
            scaling=rng.normal(-3, 0.3, (n, 3)).astype(np.float32),
            rotation=rng.normal(size=(n, 4)).astype(np.float32))
    models = {name: os.path.join(root, f"{tag}_{name}") for name in ("jax", "torch")}
    for m in models.values():
        for obj, g in objs.items():
            save_gaussian_ply(os.path.join(m, "generated", f"{obj}.ply"), g)
    return models


def test_truncate_opacity_matches_jax_app(tmp_path):
    """The truncated PLYs and their .bak backups the same bytes as the JAX
    app's; the backups are the originals; some Gaussians went."""
    models = _proxy_models(str(tmp_path), "trunc")
    original = {n: open(os.path.join(models["jax"], "generated", n), "rb").read()
                for n in ("cup.ply", "bowl.ply")}
    jtrunc.main(["-m", models["jax"], "--threshold", "0.1"])
    kept = ttrunc.main(["-m", models["torch"], "--threshold", "0.1", "--device", "cpu"])
    for name in ("cup.ply", "bowl.ply"):
        for suffix in ("", ".bak"):
            a, b = (open(os.path.join(models[n], "generated", name + suffix), "rb").read()
                    for n in ("torch", "jax"))
            assert a == b, name + suffix
        assert open(os.path.join(models["torch"], "generated", name + ".bak"),
                    "rb").read() == original[name]
    assert 0 < kept[os.path.join(models["torch"], "generated", "cup.ply")] < 60
    with pytest.raises(FileNotFoundError, match="does not exist"):
        ttrunc.main(["-m", str(tmp_path / "none"), "--device", "cpu"])


def test_trellis_img2gs_precomputed_matches_jax_app(tmp_path):
    """--proxy_dir copies <obj>.ply per selected object; a missing proxy and
    a missing TRELLIS checkpoint raise the JAX app's errors."""
    proxies = tmp_path / "proxies"
    proxies.mkdir()
    g = tply.GaussianData(xyz=np.zeros((3, 3), np.float32), f_dc=np.zeros((3, 1, 3), np.float32),
                          f_rest=np.zeros((3, 0, 3), np.float32),
                          opacity=np.zeros((3, 1), np.float32),
                          scaling=np.zeros((3, 3), np.float32),
                          rotation=np.tile(np.float32([1, 0, 0, 0]), (3, 1)))
    tply.save_gaussian_ply(str(proxies / "cup.ply"), g)
    errors = {}
    for name, app, extra in (("jax", jtrellis, []), ("torch", ttrellis, ["--device", "cpu"])):
        model = tmp_path / name
        (model / "masked_image_rgba_selected" / "cup").mkdir(parents=True)
        app.main(["-m", str(model), "--proxy_dir", str(proxies), *extra])
        assert (open(model / "generated" / "cup.ply", "rb").read()
                == open(proxies / "cup.ply", "rb").read())
        (model / "masked_image_rgba_selected" / "bowl").mkdir()
        with pytest.raises(FileNotFoundError) as e:
            app.main(["-m", str(model), "--proxy_dir", str(proxies), "--object_name", "bowl",
                      *extra])
        errors[name, "proxy"] = str(e.value).replace(str(model), "<model>")
        with pytest.raises(RuntimeError) as e:
            app.main(["-m", str(model), *extra])
        errors[name, "ckpt"] = str(e.value).replace(str(model), "<model>")
        with pytest.raises(ValueError) as e:
            app.main(["-m", str(model), "--proxy_dir", str(proxies), "--object_name", "mug",
                      *extra])
        errors[name, "object"] = str(e.value).replace(str(model), "<model>")
    for kind in ("proxy", "ckpt", "object"):
        assert errors["torch", kind] == errors["jax", kind]
    assert "TRELLIS checkpoint not found" in errors["torch", "ckpt"]
    with pytest.raises(NotImplementedError, match="proxy_dir"):
        ttrellis.generate_trellis(None, str(tmp_path), "cup", str(tmp_path))
