"""Port parity, SCORP stages on a synthetic scene (48 Gaussians, 8 views at
64x64; the `scorp_scene` pattern of tests/test_scorp_pipeline.py): gradient
voting, segmentation, view selection, alignment, refinement and the apps'
device rule, all on the CPU, against scorp_tpu's (its XLA golden
`rasterize`) on the same inputs."""

import os
import random
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from scorp_tpu.apps import align_3dgs_clpe_9dof as jalign
from scorp_tpu.apps import post_refine_gs as jrefine_app
from scorp_tpu.apps import segmentation_3dgs as jseg
from scorp_tpu.apps import view_selection as jview
from scorp_tpu.core.camera import make_camera_jax
from scorp_tpu.core.plyio import GaussianData, load_gaussian_ply, save_gaussian_ply
from scorp_tpu.ops.raster.xla import rasterize_naive
from scorp_tpu.pipeline import gs_transform as jgst
from scorp_tpu.pipeline import mask3d as jmask
from scorp_tpu.pipeline.matching import PrecomputedMatcher as JMatcher
from scorp_tpu.render import default_raster_config as jcfg
from scorp_tpu.scene import Scene as JScene
from scorp_tpu.train import from_gaussian_data as jfrom_gd
from scorp_tpu.train import refine as jrefine
from scorp_tpu.train import state as jstate
from scorp_tpu.train import step as jstep
from scorp_tpu_torch.apps import align_2dgs_clpe_9dof as talign2d
from scorp_tpu_torch.apps import align_3dgs_clpe_9dof as talign
from scorp_tpu_torch.apps import extract_mesh as textract
from scorp_tpu_torch.apps import post_refine_gs as trefine_app
from scorp_tpu_torch.apps import segmentation_2dgs as tseg2d
from scorp_tpu_torch.apps import segmentation_3dgs as tseg
from scorp_tpu_torch.apps import trellis_img2gs as ttrellis
from scorp_tpu_torch.apps import truncate_opacity as ttrunc
from scorp_tpu_torch.apps import view_selection as tview
from scorp_tpu_torch.core import plyio as tply
from scorp_tpu_torch.pipeline import mask3d as tmask
from scorp_tpu_torch.pipeline.matching import PrecomputedMatcher as TMatcher
from scorp_tpu_torch.render import default_raster_config as tcfg
from scorp_tpu_torch.render import render as trender
from scorp_tpu_torch.scene import Scene as TScene
from scorp_tpu_torch.train import refine as trefine
from scorp_tpu_torch.train import state as tstate
from scorp_tpu_torch.train import step as tstep
from tests.synth import build_dataset

torch.set_num_threads(1)

SIZE = 64
KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
FROZEN = ("xyz", "rotation", "scaling", "opacity")


def model_args(root, model_path, **kw):
    args = dict(sh_degree=3, source_path=root, model_path=model_path, images="images",
                resolution=-1, white_background=False, data_device="cpu", eval=True,
                preload=False, split_yml_name="split.yml")
    args.update(kw)
    return SimpleNamespace(**args)


def to_port(g) -> tply.GaussianData:
    return tply.GaussianData(**{k: np.array(getattr(g, k)) for k in KEYS})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_scorp_pipeline.py's scorp_scene: a synthetic scene, an
    'object' (the 30% of Gaussians nearest the centroid), its RGBA masks and
    their union in masked_image_rgba/masked, the iteration-7000 model in a
    JAX and a port model directory, and both packages' scenes."""
    root = str(tmp_path_factory.mktemp("tscorp"))
    g, poses = build_dataset(root, n_views=8, width=SIZE, height=SIZE, n_gauss=48)
    d = np.linalg.norm(g.xyz - g.xyz.mean(axis=0), axis=1)
    obj_mask = d < np.quantile(d, 0.3)
    rgba_dir = os.path.join(root, "masked_image_rgba", "cup")
    masked_dir = os.path.join(root, "masked_image_rgba", "masked")
    os.makedirs(rgba_dir)
    os.makedirs(masked_dir)
    g_obj = g.select(obj_mask)
    for i, (R_c2w, T_w2c) in enumerate(poses):
        cam = make_camera_jax(R_c2w, T_w2c, 0.9, 0.9, SIZE, SIZE)
        out = rasterize_naive(
            jnp.asarray(g_obj.xyz), jnp.asarray(1 / (1 + np.exp(-g_obj.opacity[:, 0]))),
            cam, jnp.zeros(3),
            shs=jnp.asarray(np.concatenate([g_obj.f_dc, g_obj.f_rest], 1)), sh_degree=3,
            scales=jnp.asarray(np.exp(g_obj.scaling)), quats=jnp.asarray(g_obj.rotation),
        )
        alpha = (np.asarray(out.alpha[0]) > 0.5).astype(np.uint8) * 255
        rgb = (np.clip(np.asarray(out.color), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(np.dstack([rgb.transpose(1, 2, 0), alpha])).save(
            os.path.join(rgba_dir, f"img_{i:03d}.png"))
        scene_rgb = np.array(Image.open(os.path.join(root, "images", f"img_{i:03d}.png")))
        Image.fromarray(np.dstack([scene_rgb, alpha])).save(
            os.path.join(masked_dir, f"img_{i:03d}.png"))
    models = {}
    for name in ("jax", "torch"):
        models[name] = os.path.join(root, f"model_{name}")
        save_gaussian_ply(os.path.join(models[name], "point_cloud", "iteration_7000",
                                       "point_cloud.ply"), g)
    with open(os.path.join(root, "description.yml"), "w") as f:
        yaml.safe_dump({"prompts": "cup", "ext": "png", "img_num": 3, "num_iterations": 2,
                        "opt_shape_iterations": [1], "cam_list_interval": 2}, f)
    jscene = JScene(model_args(root, models["jax"]), load_iteration=7000, shuffle=False)
    tscene = TScene(model_args(root, models["torch"]), load_iteration=7000, shuffle=False)
    return SimpleNamespace(root=root, g=g, obj_mask=obj_mask, models=models,
                           jscene=jscene, tscene=tscene)


def _states(s):
    js = jfrom_gd(s.jscene.gaussians)
    ts = tstate.from_gaussian_data(to_port(s.tscene.gaussians), device="cpu")
    return js, ts


# --- mask lifting -----------------------------------------------------------------

@pytest.mark.parametrize("method", ["gradient", "binary", "projection"])
def test_vote_vectors_match_jax(scene, method):
    """Each camera's raw vote vector within 2e-5 · max(|v|, 1), the
    rasterizer-gradient tolerance of tests/test_torch_raster.py."""
    js, ts = _states(scene)
    jc, tc = jcfg(js.capacity), tcfg(ts.capacity)
    bg = np.zeros(3, np.float32)
    for jcam, tcam in zip(scene.jscene.get_train_cameras(), scene.tscene.get_train_cameras()):
        mask = jmask.load_mask_rgba(os.path.join(scene.root, "masked_image_rgba", "cup",
                                                 f"{jcam.image_name}.png"), jcam.resolution)
        cam = jcam.to_jax()
        if method == "projection":
            ref = jmask._projection_vote_step(js.params, js.alive, cam, jnp.asarray(mask),
                                              cfg=jc)
        elif method == "binary":
            m = jnp.asarray(mask.astype(np.float32))
            v_in = jmask._vote_step(js.params, js.alive, cam, m, jnp.asarray(bg), cfg=jc)
            v_out = jmask._vote_step(js.params, js.alive, cam, 1.0 - m, jnp.asarray(bg), cfg=jc)
            ref = (v_in > 0).astype(jnp.float32) - (v_out > 0).astype(jnp.float32)
        else:
            signed = jnp.asarray(np.where(mask, 1.0, -1.0).astype(np.float32))
            ref = jmask._vote_step(js.params, js.alive, cam, signed, jnp.asarray(bg), cfg=jc)
        ref = np.asarray(ref)
        got = tmask.camera_votes(ts, tcam.to_torch("cpu"), mask, torch.zeros(3), method,
                                 tc).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=jcam.image_name)
        if method == "gradient":
            assert np.abs(ref).max() > 0


def test_segmentation_masks_match_jax(scene):
    ref = jseg.mask3d(model_args(scene.root, scene.models["jax"]), None, iteration=7000)
    got = tseg.mask3d(model_args(scene.root, scene.models["torch"]), None, iteration=7000,
                      device="cpu")
    np.testing.assert_array_equal(got, ref)
    iou = (got[0] & scene.obj_mask).sum() / (got[0] | scene.obj_mask).sum()
    assert iou > 0.6  # TestSegmentation3D's criterion
    for name in ("cup.ply", "remained.ply"):
        a = load_gaussian_ply(os.path.join(scene.models["torch"], "gs_seg", name))
        b = load_gaussian_ply(os.path.join(scene.models["jax"], "gs_seg", name))
        for k in KEYS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_room_scene_selection_matches_jax():
    """chip_smoke.py's SCORP scene cut to size: bench.py's room distribution
    at 1/64 of its 250,000 Gaussians with 8x their scales (the same optical
    depth), 8 orbiting train views at 1/8 of 1600x1066, the object the
    cluster nearest the origin and its masks that cluster rendered alone.
    The summed gradient votes within 2e-5 · max(|v|, 1) of JAX's, the
    selections equal where |vote| > 1e-4 · max, so JAX's precision and
    recall against the cluster are the port's; and JAX's selection meets
    the smoke's bounds: at least half of the cluster, and at least half of
    it projecting into at least half of the masks."""
    import chip_smoke as cs
    from scorp_tpu_torch.core.camera import make_camera

    n, w, h = 250_000 // 64, 1600 // 8, 1066 // 8
    xyz, shs, scales, quats, opacity, cluster_idx, centers = cs.bench_scene_draw(n, 0)
    g = tply.GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                          opacity=np.log(opacity / (1 - opacity))[:, None].astype(np.float32),
                          scaling=np.log(8 * scales).astype(np.float32), rotation=quats)
    obj = cluster_idx == int(np.argmin(np.linalg.norm(centers, axis=1)))
    g_obj = g.select(obj)
    ts = tstate.from_gaussian_data(g, device="cpu")
    js = jfrom_gd(GaussianData(**{k: getattr(g, k) for k in KEYS}))
    jc, tc = jcfg(js.capacity), tcfg(ts.capacity)
    got, ref = torch.zeros(ts.capacity), np.zeros(js.capacity, np.float32)
    n_in = torch.zeros(ts.capacity)
    for i in range(2, 10):
        r_c2w, t_w2c = cs.orbit_pose(2 * np.pi * i / 10)
        cam = make_camera(r_c2w, t_w2c, cs.FOVX, cs.FOVY, w, h, device="cpu")
        mask = (trender(cam, g_obj, np.zeros(3, np.float32))["render_alpha"][0] > 0.5).numpy()
        got += tmask.camera_votes(ts, cam, mask, torch.zeros(3), "gradient", tc)
        n_in += tmask.projection_vote_step(ts, cam, torch.as_tensor(mask)) > 0
        signed = jnp.asarray(np.where(mask, 1.0, -1.0).astype(np.float32))
        ref += np.asarray(jmask._vote_step(
            js.params, js.alive, make_camera_jax(r_c2w, t_w2c, cs.FOVX, cs.FOVY, w, h),
            signed, jnp.zeros(3), cfg=jc))
    got, ref, n_in = got.numpy()[:n], ref[:n], n_in.numpy()[:n]
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(np.abs(ref).max(), 1.0))
    clear = np.abs(ref) > 1e-4 * np.abs(ref).max()
    sel, jsel = got > 0, ref > 0
    np.testing.assert_array_equal(sel[clear], jsel[clear])
    inter, jinter = int((sel & obj).sum()), int((jsel & obj).sum())
    print(f"selection {int(sel.sum())} (JAX {int(jsel.sum())}), {inter} (JAX {jinter}) of the "
          f"cluster's {int(obj.sum())}: precision {inter / sel.sum():.4f} "
          f"(JAX {jinter / jsel.sum():.4f})")
    assert jinter >= 0.5 * obj.sum()
    assert (jsel & (n_in >= 4)).sum() >= 0.5 * jsel.sum()


def test_surfel_vote_step_matches_jax(scene):
    """`vote_step(surfel=True)` (the scene's Gaussians as surfels, through
    the port's `rasterize_surfel`) within 2e-5 · max(|v|, 1) of the JAX
    package's `_vote_step(surfel=True)` on every camera; the all-ones
    override colours have `state.capacity` rows."""
    g = to_port(scene.g)
    g.scaling = np.ascontiguousarray(g.scaling[:, :2])
    ts = tstate.from_gaussian_data(g, device="cpu")
    js = jfrom_gd(GaussianData(**{k: getattr(g, k) for k in KEYS}))
    assert ts.capacity == js.capacity > g.n
    for jcam, tcam in zip(scene.jscene.get_train_cameras(), scene.tscene.get_train_cameras()):
        mask = jmask.load_mask_rgba(os.path.join(scene.root, "masked_image_rgba", "cup",
                                                 f"{jcam.image_name}.png"), jcam.resolution)
        signed = np.where(mask, 1.0, -1.0).astype(np.float32)
        ref = np.asarray(jmask._vote_step(js.params, js.alive, jcam.to_jax(),
                                          jnp.asarray(signed), jnp.zeros(3),
                                          cfg=jcfg(js.capacity), surfel=True))
        got = tmask.vote_step(ts, tcam.to_torch("cpu"), torch.as_tensor(signed),
                              torch.zeros(3), cfg=tcfg(ts.capacity), surfel=True).numpy()
        assert got.shape == (ts.capacity,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=jcam.image_name)


# --- view selection ----------------------------------------------------------------

def test_view_select_matches_jax(scene):
    jview.view_select(model_args(scene.root, scene.models["jax"]))
    tview.view_select(model_args(scene.root, scene.models["torch"]))
    sub = os.path.join("masked_image_rgba_selected", "cup")
    ref_dir, got_dir = (os.path.join(scene.models[n], sub) for n in ("jax", "torch"))
    files = sorted(os.listdir(got_dir))
    assert files == sorted(os.listdir(ref_dir)) and 1 <= len(files) <= 3
    for f in files:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(got_dir, f))),
                                      np.asarray(Image.open(os.path.join(ref_dir, f))))


# --- the device camera ---------------------------------------------------------------

def test_scaled_camera_renders_at_the_scaled_size_and_restores(scene):
    cam = scene.tscene.get_train_cameras()[0]
    state = tstate.from_gaussian_data(to_port(scene.g), device="cpu")
    orig = cam.to_torch("cpu")
    for k in range(3):
        cam.scale_resolution(1.5)
    w, h = cam.resolution
    assert (w, h) == (cam.image_width, cam.image_height) == (int(int(int(SIZE * 1.5) * 1.5)
                                                                 * 1.5),) * 2
    out = trender(cam.to_torch("cpu"), state, np.zeros(3, np.float32))
    assert tuple(out["render"].shape) == (3, h, w)
    cam.restore_resolution()
    assert cam.to_torch("cpu") is orig and cam.resolution == (SIZE, SIZE)
    cam.scale_fov(0.5, 0.5)
    assert cam.FoVx == pytest.approx(0.45) and cam.to_torch("cpu") is not orig
    cam.restore_fov()
    assert cam.to_torch("cpu") is orig
    jc = scene.jscene.get_train_cameras()[0]
    np.testing.assert_allclose(cam.camera_center, jc.camera_center, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cam.world_view_transform, jc.world_view_transform, rtol=0,
                               atol=1e-6)


# --- alignment ---------------------------------------------------------------------

def _proxy(obj):
    """TestAlignment's generated proxy: an SH0 copy of the segmented object,
    scaled 0.6, rotated 0.5 rad about z and translated."""
    proxy = GaussianData(xyz=obj.xyz.copy(), f_dc=obj.f_dc.copy(),
                         f_rest=np.zeros((obj.n, 0, 3), np.float32),
                         opacity=obj.opacity.copy(), scaling=obj.scaling.copy(),
                         rotation=obj.rotation.copy())
    angle = 0.5
    Rz = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                   [0, 0, 1.0]])
    jgst.gaussians_scale(proxy, 0.6)
    jgst.gaussians_rotate(proxy, Rz)
    jgst.gaussians_translate(proxy, np.array([0.8, -0.5, 0.4]))
    return proxy


@pytest.fixture(scope="module")
def aligned_inputs(scene):
    """The segmented object (the mask lifting's, from the JAX package) and
    its proxy in both model directories."""
    seg = jseg.mask3d(model_args(scene.root, scene.models["jax"]), None, iteration=7000)[0]
    obj = scene.g.select(seg)
    proxy = _proxy(obj)
    for m in scene.models.values():
        save_gaussian_ply(os.path.join(m, "gs_seg", "cup.ply"), obj)
        save_gaussian_ply(os.path.join(m, "generated", "cup.ply"), proxy)
    return obj, proxy


def test_get_pcd_pair_with_precomputed_matches_matches_jax(scene, aligned_inputs, tmp_path):
    """The same point pairs within 1e-4 from the same matches file."""
    obj, proxy = aligned_inputs
    bg = np.zeros(3, np.float32)
    jcams, tcams = scene.jscene.get_train_cameras(), scene.tscene.get_train_cameras()
    crops, depths, areas, xxyys = [], [], [], []
    for cam in jcams:
        with Image.open(os.path.join(scene.root, "masked_image_rgba", "cup",
                                     f"{cam.image_name}.png")) as pil:
            rgba = np.asarray(pil, np.float32).transpose(2, 0, 1) / 255.0
        mask = (rgba[3:4] > 0).astype(np.float32)
        depth = jalign._render_np(cam, obj, bg)["render_depth"] * mask
        img, dep, xxyy = jalign.crop_with_alpha(rgba[:3] * mask, mask, depth, border=200)
        crops.append(img)
        depths.append(dep)
        areas.append(float(mask.sum()))
        xxyys.append(xxyy)
    rng = np.random.default_rng(0)
    for idx in range(len(jcams)):
        # crops carry a 200 / 100 px border: points in the objects' boxes
        uv = np.stack([200 + rng.integers(0, 12, 40), 100 + rng.integers(0, 12, 40)], 1)
        np.savez(tmp_path / f"0_{idx}.npz", uv0=uv, uv1=uv[::-1])
    kw = dict(iteration=0, n_points_per_cam=16, cam_list_interval=1)
    ref = jalign.get_pcd_pair(proxy, jcams, bg, JMatcher(str(tmp_path)), crops, depths, areas,
                              xxyys, **kw)
    got = talign.get_pcd_pair(to_port(proxy), tcams, bg, TMatcher(str(tmp_path)), crops,
                              depths, areas, xxyys, device="cpu", **kw)
    assert len(ref[0]) > 10
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def _recording(fn, log):
    def wrapped(*args, **kwargs):
        log["inputs"] = (np.array(args[0]), np.array(args[1]))
        log["T"] = fn(*args, **kwargs)
        return log["T"]
    return wrapped


def test_align_with_sift_matches_jax_coarse_init(scene, aligned_inputs, monkeypatch):
    """The coarse init (bbox scale, centroid shift, 67-init ICP) within 1e-4
    of the JAX app's; after the render-match-solve rounds, TestAlignment's
    criterion (the matches come from SIFT on slightly different renders, so
    the rounds are not compared)."""
    obj, _ = aligned_inputs
    bank_dir = os.path.join(scene.root, "rotation_matrices")
    logs = {"jax": {}, "torch": {}}
    monkeypatch.setattr(jalign, "best_icp_transform",
                        _recording(jalign.best_icp_transform, logs["jax"]))
    monkeypatch.setattr(talign, "best_icp_transform",
                        _recording(talign.best_icp_transform, logs["torch"]))
    talign.align(model_args(scene.root, scene.models["torch"]), None, "cup",
                 num_iterations=2, opt_12dof_iterations=[1], rotations_path=bank_dir,
                 matcher_backend="sift", device="cpu")
    ref = jalign.align(model_args(scene.root, scene.models["jax"]), None, "cup",
                       num_iterations=2, opt_12dof_iterations=[1], rotations_path=bank_dir,
                       matcher_backend="sift")
    del ref
    for a, b in zip(logs["torch"]["inputs"], logs["jax"]["inputs"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logs["torch"]["T"], logs["jax"]["T"], rtol=0, atol=1e-4)
    got = tply.load_gaussian_ply(os.path.join(scene.models["torch"], "generated_aligned",
                                              "cup.ply"))
    c_err = np.linalg.norm(got.xyz.mean(0) - obj.xyz.mean(0))
    assert c_err < 0.35 * obj.xyz.std(), (c_err, obj.xyz.std())


# --- refinement --------------------------------------------------------------------

def _gt(scene, cam):
    with Image.open(os.path.join(scene.root, "masked_image_rgba", "masked",
                                 f"{cam.image_name}.png")) as pil:
        rgba = np.asarray(pil, np.float32).transpose(2, 0, 1) / 255.0
    return rgba[:3], rgba[3:4]


def test_refine_step_matches_jax(scene, aligned_inputs):
    """One step from random moments: the gradients (recovered from the first
    moments) within 2e-5 · max(scale, 1), the parameters within 1e-5
    (tests/test_torch_train.py's step tolerances), the frozen groups and
    their moments bit-unchanged."""
    _, proxy = aligned_inputs
    js = jfrom_gd(proxy)
    rng = np.random.default_rng(4)
    m = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in js.params.items()}
    v = {k: rng.uniform(1e-7, 1e-5, v.shape).astype(np.float32) for k, v in js.params.items()}
    jadam = jstate.AdamState({k: jnp.asarray(a) for k, a in m.items()},
                             {k: jnp.asarray(a) for k, a in v.items()}, jnp.int32(6))
    jcam, tcam = scene.jscene.get_train_cameras()[2], scene.tscene.get_train_cameras()[2]
    img, alpha = _gt(scene, jcam)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    js2, ja2, jm = jrefine.refine_step(js, jadam, jcam.to_jax(), jnp.asarray(img),
                                       jnp.asarray(alpha), jnp.int32(50), jnp.asarray(bg),
                                       opt=jstep.OptParams(), sh_degree=0, cfg=jcfg(js.capacity))
    ts = tstate.from_gaussian_data(to_port(proxy), device="cpu")
    tadam = tstate.adam_from_numpy(m, v, 6, "cpu")
    ts2, ta2, tm = trefine.refine_step(ts, tadam, tcam.to_torch("cpu"), torch.as_tensor(img),
                                       torch.as_tensor(alpha), 50, torch.as_tensor(bg),
                                       opt=tstep.OptParams(), sh_degree=0,
                                       cfg=tcfg(ts.capacity))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["l1"]) == pytest.approx(float(jm["l1"]), rel=1e-5)
    assert ta2.step == int(ja2.step) == 7
    for k in KEYS:
        if k in FROZEN:
            assert torch.equal(ts2.params[k], ts.params[k]), k
            assert torch.equal(ta2.m[k], tadam.m[k]) and torch.equal(ta2.v[k], tadam.v[k]), k
            continue
        g_ref = (np.asarray(ja2.m[k], np.float64) - 0.9 * m[k]) / 0.1
        g_got = (ta2.m[k].numpy().astype(np.float64) - 0.9 * m[k]) / 0.1
        gtol = 2e-5 * max(np.abs(g_ref).max(initial=0.0), 1.0)
        np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=gtol, err_msg=k)
        np.testing.assert_allclose(ts2.params[k].numpy(), np.asarray(js2.params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the last iteration computes the loss but takes no Adam step
    ts3, ta3, _ = trefine.refine_step(ts, tadam, tcam.to_torch("cpu"), torch.as_tensor(img),
                                      torch.as_tensor(alpha), 30, torch.as_tensor(bg),
                                      opt=tstep.OptParams(iterations=30), sh_degree=0,
                                      cfg=tcfg(ts.capacity))
    assert ta3.step == 6 and all(torch.equal(ts3.params[k], ts.params[k]) for k in KEYS)


def test_post_refine_matches_jax_app(scene, aligned_inputs):
    """10 iterations of both apps from the same aligned proxy, cameras in the
    same order (random.seed(0) before the JAX app, seed 0 in the port's):
    the refined PLYs within 1e-4, geometry bit-unchanged."""
    _, proxy = aligned_inputs
    for m in scene.models.values():
        shutil.rmtree(os.path.join(m, "generated_aligned"), ignore_errors=True)
        save_gaussian_ply(os.path.join(m, "generated_aligned", "cup.ply"), proxy)
    images = os.path.join("masked_image_rgba", "masked")
    opt_kw = dict(iterations=10)
    from scorp_tpu.config import OptimizationParams as JOpt
    from scorp_tpu_torch.config import OptimizationParams as TOpt

    random.seed(0)
    jrefine_app.training(model_args(scene.root, scene.models["jax"], sh_degree=0, images=images),
                         JOpt(**opt_kw), None, quiet=True)
    random.seed(12345)  # the port's order must not depend on the global state
    _, log = trefine_app.training(
        model_args(scene.root, scene.models["torch"], sh_degree=0, images=images),
        TOpt(**opt_kw), None, quiet=True, device="cpu", seed=0)
    assert len(log["loss"]) == 10 and all(np.isfinite(log["loss"]))
    for name in ("cup.ply", "refined_10.ply"):
        a = tply.load_gaussian_ply(os.path.join(scene.models["torch"], "refined_aligned", name))
        b = load_gaussian_ply(os.path.join(scene.models["jax"], "refined_aligned", name))
        for k in KEYS:
            np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=0, atol=1e-4,
                                       err_msg=f"{name} {k}")
        for k in FROZEN:
            np.testing.assert_array_equal(getattr(a, k), getattr(proxy, k))


# --- the apps' device rule -------------------------------------------------------------

@pytest.mark.parametrize("app", [tseg, tview, talign, trefine_app, tseg2d, talign2d,
                                 textract, ttrellis, ttrunc])
def test_apps_raise_without_gpu(scene, app, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-m", os.path.join(scene.root, "model_nogpu")]
    if app not in (ttrellis, ttrunc):  # the two proxy stages take no scene
        argv = ["-s", scene.root, *argv]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(argv)
