"""Port parity, mesh extraction: scorp_tpu_torch's marching cubes, surface
nets, TSDF fusion (bounded and contracted), floater removal, mesh PLY
writer and the extract_mesh app, all on the CPU, against scorp_tpu's on the
same numpy inputs; plus tests/test_aux.py's TestMesh gates on the port."""

import os
import shutil

import numpy as np
import pytest
import torch

from scorp_tpu.apps import extract_mesh as japp
from scorp_tpu.pipeline import marching_cubes as jmc
from scorp_tpu.pipeline import mesh as jmesh
from scorp_tpu.scene.cameras import Camera as JCamera
from scorp_tpu_torch.apps import extract_mesh as tapp
from scorp_tpu_torch.apps import train_2dgs as ttrain2d
from scorp_tpu_torch.pipeline import marching_cubes as tmc
from scorp_tpu_torch.pipeline import mesh as tmesh
from scorp_tpu_torch.scene.cameras import Camera as TCamera
from tests.synth import build_dataset, orbit_pose

torch.set_num_threads(1)


# --- triangulation (host numpy in both packages) -----------------------------------

def test_marching_cubes_tables_equal_jax():
    for name in ("TRI_TABLE", "LOOP_MASK", "CORNER_OFFSETS", "EDGE_AXIS", "EDGE_BASE"):
        np.testing.assert_array_equal(getattr(tmc, name), getattr(jmc, name), err_msg=name)
    assert tmc.EDGE_PAIRS == jmc.EDGE_PAIRS and tmc.MAX_LOOPS == jmc.MAX_LOOPS


def _seeded_tsdf(n=20, seed=0):
    """A noisy sphere TSDF with an unobserved slab and random colours."""
    rng = np.random.default_rng(seed)
    g = (np.arange(n) + 0.5) / n * 2.4 - 1.2
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    tsdf = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.8 + rng.normal(0, 0.05, x.shape))
    weight = rng.integers(1, 4, x.shape).astype(np.float32)
    weight[:3] = 0.0
    colors = rng.uniform(size=x.shape + (3,)).astype(np.float32)
    return tsdf.astype(np.float32), weight, colors


@pytest.mark.parametrize("method", ["marching_cubes", "surface_nets"])
def test_triangulation_matches_jax(method):
    """Vertices and colours within 1e-6, faces equal."""
    tsdf, weight, colors = _seeded_tsdf()
    origin, vs = np.full(3, -1.2), 2.4 / 20
    ref = jmesh._triangulate(method)(tsdf, weight, origin, vs, colors)
    got = tmesh._triangulate(method)(tsdf, weight, origin, vs, colors)
    assert len(ref[1]) > 100
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-6)
    # no colours: zero colours in both
    got_nc = tmesh._triangulate(method)(tsdf, weight, origin, vs)
    np.testing.assert_array_equal(got_nc[1], ref[1])
    assert not np.asarray(got_nc[2]).any()


# --- TSDF fusion on the analytic sphere ----------------------------------------------

R_SPHERE, SIZE = 0.8, 64


def _cams(cls, n=12):
    out = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False):
        R, T = orbit_pose(a, radius=3.0, height=0.0)
        out.append(cls(0, R, T, 0.9, 0.9, (SIZE, SIZE), "/dev/null", image_name=f"c{a:.2f}"))
    return out


def _sphere_maps(cam):
    """tests/test_aux.py's analytic sphere depth (view z of the ray hit), and
    a seeded colour image."""
    cj = cam.to_jax()
    w = h = SIZE
    fx = w / (2 * float(cj.tanfovx))
    fy = h / (2 * float(cj.tanfovy))
    view_t = np.asarray(cj.viewmatrix)
    c2w = np.linalg.inv(view_t.T)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs = np.stack([(xs - w / 2 + 0.5) / fx, (ys - h / 2 + 0.5) / fy, np.ones((h, w))], -1)
    dirs_w = dirs @ c2w[:3, :3].T
    o = c2w[:3, 3]
    b = 2 * (dirs_w @ o)
    a = (dirs_w ** 2).sum(-1)
    c = (o @ o) - R_SPHERE ** 2
    disc = b ** 2 - 4 * a * c
    t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    hit = o + t[..., None] * dirs_w
    view = np.concatenate([hit, np.ones((h, w, 1))], -1) @ view_t
    depth = np.where(t > 0, view[..., 2], 0.0)
    seed = int(round(float(np.arctan2(o[0], o[2])) * 1000)) % 2 ** 31
    color = np.random.default_rng(seed).uniform(size=(3, h, w)).astype(np.float32)
    return {"render": color, "render_depth": depth[None].astype(np.float32)}


@pytest.fixture(scope="module")
def sphere():
    jcams, tcams = _cams(JCamera), _cams(TCamera)
    maps = {c.image_name: _sphere_maps(c) for c in jcams}
    return jcams, tcams, lambda cam: maps[cam.image_name]


@pytest.mark.parametrize("bounded", [True, False])
def test_tsdf_fuse_matches_jax(sphere, bounded, monkeypatch):
    """The same depth and colour maps: weights equal, tsdf and colours
    within 1e-5 (bounded: tests/test_aux.py's knobs; contracted: 32^3,
    its grids read where both packages hand them to the triangulation)."""
    jcams, tcams, maps = sphere
    if bounded:
        kw = dict(voxel_size=0.05, sdf_trunc=0.15, depth_trunc=5.0, max_resolution=64)
        ref = jmesh.tsdf_fuse(maps, jcams, np.zeros(3), 1.2, **kw)
        got = tmesh.tsdf_fuse(maps, tcams, np.zeros(3), 1.2, device="cpu", **kw)
        grids = zip(got[:3], ref[:3])
        assert got[4] == ref[4]
        np.testing.assert_array_equal(got[3], ref[3])
    else:
        seen = {}
        for key, mod in (("jax", jmesh), ("torch", tmesh)):
            def recording(method, key=key, real=mod._triangulate):
                def wrapped(*args):
                    seen[key] = [np.asarray(a) for a in args[:3]]
                    return real(method)(*args)
                return wrapped
            monkeypatch.setattr(mod, "_triangulate", recording)
        ref = jmesh.tsdf_fuse_unbounded(maps, jcams, np.zeros(3), 1.0, resolution=32)
        got = tmesh.tsdf_fuse_unbounded(maps, tcams, np.zeros(3), 1.0, resolution=32,
                                        device="cpu")
        grids = zip(seen["torch"], seen["jax"])
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)
    (tsdf_g, tsdf_r), (w_g, w_r), (c_g, c_r) = grids
    assert (w_r > 0).mean() > 0.05 and w_r.max() >= 3
    np.testing.assert_array_equal(w_g, w_r)
    np.testing.assert_allclose(tsdf_g, tsdf_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(c_g, c_r, rtol=0, atol=1e-5)


# --- tests/test_aux.py TestMesh's gates, on the port ---------------------------------

def test_sphere_extraction(sphere):
    """Analytic sphere depth maps -> mesh vertices near the radius."""
    _, tcams, maps = sphere
    ex = tmesh.GaussianExtractor(maps, tcams, device="cpu")
    verts, faces, _ = ex.extract_mesh_bounded(np.zeros(3), 1.2, voxel_size=0.05, sdf_trunc=0.15,
                                              depth_trunc=5.0, max_resolution=64)
    assert len(verts) > 100 and len(faces) > 100
    radii = np.linalg.norm(verts, axis=1)
    assert np.median(np.abs(radii - R_SPHERE)) < 0.06, np.median(radii)


def _watertight(f):
    de = {}
    for tri in f:
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            de[(a, b)] = de.get((a, b), 0) + 1
    ok = all(n == 1 for n in de.values()) and all((b, a) in de for (a, b) in de)
    return ok, len(de) // 2


def test_marching_cubes_topology():
    """Watertight, Euler characteristic, outward normals, the all-ambiguous
    binary field, and unobserved voxels masked."""
    n = 32
    g = (np.arange(n) + 0.5) / n * 3.2 - 1.6
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    w = np.ones((n, n, n))
    sph = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.0
    v, f, _ = tmc.marching_cubes(sph, w, np.full(3, -1.6), 3.2 / n)
    ok, e = _watertight(f)
    assert ok and len(v) - e + len(f) == 2
    r = np.linalg.norm(v, axis=1)
    assert r.min() > 0.98 and r.max() < 1.02
    nrm = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    cen = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3
    assert ((nrm * cen).sum(1) > 0).all()
    tor = np.sqrt((np.sqrt(x ** 2 + y ** 2) - 1.0) ** 2 + z ** 2) - 0.4
    v, f, _ = tmc.marching_cubes(tor, w, np.full(3, -1.6), 3.2 / n)
    ok, e = _watertight(f)
    assert ok and len(v) - e + len(f) == 0
    rng = np.random.default_rng(3)
    b = np.where(rng.normal(size=(n, n, n)) > 0, 1.0, -1.0)
    b[[0, -1], :, :] = 1.0
    b[:, [0, -1], :] = 1.0
    b[:, :, [0, -1]] = 1.0
    v, f, _ = tmc.marching_cubes(b, w, np.zeros(3), 1.0)
    assert _watertight(f)[0]
    w2 = w.copy()
    w2[:5] = 0.0
    v, f, _ = tmc.marching_cubes(sph, w2, np.full(3, -1.6), 3.2 / n)
    assert len(f) > 0 and (v[:, 0] > -1.6 + 4 * 3.2 / n).all()


def _sheet_with_floaters(G=8):
    xs, ys = np.meshgrid(np.arange(G + 1), np.arange(G + 1), indexing="ij")
    grid_verts = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)

    def vid(i, j):
        return i * (G + 1) + j

    main = []
    for i in range(G):
        for j in range(G):
            main.append([vid(i, j), vid(i + 1, j), vid(i, j + 1)])
            main.append([vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)])
    verts, faces, base = [grid_verts.astype(float)], [np.asarray(main)], len(grid_verts)
    for k in range(3):
        tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]) + [100.0 + 10 * k, 0, 0]
        verts.append(tet)
        faces.append(base + np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]))
        base += 4
    faces.append(np.array([[vid(0, 0), vid(0, 0), vid(0, 1)]]))  # degenerate
    verts = np.concatenate(verts)
    return verts, np.concatenate(faces), len(grid_verts), 2 * G * G


def test_post_process_mesh_removes_floaters():
    verts, faces, n_sheet, n_main = _sheet_with_floaters()
    colors = np.linspace(0, 1, len(verts))[:, None].repeat(3, 1)
    pv, pf, pc = tmesh.post_process_mesh(verts, faces, colors, cluster_to_keep=1000)
    assert len(pf) == n_main and len(pv) == n_sheet
    assert pf.min() >= 0 and pf.max() < len(pv)
    assert np.abs(pv[:, 2]).max() == 0.0 and pv[:, 0].max() <= 8
    np.testing.assert_allclose(pc, colors[:n_sheet])
    assert len(tmesh.post_process_mesh(verts, faces, colors, cluster_to_keep=1)[1]) == n_main


@pytest.mark.parametrize("keep", [1, 3, 1000])
def test_post_process_mesh_matches_jax(keep):
    """A marching-cubes mesh of a noisy field (many clusters, some above the
    50-triangle floor) plus the floater sheet: the same kept faces,
    vertices and colours as the JAX package's union-find."""
    rng = np.random.default_rng(7)
    field = rng.normal(size=(24, 24, 24))
    for _ in range(2):  # smooth, so blobs of a few hundred triangles form
        field = sum(np.roll(field, s, a) for a in range(3) for s in (-1, 0, 1)) / 9
    v, f, c = tmc.marching_cubes(field - 0.35, np.ones_like(field), np.zeros(3), 1.0,
                                 rng.uniform(size=field.shape + (3,)))
    sv, sf, _, _ = _sheet_with_floaters()
    v = np.concatenate([v, sv])
    f = np.concatenate([f, sf + len(v) - len(sv)])
    c = np.concatenate([c, np.zeros((len(sv), 3))])
    ref = jmesh.post_process_mesh(v, f, c, cluster_to_keep=keep)
    got = tmesh.post_process_mesh(v, f, c, cluster_to_keep=keep)
    assert 0 < len(ref[1]) < len(f)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    empty = tmesh.post_process_mesh(v, f[:0], c)
    assert len(empty[0]) == len(empty[1]) == len(empty[2]) == 0


@pytest.mark.parametrize("with_colors", [True, False])
def test_save_mesh_ply_bytes_equal_jax(tmp_path, with_colors):
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(40, 3))
    faces = rng.integers(0, 40, (70, 3))
    colors = rng.uniform(-0.2, 1.2, (40, 3)) if with_colors else None
    jmesh.save_mesh_ply(str(tmp_path / "j.ply"), verts, faces, colors)
    tmesh.save_mesh_ply(str(tmp_path / "sub" / "t.ply"), verts, faces, colors)
    data = (tmp_path / "sub" / "t.ply").read_bytes()
    assert data == (tmp_path / "j.ply").read_bytes()
    assert b"element vertex 40" in data and b"element face 70" in data


def test_mesh_ply_roundtrip(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    path = str(tmp_path / "m.ply")
    tmesh.save_mesh_ply(path, verts, np.array([[0, 1, 2]]), np.ones((3, 3)) * 0.5)
    data = open(path, "rb").read()
    assert b"element vertex 3" in data and b"element face 1" in data
    body = data[data.index(b"end_header\n") + len(b"end_header\n"):]
    rec = np.frombuffer(body[:45], np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
    np.testing.assert_array_equal(rec["xyz"], verts.astype(np.float32))
    assert (rec["rgb"] == 127).all()
    face = np.frombuffer(body[45:], np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    assert face["n"][0] == 3 and face["i"][0].tolist() == [0, 1, 2]


def test_contract_uncontract_match_jax():
    x = np.random.default_rng(8).normal(0, 2, (500, 3))
    np.testing.assert_allclose(tmesh.contract(x), jmesh.contract(x), rtol=0, atol=1e-6)
    y = tmesh.contract(x)
    np.testing.assert_allclose(tmesh.uncontract(y), jmesh.uncontract(y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmesh.uncontract(y), x, rtol=1e-5, atol=1e-6)


# --- the app ------------------------------------------------------------------------

def _mesh_ply(path):
    data = open(path, "rb").read()
    head, body = data.split(b"end_header\n", 1)
    n = int(head.split(b"element vertex ")[1].split()[0])
    f = int(head.split(b"element face ")[1].split()[0])
    v = np.frombuffer(body[:15 * n], np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
    faces = np.frombuffer(body[15 * n:], np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    assert len(faces) == f
    return v["xyz"], v["rgb"], faces["i"]


@pytest.fixture(scope="module")
def trained_2dgs(tmp_path_factory):
    """A 5-iteration 2DGS model of synth.py's scene, trained by the port."""
    root = tmp_path_factory.mktemp("mesh")
    scene = str(root / "scene")
    build_dataset(scene, n_views=6, width=48, height=36, n_gauss=48)
    model = str(root / "model")
    ttrain2d.main(["-s", scene, "-m", model, "--quiet", "--iterations", "5",
                   "--densify_until_iter", "0", "--test_iterations", "-1",
                   "--device", "cpu"])
    return root, scene, model


def test_extract_matches_jax_app(trained_2dgs):
    """Both apps' CLIs on copies of the same model (mesh_res 48):
    fuse.ply and fuse_post.ply with equal vertex and face counts, faces
    equal, vertices within 1e-4, colours within 1 (of 255)."""
    root, scene, model = trained_2dgs
    out = {}
    for name, app, extra in (("jax", japp, []), ("torch", tapp, ["--device", "cpu"])):
        out[name] = str(root / f"model_{name}")
        shutil.copytree(model, out[name])
        app.main(["-s", scene, "-m", out[name], "--mesh_res", "48", "--num_cluster", "5",
                  *extra])
    for fname in ("fuse.ply", "fuse_post.ply"):
        jv, jc, jf = _mesh_ply(os.path.join(out["jax"], "train", "ours_5", fname))
        tv, tc, tf = _mesh_ply(os.path.join(out["torch"], "train", "ours_5", fname))
        assert len(tv) == len(jv) > 50 and len(tf) == len(jf) > 50, fname
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=fname)
        assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1
