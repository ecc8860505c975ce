"""The TSDF grid object (`pipeline/mesh.py:TsdfVolume`) and kernel T
(`csrc/tsdf_fuse.cu`, wrapper `ops/tsdf.py:tsdf_fuse`).

On the CPU: `_voxel_centres` in blocks against the whole-grid numpy
coordinates the fusion built before the grid object, for both grid kinds;
`TsdfVolume.integrate` (the plain update in blocks) against the benchmark's
plain reference (`bench_port/reference/tsdf.py`) on maps that `render2d`'s
plain path renders from seeded random surfels; the reference with its voxel
centres in float32 (the benchmark's control) failing the cell's limits;
the counters, the span, T's brick layout, the readers and the work model;
and the `room2dgs-mesh-fuse` cell run whole at a tiny size in a fresh
process. On the card (marked `cuda`, skipped elsewhere): T against the
plain update bit for bit at 64^3 and 256^3 for both kinds, over the whole
grid after three views for 102 seeded poses a kind at 37^3 to 256^3 (the
brick cull's hard cases among them), at 1024^3 on seeded blocks of voxels
and, for two of the room's views, over the whole contracted 1024^3 grid;
its launch and brick counters, and the device memory of a 1024^3 grid. On
a GPU machine:

    python -m pytest tests/test_torch_tsdf_fuse.py -q
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench_port import room
from bench_port.loops.fuse2d import train_views
from bench_port.reference import camera as ref_camera
from bench_port.reference import tsdf as ref_tsdf
from scorp_tpu_torch.core.camera import make_camera
from scorp_tpu_torch.ops import tsdf as tsdf_ops
from scorp_tpu_torch.ops.tsdf import tsdf_fuse
from scorp_tpu_torch.pipeline import mesh
from scorp_tpu_torch.pipeline.mesh import TsdfVolume, _voxel_centres
from scorp_tpu_torch.render2d import render2d
from scorp_tpu_torch.scene.dataset_readers import nerfpp_norm
from scorp_tpu_torch.train import GaussianState, state_from_numpy
from scorp_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
FOVX = 1.0
FOVY = 2.0 * math.atan(math.tan(FOVX / 2) * H / W)
CENTER = np.array([0.0, 0.0, 3.5])
RADIUS = 2.0
# the benchmark cell's limits (bench_port/limits/room2dgs-mesh-fuse.json)
with open(os.path.join(ROOT, "bench_port", "limits", "room2dgs-mesh-fuse.json")) as _f:
    CELL_LIMITS = json.load(_f)["limits"]


# ---------------------------------------------------------------- voxel centres


def _whole_grid(kind: str, res: int, base, scale: float) -> np.ndarray:
    """[R^3, 3] f32: the voxel centres as tsdf_fuse (bounded, per axis in
    float64 torch) and tsdf_fuse_unbounded (contracted, numpy float64) made
    them for the whole grid before the grid object."""
    if kind == "bounded":
        idx = torch.arange(res, dtype=torch.float64)
        axes = [((idx + 0.5) * scale + float(base[a])).to(torch.float32) for a in range(3)]
        g = torch.meshgrid(*axes, indexing="ij")
        return torch.stack(g, -1).reshape(-1, 3).numpy()
    idx = np.arange(res)
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    step = 4.0 / res
    contracted = (np.stack([gx, gy, gz], -1).reshape(-1, 3) + 0.5) * step - 2.0
    cnorm = np.linalg.norm(contracted, axis=-1, keepdims=True)
    contracted = np.where(cnorm >= 1.98, contracted * (1.98 / np.maximum(cnorm, 1e-9)),
                          contracted)
    world = mesh.uncontract(contracted) * scale + np.asarray(base)
    return world.astype(np.float32)


GRID_ARGS = {"bounded": (CENTER - RADIUS, 2 * RADIUS / 48), "contracted": (CENTER, RADIUS)}


@pytest.mark.parametrize("res", [32, 48])
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_voxel_centres_in_blocks_equal_the_whole_grid(kind, res):
    base, scale = GRID_ARGS[kind]
    want = _whole_grid(kind, res, base, scale)
    block = 1237  # not a multiple of a row or a plane
    got = np.concatenate([_voxel_centres(kind, res, base, scale, s, min(s + block, res ** 3))
                          for s in range(0, res ** 3, block)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_reference_centres_equal_the_program_centres(kind):
    """The reference's centres from the flat index (torch float64) are the
    program's (numpy float64), bit for bit."""
    res = 48
    base, scale = GRID_ARGS[kind]
    grid = dict(kind=kind, res=res, base=list(base), scale=scale)
    got = ref_tsdf.voxel_centres(torch.arange(res ** 3), grid).numpy()
    np.testing.assert_array_equal(got, _voxel_centres(kind, res, base, scale, 0, res ** 3))


# ---------------------------------------------------------------- maps and grids


def _scene(seed: int, n: int = 3000):
    """n random surfels 2-5 in front of a camera at the origin, 5% dead."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(2.0, 5.0, n)], 1)
    params = dict(xyz=xyz, f_dc=rng.normal(0, 0.5, (n, 1, 3)),
                  f_rest=rng.normal(0, 0.05, (n, 15, 3)),
                  scaling=np.log(rng.uniform(0.05, 0.2, (n, 2))),
                  rotation=rng.normal(size=(n, 4)), opacity=rng.normal(1.0, 1.5, (n, 1)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return params, rng.uniform(size=n) > 0.05


def _poses(n=3):
    """Cameras near the origin looking along +z, turned a little each."""
    out = []
    for i in range(n):
        a = 0.12 * (i - 1)
        R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                      [-math.sin(a), 0.0, math.cos(a)]])  # camera-to-world
        c = np.array([0.3 * (i - 1), 0.1 * i, 0.0])
        out.append(dict(R=R, T=-R.T @ c, fovx=FOVX, fovy=FOVY))
    return out


@pytest.fixture(scope="module")
def views():
    """[(depth [H, W], color [3, H, W], program camera, reference camera)]
    of render2d's plain path at depth_ratio 1 on seeded random surfels."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        params, alive = _scene(5)
        state = state_from_numpy(params, alive, device="cpu")
        out = []
        for pose in _poses():
            cam = make_camera(pose["R"], pose["T"], pose["fovx"], pose["fovy"], W, H,
                              device="cpu")
            maps = render2d(cam, state, torch.zeros(3), sh_degree=3, depth_ratio=1.0)
            out.append((maps["render_depth"][0].contiguous(), maps["render"].contiguous(), cam,
                        ref_camera.camera(pose, W, H, torch.device("cpu"))))
        return out
    finally:
        torch.set_num_threads(n)


def _volume(kind: str, res: int = 48, device="cpu") -> TsdfVolume:
    if kind == "bounded":
        return TsdfVolume.bounded(CENTER, RADIUS, 2 * RADIUS / res, sdf_trunc=0.25,
                                  depth_trunc=6.0, max_resolution=res, device=device)
    return TsdfVolume.contracted(CENTER, RADIUS, res, sdf_trunc_vox=4.0, depth_trunc=6.0,
                                 device=device)


def _grid_dict(v: TsdfVolume) -> dict:
    return dict(kind=v.kind, res=v.res, base=list(v.base), scale=v.scale, sdf_trunc=v.sdf_trunc,
                depth_trunc=v.depth_trunc)


def _reference_fusion(v: TsdfVolume, views, dtype=torch.float64) -> dict:
    grid = _grid_dict(v)
    centres = ref_tsdf.voxel_centres(torch.arange(v.voxels), grid, dtype)
    state = dict(tsdf=torch.ones(v.voxels), weight=torch.zeros(v.voxels),
                 colors=torch.zeros(v.voxels, 3))
    for depth, color, _, cam in views:
        state = ref_tsdf.update(state, centres, depth, color, cam, grid)
    return state


@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_integrate_matches_the_plain_reference(views, kind):
    """Three views fused: weights, tsdf and colours bit for bit (the
    reference and the plain update round the same operations in the same
    order; the reference reaches the taps through its own camera and the
    centres through torch instead of numpy)."""
    v = _volume(kind)
    for depth, color, cam, _ in views:
        v.integrate(depth, color, cam)
    ref = _reference_fusion(v, views)
    assert int((ref["weight"] > 0).sum()) > 1000 and float(ref["weight"].max()) == 3.0
    assert torch.equal(v.weight, ref["weight"])
    assert torch.equal(v.tsdf, ref["tsdf"])
    assert torch.equal(v.colors, ref["colors"])


def test_control_fails_the_cell_limits(views):
    """The reference with its voxel centres in float32 misses at least one
    of the cell's limits against the float64 reference."""
    v = _volume("contracted")
    want = _reference_fusion(v, views)
    low = _reference_fusion(v, views, torch.float32)
    readings = dict(weight_mismatch=float((want["weight"] != low["weight"]).sum()),
                    tsdf_gap=float((want["tsdf"] - low["tsdf"]).abs().max()),
                    color_gap=float((want["colors"] - low["colors"]).abs().max()))
    assert any(readings[k] > CELL_LIMITS[k] for k in CELL_LIMITS), readings


def test_plain_blocks_do_not_change_the_grid(views, monkeypatch):
    a, b = _volume("contracted"), _volume("contracted")
    for depth, color, cam, _ in views:
        a.integrate_plain(depth, color, cam)
    monkeypatch.setattr(mesh, "PLAIN_BLOCK", 999)
    for depth, color, cam, _ in views:
        b.integrate_plain(depth, color, cam)
    for name in ("tsdf", "weight", "colors"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_grids_and_kinds():
    v = _volume("bounded", res=8)
    tsdf, weight, colors = v.grids()
    assert tsdf.shape == weight.shape == (8, 8, 8) and colors.shape == (8, 8, 8, 3)
    assert (tsdf == 1).all() and not weight.any() and not colors.any()
    with pytest.raises(ValueError, match="grid kind"):
        TsdfVolume("sparse", 8, CENTER, 1.0, 0.1, 3.0, device="cpu")


def test_counters_on_the_cpu(views):
    """The CPU path launches no kernel: `tsdf_fuse.launches` and `.bricks`
    stay put while the plain update fuses every view, and no device count
    of live bricks is made."""
    v = _volume("contracted", res=16)
    launches, bricks = tsdf_fuse.launches, tsdf_fuse.bricks
    for depth, color, cam, _ in views:
        v.integrate(depth, color, cam)
    assert float(v.weight.max()) == 3.0
    assert (tsdf_fuse.launches, tsdf_fuse.bricks) == (launches, bricks)
    assert tsdf_fuse.live_bricks() == 0


@pytest.mark.parametrize("res, lattice_log2, bricks", [
    (37, 0, 5 ** 3), (100, 0, 13 ** 3), (128, 0, 16 ** 3), (256, 1, 32 ** 3),
    (512, 2, 64 ** 3), (1024, 2, 128 ** 3)])
def test_brick_layout(res, lattice_log2, bricks):
    """8^3 bricks, partial at the far faces; a block tests 4^3 of them
    where that still makes MIN_BLOCKS blocks, else 2^3 or one, and no grid
    up to 1024^3 makes more than ~10^5 blocks."""
    brick_log2, lg, n = tsdf_ops.brick_layout(res)
    assert (brick_log2, lg, n) == (3, lattice_log2, bricks)
    side = -(-res // 8)
    blocks = (-(-side // (1 << lg))) ** 3
    assert blocks <= 1 << 17
    assert blocks >= tsdf_ops.MIN_BLOCKS or lg == 0
    assert (1 << lg) ** 3 <= 64  # a block's 64 threads test one brick each


def test_wrapper_refuses_cpu_tensors(views):
    v = _volume("bounded", res=8)
    depth, color, cam, _ = views[0]
    launches = tsdf_fuse.launches
    with pytest.raises(ValueError, match="TsdfVolume.integrate runs the plain version"):
        tsdf_fuse(v.tsdf, v.weight, v.colors, depth, color, cam, contracted=False, res=8,
                  base=v.base, scale=v.scale, sdf_trunc=v.sdf_trunc, depth_trunc=v.depth_trunc)
    assert tsdf_fuse.launches == launches


def test_mesh_fuse_span(views):
    """`mesh.fuse` opens once per integrate under a profiler; a no-op
    otherwise."""
    v = _volume("contracted", res=8)
    depth, color, cam, _ = views[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v.integrate(depth, color, cam)
        v.integrate(depth, color, cam)
    names = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
    assert names.count("mesh.fuse") == 2
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("mesh.fuse") is trace._OFF


# ---------------------------------------------------------------- readers and work model


def _reader(name):
    path = os.path.join(ROOT, "bench_port", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _label(count, busy_s):
    return dict(count=count, host_s=2 * busy_s, device_span_s=1.5 * busy_s, device_busy_s=busy_s)


def test_fuse_ms_reader():
    labels = {"unit.fuse": _label(20, 0.0), "mesh.fuse": _label(20, 0.1)}
    ctx = dict(loop="fuse2d", profile=dict(labels=labels))
    read = _reader("fuse_ms.mesh").read
    assert read(ctx) == pytest.approx(1e3 * 0.1 / 20)
    # a program that opens no such span, or another loop: silent
    assert read(dict(ctx, profile=dict(labels={"unit.fuse": labels["unit.fuse"]}))) is None
    assert read(dict(ctx, loop="render")) is None


def test_tsdf_roofline_reader():
    kernels = [["(anonymous namespace)::tsdf_fuse_kernel((anonymous namespace)::Grid, long)",
                0.04], ["void (anonymous namespace)::surfel_composite_kernel<false>()", 0.5]]
    ctx = dict(loop="fuse2d", primitive="2dgs", least_s={"tsdf_fuse": 0.01},
               profile=dict(kernels=kernels))
    read = _reader("tsdf_roofline_pct.mesh").read
    assert read(ctx) == pytest.approx(25.0)
    assert read(dict(ctx, loop="render")) is None
    assert read(dict(ctx, profile=dict(kernels=kernels[1:]))) is None


def test_tsdf_work_counts():
    from bench_port import harness

    c = harness.work_part("tsdf_fuse").cost(dict(inside=1000, valid=300, pixels=50))
    assert (c["flops"], c["bytes"]) == (41 * 1000 + 49 * 300, 40 * 300 + 16 * 50)


def test_work_counts_come_from_the_reference_masks(views, monkeypatch):
    """`counts` and `valid_indices` over the whole grid in blocks equal the
    masks of one pass."""
    v = _volume("contracted", res=24)
    grid = _grid_dict(v)
    pairs = [(depth, cam) for depth, _, _, cam in views]
    monkeypatch.setattr(ref_tsdf, "BLOCK", 1000)
    got = ref_tsdf.counts(grid, pairs)
    centres = ref_tsdf.voxel_centres(torch.arange(v.voxels), grid)
    for (inside, valid), (depth, cam) in zip(got, pairs):
        m = ref_tsdf.masks(centres, depth, cam, grid)
        assert (inside, valid) == (int(m["inside"].sum()), int(m["valid"].sum()))
        assert inside >= valid > 0
        assert torch.equal(ref_tsdf.valid_indices(grid, depth, cam), m["valid"].nonzero()[:, 0])


# ------------------------------------------------ the cell, tiny, in a fresh process

TINY = dict(n_gaussians=3000, width=96, height=64, n_views=16, test_every=8)
TINY_TRAFFIC = dict(sampled_voxels=24 ** 3, traced_units=2, counted_units=1, warmup_frames=1,
                    sampled_from_first=4, sampled_frames=2)
CPU_RATES = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12, "pcie_bytes_per_s": 64e9}
CELL_RUN = """
import json, tempfile, time, torch
from bench_port import harness
torch.set_num_threads(2)
cell = harness.cell_of("room2dgs-mesh-fuse")
cell["config"].update(%r)
cell["config"]["mesh"]["mesh_res"] = 24
cell["traffic"].update(%r)
with tempfile.TemporaryDirectory() as tmp:
    res = harness.run_cell(cell, 2**31 + 777, 0.3, True, torch.device("cpu"), time.time(),
                           tmp, {"peaks": %r})
print(json.dumps(dict(result=res, forbidden=harness.loaded_forbidden(),
                      per_layer=[m["name"] for m in cell["per_layer"]],
                      end_to_end=[m["name"] for m in cell["end_to_end"]])))
""" % (TINY, TINY_TRAFFIC, CPU_RATES)


@pytest.fixture(scope="module")
def tiny_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CELL_RUN], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_tiny_cell_is_correct(tiny_run):
    got, err = tiny_run
    res = got["result"]
    assert res is not None and res["correct"], res and res["checks"]
    assert set(res["checks"]) == {"weight_mismatch", "tsdf_gap", "color_gap"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "valid sampled voxels per sampled frame" in err
    assert "kernel T launches per view 0.000 (tsdf_fuse.launches)" in err
    assert got["end_to_end"] == ["setup_s", "frame_ms", "frame_p95_ms"]


def test_tiny_traced_run_reads_its_layers(tiny_run):
    got, _ = tiny_run
    assert got["per_layer"] == ["fuse_ms.mesh", "tsdf_roofline_pct.mesh"]
    metrics = got["result"]["metrics"]
    # no kernel runs on the CPU: T's roofline has nothing to read
    assert "tsdf_roofline_pct.mesh" not in metrics
    assert isinstance(metrics["fuse_ms.mesh"]["value"], float)


def test_tiny_run_loads_no_jax(tiny_run):
    got, _ = tiny_run
    assert got["forbidden"] == []


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _card_views(dev, n=3, w=320, h=240):
    """Analytic maps: a sphere of radius 0.8 around CENTER seen by cameras
    near the origin (the depth is the view z of the ray's hit, 0 off the
    sphere), and seeded colours."""
    out = []
    rng = np.random.default_rng(7)
    fovy = 2.0 * math.atan(math.tan(FOVX / 2) * h / w)
    for pose in _poses(n):
        pose = dict(pose, fovy=fovy)
        cam = make_camera(pose["R"], pose["T"], FOVX, fovy, w, h, device=dev)
        view_t = cam.viewmatrix.double().cpu().numpy()
        c2w = np.linalg.inv(view_t.T)
        fx = w / (2 * math.tan(FOVX / 2))
        fy = h / (2 * math.tan(fovy / 2))
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        dirs = np.stack([(xs - w / 2 + 0.5) / fx, (ys - h / 2 + 0.5) / fy, np.ones((h, w))], -1)
        d = dirs @ c2w[:3, :3].T
        o = c2w[:3, 3] - CENTER
        b = 2 * (d @ o)
        a = (d ** 2).sum(-1)
        disc = b ** 2 - 4 * a * ((o @ o) - 0.8 ** 2)
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
        depth = np.where(t > 0, t, 0.0)  # dirs have view z 1: t is the view depth
        color = rng.uniform(size=(3, h, w))
        out.append((torch.as_tensor(depth, dtype=torch.float32, device=dev),
                    torch.as_tensor(color, dtype=torch.float32, device=dev), cam))
    return out


def _card_volume(kind, res, dev):
    if kind == "bounded":
        return TsdfVolume.bounded(CENTER, 1.2, 2.4 / res, sdf_trunc=0.1, depth_trunc=6.0,
                                  max_resolution=res, device=dev)
    return TsdfVolume.contracted(CENTER, 1.0, res, sdf_trunc_vox=4.0, depth_trunc=6.0,
                                 device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [64, 256])
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_kernel_equals_the_plain_update(dev, kind, res):
    views = _card_views(dev)
    got, want = _card_volume(kind, res, dev), _card_volume(kind, res, dev)
    launches = tsdf_fuse.launches
    for depth, color, cam in views:
        got.integrate(depth, color, cam)
        want.integrate_plain(depth, color, cam)
    torch.cuda.synchronize(dev)
    assert tsdf_fuse.launches - launches == len(views)
    assert float((want.weight > 0).float().mean()) > 0.01 and float(want.weight.max()) == 3.0
    for name in ("weight", "tsdf", "colors"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_kernel_at_1024_on_seeded_blocks(dev, kind):
    """A 1024^3 grid fused from three views by T; seeded blocks of voxels
    (half of them near the sphere) held against the plain update of their
    values before the last view. The device memory peak stays under the
    grid, the maps and 2 GB: no [R^3, 3] array is made."""
    res, block = 1024, 1 << 16
    views = _card_views(dev, w=1600, h=1066)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    v = _card_volume(kind, res, dev)
    for depth, color, cam in views[:-1]:
        v.integrate(depth, color, cam)
    rng = np.random.default_rng(11)
    centre = (res // 2) * res * res + (res // 2) * res
    starts = [int(s) for s in rng.integers(0, res ** 3 - block, 4)]
    starts += [centre + int(s) for s in rng.integers(-40 * res * res, 40 * res * res, 4)]
    before = {s: (v.tsdf[s:s + block].clone(), v.weight[s:s + block].clone(),
                  v.colors[s:s + block].clone()) for s in starts}
    depth, color, cam = views[-1]
    v.integrate(depth, color, cam)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base_bytes
    grid_bytes = 20 * res ** 3
    assert peak < grid_bytes + 2 ** 31, peak
    fx = cam.width / (2.0 * float(cam.tanfovx))
    fy = cam.height / (2.0 * float(cam.tanfovy))
    f32 = [mesh._f32(x, dev) for x in (fx, fy, cam.width * 0.5 - 0.5, cam.height * 0.5 - 0.5,
                                       v.sdf_trunc, v.depth_trunc)]
    counted = 0
    for s, (t0, w0, c0) in before.items():
        xyz = torch.as_tensor(_voxel_centres(v.kind, res, v.base, v.scale, s, s + block),
                              device=dev)
        t1, w1, c1 = mesh._tsdf_update(t0, w0, c0, xyz.unbind(1), depth, color, cam.viewmatrix,
                                       *f32, width=cam.width, height=cam.height)
        counted += int((w1 > w0).sum())
        assert torch.equal(v.weight[s:s + block], w1), s
        assert torch.equal(v.tsdf[s:s + block], t1), s
        assert torch.equal(v.colors[s:s + block], c1), s
    assert counted > 1000


# ------------------------------------------------ card: the brick cull over whole grids

# (R, seeded poses) a kind: 102 poses a kind, R not a multiple of the brick
# (37, 100) and powers of two (128, 256)
WHOLE_GRIDS = [(37, 40), (100, 30), (128, 20), (256, 12)]
POSE_MODES = ("inside", "face", "axis", "corner", "shell", "random")


class _CentreMemo:
    """`_voxel_centres` made once a block: `integrate_plain` as it is, its
    centres not made again for each view."""

    def __init__(self):
        self.cache, self.real = {}, mesh._voxel_centres

    def __call__(self, kind, res, base, scale, start, stop):
        key = (kind, res, tuple(np.asarray(base, np.float64)), scale, start, stop)
        if key not in self.cache:
            self.cache[key] = self.real(kind, res, base, scale, start, stop)
        return self.cache[key]


def _rotation(rng, axis: bool) -> np.ndarray:
    """A camera-to-world rotation: random, or along a signed axis."""
    if axis:
        r = np.zeros((3, 3))
        r[np.arange(3), rng.permutation(3)] = rng.choice([-1.0, 1.0], 3)
        if np.linalg.det(r) < 0:
            r[:, 0] *= -1
        return r
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _stress_case(kind: str, res: int, case: int, dev):
    """A grid and three views of one seeded pose of POSE_MODES[case % 6]:
    the camera inside a brick, near the grid's faces (contracted: on the
    unit sphere), looking along an axis, at a brick corner with side planes
    through brick corners, on the 1.98 shell (bounded: far outside), or
    anywhere; depth_trunc from 2 voxels to far beyond the grid; depth maps
    just under depth_trunc (the farthest reach), uniform, or both."""
    rng = np.random.default_rng([res, case, kind == "contracted"])
    mode = POSE_MODES[case % len(POSE_MODES)]
    base = rng.normal(size=3)
    bs = 8  # tsdf_ops.brick_layout's brick
    if kind == "bounded":
        scale = float(rng.uniform(0.005, 0.05))  # the voxel size
        extent = res * scale

        def point(ijk):  # grid coordinates (voxel units from the origin) to world
            return base + np.asarray(ijk, np.float64) * scale
    else:
        scale = float(rng.uniform(0.5, 2.0))  # the scene's radius
        extent = 4.0 * scale

        def point(ijk):  # through the contraction
            c = np.asarray(ijk, np.float64)[None] * (4.0 / res) - 2.0
            return base + mesh.uncontract(c)[0] * scale
    axis = mode in ("axis", "corner") or rng.uniform() < 0.2
    w, h = int(rng.integers(40, 160)), int(rng.integers(30, 120))
    fovx = float(rng.uniform(0.4, 2.2))
    if mode == "inside":
        eye = point((rng.integers(0, -(-res // bs), 3) + rng.uniform(0.2, 0.8, 3)) * bs)
    elif mode == "face":
        if kind == "bounded":
            g = rng.uniform(0, res, 3)
            g[rng.integers(3)] = rng.choice([0.0, res]) + rng.uniform(-1.0, 1.0)
            eye = point(g)
        else:
            d = rng.normal(size=3)
            eye = base + d / np.linalg.norm(d) * scale * rng.uniform(0.98, 1.02)
    elif mode == "corner":
        # a brick corner (inside the unit ball, where the contraction is the
        # identity), side planes through the corners m bricks across, n along
        lo = res // 2 - res // 8 if kind == "contracted" else 0
        hi = res // 2 + res // 8 if kind == "contracted" else res
        eye = point(rng.integers(-(-lo // bs), hi // bs + 1, 3) * bs)
        m, n = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        fovx = 2.0 * math.atan(m / n)
    elif mode == "shell":
        d = rng.normal(size=3)
        far = 1.0 / (2.0 - 1.98) if kind == "contracted" else 3.0 * extent / scale
        eye = base + d / np.linalg.norm(d) * scale * far * rng.uniform(0.9, 1.1)
    else:
        eye = point(rng.uniform(-0.5, 1.5, 3) * res)
    fovy = 2.0 * math.atan(math.tan(fovx / 2) * h / w * rng.uniform(0.8, 1.25))
    voxel = scale if kind == "bounded" else 4.0 / res * scale
    sdf_trunc = float(voxel * rng.choice([0.5, 4.0, 20.0]))
    depth_trunc = float(rng.choice([2.0 * voxel, 0.3 * extent, 3.0 * extent, 1e6]))
    rot = _rotation(rng, axis)
    views = []
    for _ in range(3):
        r = _rotation(rng, False) if mode == "random" and not axis else rot
        c = eye + rng.normal(size=3) * 0.2 * voxel
        cam = make_camera(r, -r.T @ c, fovx, fovy, w, h, device=dev)
        reach = np.nextafter(np.float32(depth_trunc), np.float32(0))
        kind_of_map = rng.integers(3)
        uniform = rng.uniform(0, float(reach), (h, w))
        depth = (np.full((h, w), reach) if kind_of_map == 0 else uniform if kind_of_map == 1
                 else np.where(rng.uniform(size=(h, w)) < 0.5, reach, uniform))
        views.append((torch.as_tensor(depth, dtype=torch.float32, device=dev),
                      torch.as_tensor(rng.uniform(size=(3, h, w)), dtype=torch.float32,
                                      device=dev), cam))
    grid = dict(base=base, scale=scale, sdf_trunc=sdf_trunc, depth_trunc=depth_trunc)
    return mode, grid, views


@pytest.mark.cuda
@pytest.mark.parametrize("res, poses", WHOLE_GRIDS)
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_kernel_equals_the_plain_update_on_the_whole_grid(dev, kind, res, poses, monkeypatch):
    """T against `integrate_plain` over every voxel of the grid, after each
    of three views in a row (weights up to 3): a brick the cull drops with
    one voxel the plain update changes fails here."""
    updated, live_share = 0, []
    for case in range(poses):
        memo = _CentreMemo()
        monkeypatch.setattr(mesh, "_voxel_centres", memo)
        mode, grid, views = _stress_case(kind, res, case, dev)
        got = TsdfVolume(kind, res, **grid, device=dev)
        want = TsdfVolume(kind, res, **grid, device=dev)
        bricks, live = tsdf_fuse.bricks, tsdf_fuse.live_bricks()
        for n, (depth, color, cam) in enumerate(views):
            got.integrate(depth, color, cam)
            want.integrate_plain(depth, color, cam)
            for name in ("weight", "tsdf", "colors"):
                assert torch.equal(getattr(got, name), getattr(want, name)), \
                    (case, mode, n, name, grid)
        live_share.append((tsdf_fuse.live_bricks() - live) / (tsdf_fuse.bricks - bricks))
        updated += int((want.weight > 0).sum())
    # the cases update voxels, and the cull keeps most bricks in some and
    # drops most in others
    assert updated > 1000 and min(live_share) < 0.1 < max(live_share), live_share


def _room():
    """`room2dgs-mesh-fuse`'s configuration, poses, train views and grid
    radius (the nerf++ radius of the train cameras)."""
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "mipnerf360-room-2dgs-mesh1024.json")) as f:
        cfg = json.load(f)
    poses = room.poses(cfg)
    views = train_views(cfg)
    radius = nerfpp_norm([types.SimpleNamespace(R=poses[v]["R"], T=poses[v]["T"])
                          for v in views])["radius"]
    return cfg, poses, views, radius


def _room_views(dev, n: int = 2):
    """n train views of the room: their depth and colour maps rendered by
    `render2d` from the state of seed 1, and the program's cameras."""
    cfg, poses, views, _ = _room()
    params, _, alive, cap = room.state_tensors(cfg, 1, dev)
    zeros = torch.zeros(cap, device=dev)
    state = GaussianState(params, alive, zeros, zeros.clone(), zeros.clone())
    bg = torch.tensor(cfg["mesh"]["bg"], dtype=torch.float32, device=dev)
    out = []
    for v in views[::len(views) // n][:n]:
        p = poses[v]
        cam = make_camera(p["R"], p["T"], p["fovx"], p["fovy"], cfg["width"], cfg["height"],
                          device=dev)
        maps = render2d(cam, state, bg, sh_degree=cfg["sh_degree"],
                        depth_ratio=float(cfg["mesh"]["depth_ratio"]))
        out.append((maps["render_depth"][0].contiguous().clone(),
                    maps["render"].contiguous().clone(), cam))
    return out


@pytest.mark.cuda
def test_kernel_on_two_room_views_over_the_whole_1024_grid(dev, monkeypatch):
    """Two of the room's views fused by T into the contracted 1024^3 grid of
    `room2dgs-mesh-fuse` and by `integrate_plain` (its PLAIN_BLOCK blocks,
    the centres made once, in parallel): every voxel bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    cfg, _, _, radius = _room()
    views = _room_views(dev)
    m = cfg["mesh"]
    args = (m["center"], radius, int(m["mesh_res"]), float(m["sdf_trunc_voxels"]),
            float(m["depth_trunc_radii"]) * radius)
    got = TsdfVolume.contracted(*args, device=dev)
    want = TsdfVolume.contracted(*args, device=dev)
    memo = _CentreMemo()
    blocks = range(0, want.voxels, mesh.PLAIN_BLOCK)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda s: memo(want.kind, want.res, want.base, want.scale, s,
                                     min(s + mesh.PLAIN_BLOCK, want.voxels)), blocks))
    monkeypatch.setattr(mesh, "_voxel_centres", memo)
    for depth, color, cam in views:
        got.integrate(depth, color, cam)
        want.integrate_plain(depth, color, cam)
    torch.cuda.synchronize(dev)
    assert int((want.weight > 0).sum()) > 10 ** 5
    for name in ("weight", "tsdf", "colors"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_live_brick_counters(dev):
    """`tsdf_fuse.bricks` grows by the grid's bricks a launch and
    `launches` by one; the live share is 1 where the camera sees the whole
    of a small bounded grid within reach, and under 0.1 for the room's
    cameras in a contracted 256^3 grid at the cell's truncations."""
    v = TsdfVolume("bounded", 32, CENTER - 0.5, 1.0 / 32, 0.1, 1e6, device=dev)
    cam = make_camera(np.eye(3), -(CENTER - np.array([0.0, 0.0, 4.0])), 1.6, 1.6, 64, 64,
                      device=dev)
    depth = torch.full((64, 64), 4.0, device=dev)
    color = torch.rand(3, 64, 64, device=dev)
    launches, bricks, live = tsdf_fuse.launches, tsdf_fuse.bricks, tsdf_fuse.live_bricks()
    v.integrate(depth, color, cam)
    assert (tsdf_fuse.launches - launches, tsdf_fuse.bricks - bricks) == (1, 4 ** 3)
    assert tsdf_fuse.live_bricks() - live == 4 ** 3
    assert int((v.weight > 0).sum()) > 0

    cfg, poses, views, radius = _room()
    m = cfg["mesh"]
    v = TsdfVolume.contracted(m["center"], radius, 256, float(m["sdf_trunc_voxels"]),
                              float(m["depth_trunc_radii"]) * radius, device=dev)
    w, h = cfg["width"], cfg["height"]
    depth, color = torch.zeros(h, w, device=dev), torch.zeros(3, h, w, device=dev)
    for name in views[::50]:
        p = poses[name]
        cam = make_camera(p["R"], p["T"], p["fovx"], p["fovy"], w, h, device=dev)
        bricks, live = tsdf_fuse.bricks, tsdf_fuse.live_bricks()
        v.integrate(depth, color, cam)
        assert tsdf_fuse.bricks - bricks == 32 ** 3
        share = (tsdf_fuse.live_bricks() - live) / 32 ** 3
        assert 0.0 < share < 0.1, (name, share)
