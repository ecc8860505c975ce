"""The mesh of a TSDF grid: the plain marching cubes a slab of planes at a
time (`pipeline/marching_cubes.py`), `TsdfVolume.triangulate`
(`pipeline/mesh.py`) and kernel M (`csrc/marching_cubes.cu`, wrapper
`ops/marching_cubes.py`).

On the CPU: the slab path against the JAX package's whole-grid function bit
for bit (every case alone, a sphere, a torus, fields with unobserved holes,
slab splits of 1, 2 and 7 planes); `triangulate` against the host path the
fusion took before it (the grids copied out, the whole-grid function, the
vertices uncontracted after) at 32^3 and 48^3 for both grid kinds; the
counters and the spans; the benchmark's reference
(`bench_port/reference/marching_cubes.py`): its case tables, its mesh of
seeded fused grids, and its float32-t control failing the cell's limits;
the readers and the work model; and the `room2dgs-mesh-extract` cell run
whole at a tiny size in a fresh process; M's chunk counters and its C
entry points against `ops/_build.py`'s signatures. On the card (marked
`cuda`, skipped elsewhere): M against the plain path bit for bit on fused
grids of both kinds at 64^3, 101^3 (odd rows, every alignment) and 256^3,
on a surface-dense grid whose chunks are nearly all listed, on a grid whose
surface lies in the last chunk of each row and across the count pass's
tile borders, on slabs of the room's contracted 1024^3 grid, its counters
(also on grids that launch nothing or find no surface) and its memory peak
over the whole 1024^3 grid. On a GPU machine:

    python -m pytest tests/test_torch_marching_cubes.py -q
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench_port.reference import marching_cubes as ref_mc
from scorp_tpu_torch.ops import _build
from scorp_tpu_torch.ops import marching_cubes as mc_ops
from scorp_tpu_torch.pipeline import marching_cubes as tmc
from scorp_tpu_torch.pipeline import mesh
from scorp_tpu_torch.pipeline.mesh import TsdfVolume
# the fusion tests' helpers (pytest puts tests/ on the path)
from test_torch_tsdf_fuse import _card_views, _card_volume, _reader, _room, _room_views, _volume
from test_torch_tsdf_fuse import views  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bench_port", "limits", "room2dgs-mesh-extract.json")) as _f:
    CELL_LIMITS = json.load(_f)["limits"]


def _jmc():
    """The JAX package's marching cubes (numpy on the host, the whole grid at
    once): imported where a CPU test needs it."""
    from scorp_tpu.pipeline import marching_cubes

    return marching_cubes


def _same(got, want):
    """Equal dtypes, shapes and bytes, array by array."""
    return all(np.asarray(a).dtype == np.asarray(b).dtype and np.asarray(a).shape
               == np.asarray(b).shape and np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(got, want))


# ---------------------------------------------------------------- fields


def _field(kind: str, shape=(23, 19, 27), seed=0):
    """(tsdf, weight, colors) f32 on a grid of `shape`: a noisy sphere, a
    torus, or a sphere with unobserved holes (a slab, a tunnel, speckle)."""
    rng = np.random.default_rng(seed)
    g = [np.arange(n) - (n - 1) / 2 + 0.31 for n in shape]
    x, y, z = np.meshgrid(*g, indexing="ij")
    r = min(shape) / 3
    if kind == "torus":
        f = np.sqrt((np.sqrt(x ** 2 + y ** 2) - r) ** 2 + z ** 2) - r / 2.5
    else:
        f = np.sqrt(x ** 2 + y ** 2 + z ** 2) - r
    f = f + rng.normal(0, 0.4, f.shape)
    w = rng.integers(1, 4, f.shape).astype(np.float32)
    if kind == "holes":
        w[:, :3] = 0
        w[np.abs(y) + np.abs(z) < 2.5] = 0
        w[rng.uniform(size=f.shape) < 0.03] = 0
    colors = rng.uniform(size=f.shape + (3,))
    return f.astype(np.float32), w, colors.astype(np.float32)


def _dense_field(shape, seed=0):
    """A high-frequency analytic field observed everywhere: nearly every
    cell holds surface."""
    x, y, z = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape], indexing="ij")
    f = np.sin(1.9 * x + 0.3) * np.sin(2.3 * y + 0.7) * np.sin(2.1 * z + 0.1) + 0.05
    colors = np.random.default_rng(seed).uniform(size=tuple(shape) + (3,))
    return f.astype(np.float32), np.ones(shape, np.float32), colors.astype(np.float32)


def _border_field(shape, seed=0):
    """Surface only in the last 32-corner chunk of each row (a wavy plane
    near z = NZ - 5.5, observed from NZ - 12 on) and in a ball around the
    corner (8, 14, 128), where the count pass's tiles (mc_ops.TILE) meet."""
    x, y, z = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape], indexing="ij")
    f = z - (shape[2] - 5.5) + 0.3 * np.sin(x + 2 * y)
    w = (z >= shape[2] - 12).astype(np.float64)
    ball = sum((g - c) ** 2 for g, c in zip((x, y, z), mc_ops.TILE))
    f = np.where(ball < 49, np.sqrt(ball) - 4.3, f)
    w = np.where(ball < 49, 1.0, w)
    colors = np.random.default_rng(seed).uniform(size=tuple(shape) + (3,))
    return f.astype(np.float32), w.astype(np.float32), colors.astype(np.float32)


@pytest.mark.parametrize("field, shape", [(_dense_field, (11, 15, 33)),
                                          (_border_field, (11, 17, 140))])
def test_slab_path_on_the_card_tests_fields(field, shape, monkeypatch):
    """The card tests' surface-dense and tile-border fields: the slab path
    (split into slabs of 3 planes) is the whole-grid function's mesh."""
    tsdf, weight, colors = field(shape)
    _slabs_of(3, shape, monkeypatch)
    origin, vs = np.array([-2.0, 0.5, 1.0]), 0.21
    want = _jmc().marching_cubes(tsdf, weight, origin, vs, colors)
    assert len(want[1]) > 500 and _same(tmc.marching_cubes(tsdf, weight, origin, vs, colors),
                                        want)


def _slabs_of(planes: int, shape, monkeypatch):
    """Slabs of `planes` cell planes for a grid of `shape` (None: one slab)."""
    if planes is not None:
        monkeypatch.setattr(tmc, "SLAB_CELLS", planes * (shape[1] - 1) * (shape[2] - 1))


@pytest.mark.parametrize("planes", [1, 2, 7, None])
@pytest.mark.parametrize("kind", ["sphere", "torus", "holes"])
def test_slab_path_equals_the_whole_grid_function(kind, planes, monkeypatch):
    """Every slab split cuts the surface; the mesh is the whole-grid
    function's (the JAX package's, the port's before the slabs) bit for
    bit, with and without colours."""
    tsdf, weight, colors = _field(kind)
    _slabs_of(planes, tsdf.shape, monkeypatch)
    origin, vs = np.array([0.25, -1.5, 3.0]), 0.37
    want = _jmc().marching_cubes(tsdf, weight, origin, vs, colors)
    got = tmc.marching_cubes(tsdf, weight, origin, vs, colors)
    assert len(want[1]) > 500 and _same(got, want)
    assert _same(tmc.marching_cubes(tsdf, weight, origin, vs),
                 _jmc().marching_cubes(tsdf, weight, origin, vs))


@pytest.mark.parametrize("first", range(0, 256, 32))
def test_every_case_alone(first, monkeypatch):
    """Each case as one cell, and inside a 3 x 4 x 3 grid split into slabs
    of one plane: the whole-grid function's mesh."""
    rng = np.random.default_rng(first)
    monkeypatch.setattr(tmc, "SLAB_CELLS", 1)  # one plane a slab
    for case in range(first, first + 32):
        tsdf = np.ones((2, 2, 2), np.float32)
        for k in range(8):
            if case >> k & 1:
                tsdf[k & 1, (k >> 1) & 1, k >> 2] = -rng.uniform(0.1, 1.0)
        weight = np.ones_like(tsdf)
        colors = rng.uniform(size=(2, 2, 2, 3)).astype(np.float32)
        want = _jmc().marching_cubes(tsdf, weight, np.zeros(3), 1.0, colors)
        assert _same(tmc.marching_cubes(tsdf, weight, np.zeros(3), 1.0, colors), want), case
        big = np.ones((3, 4, 3), np.float32)
        big[1:, 1:3, :2] = tsdf
        bw, bc = np.ones_like(big), rng.uniform(size=(3, 4, 3, 3)).astype(np.float32)
        assert _same(tmc.marching_cubes(big, bw, np.ones(3), 0.5, bc),
                     _jmc().marching_cubes(big, bw, np.ones(3), 0.5, bc)), case


def test_degenerate_grids_give_empty_meshes(monkeypatch):
    monkeypatch.setattr(tmc, "SLAB_CELLS", 1)
    for shape in ((1, 5, 5), (5, 5, 5)):
        tsdf = np.ones(shape, np.float32)
        got = tmc.marching_cubes(tsdf, np.ones_like(tsdf), np.zeros(3), 1.0)
        assert _same(got, (np.zeros((0, 3)), np.zeros((0, 3), np.int64), np.zeros((0, 3))))


# ---------------------------------------------------------------- TsdfVolume.triangulate


def _host_path(v: TsdfVolume, marching_cubes):
    """The mesh as `tsdf_fuse_unbounded` and `extract_mesh_bounded` made it
    before `triangulate`: the grids on the host, `marching_cubes` over them
    (the whole-grid function, or the port's plain path), the contracted
    vertices uncontracted after."""
    tsdf, weight, colors = v.grids()
    if v.kind == "bounded":
        return marching_cubes(tsdf, weight, v.base, v.scale, colors)
    verts, faces, cols = marching_cubes(tsdf, weight, np.full(3, -2.0), v.step, colors)
    return mesh.uncontract(verts) * v.scale + v.base, faces, cols


@pytest.mark.parametrize("res", [32, 48])
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_triangulate_equals_the_old_host_path(views, kind, res):
    v = _volume(kind, res)
    for depth, color, cam, _ in views:
        v.integrate(depth, color, cam)
    got = v.triangulate()
    assert len(got[1]) > 200 and _same(got, _host_path(v, _jmc().marching_cubes))
    assert got[0].dtype == np.float64 and got[1].dtype == np.int64


def test_callers_triangulate_the_volume(views, monkeypatch):
    """`tsdf_fuse_unbounded` and `extract_mesh_bounded` return the fused
    volume's `triangulate()`, and the counters add its mesh."""
    calls = []
    real = TsdfVolume.triangulate

    def spy(self, method="marching_cubes"):
        out = real(self, method)
        calls.append((self.kind, method, len(out[0]), len(out[1])))
        return out

    monkeypatch.setattr(TsdfVolume, "triangulate", spy)

    class Cam:  # what `_fuse` takes: a camera with `to_torch`
        def __init__(self, depth, color, cam):
            self.maps, self.cam = {"render_depth": depth[None], "render": color}, cam

        def to_torch(self, device):
            return self.cam

    cams = [Cam(depth, color, cam) for depth, color, cam, _ in views]

    def render_fn(cam):
        return cam.maps
    nv, nf = mesh.vertices, mesh.faces
    un = mesh.tsdf_fuse_unbounded(render_fn, cams, np.array([0.0, 0.0, 3.5]), 2.0,
                                  resolution=24, depth_trunc=6.0, device="cpu")
    ex = mesh.GaussianExtractor(render_fn, cams, device="cpu")
    bd = ex.extract_mesh_bounded(np.array([0.0, 0.0, 3.5]), 2.0, voxel_size=4.0 / 24,
                                 sdf_trunc=0.25, depth_trunc=6.0, max_resolution=24)
    assert [c[:2] for c in calls] == [("contracted", "marching_cubes"),
                                      ("bounded", "marching_cubes")]
    assert (len(un[0]), len(un[1])) == calls[0][2:] and (len(bd[0]), len(bd[1])) == calls[1][2:]
    assert (mesh.vertices - nv, mesh.faces - nf) == (len(un[0]) + len(bd[0]),
                                                     len(un[1]) + len(bd[1]))


def test_surface_nets_stays_on_the_host(views):
    v = _volume("contracted", 24)
    for depth, color, cam, _ in views:
        v.integrate(depth, color, cam)
    tsdf, weight, colors = v.grids()
    verts, faces, cols = mesh.surface_nets(tsdf, weight, np.full(3, -2.0), v.step, colors)
    got = v.triangulate("surface_nets")
    assert _same(got, (mesh.uncontract(verts) * v.scale + v.base, faces, cols))


def test_triangulate_span_and_no_launch_on_the_cpu(views):
    """`mesh.triangulate` opens once a call under a profiler; the CPU path
    copies nothing (no `mesh.to_host`) and launches no kernel."""
    v = _volume("bounded", 16)
    depth, color, cam, _ = views[0]
    v.integrate(depth, color, cam)
    counters = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v.triangulate()
        v.triangulate()
    names = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
    assert names.count("mesh.triangulate") == 2 and "mesh.to_host" not in names
    assert _counters() == counters


def _counters():
    """M's counters: triangulations launched, chunks of their grids, chunks
    the later passes visited."""
    fn = mc_ops.marching_cubes
    return fn.launches, fn.chunks, fn.active_chunks


def test_counters_start_at_zero():
    """A fresh process: the wrapper has its three counters, all 0."""
    code = ("from scorp_tpu_torch.ops.marching_cubes import marching_cubes as m; "
            "print(m.launches, m.chunks, m.active_chunks)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["0", "0", "0"]


def _entry_points():
    """(source, C entry point, argument kinds) of every kernel library."""
    return [(src, fn, kinds) for src, fns in _build.SIGNATURES.items()
            for fn, kinds in fns.items()]


@pytest.mark.parametrize("src, fn, kinds", _entry_points())
def test_signatures_match_the_c_entry_points(src, fn, kinds):
    """Each ctypes signature in `ops/_build.py` has the C entry point's
    arguments, kind by kind (a pointer, int, size_t, float or double)."""
    text = (_build.CSRC_DIR / f"{src}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, fn
    got = ""
    for arg in m.group(1).split(","):
        arg = arg.strip()
        got += ("p" if "*" in arg else "z" if arg.startswith("size_t") else
                "d" if arg.startswith("double") else "f" if arg.startswith("float") else
                "i" if arg.startswith("int") else "?")
    assert got == kinds


def test_wrapper_refuses_cpu_tensors():
    v = _volume("bounded", 8)
    counters = _counters()
    with pytest.raises(ValueError, match="TsdfVolume.triangulate runs the plain function"):
        mc_ops.marching_cubes(v.tsdf, v.weight, v.colors, (8, 8, 8), origin=v.base,
                              voxel_size=v.scale)
    assert _counters() == counters


def test_uploaded_tables_hold_the_module_tables():
    t = mc_ops.case_tables()
    n_tri = 256 * mc_ops.MAX_TRIS * 3
    assert t.dtype == np.int32 and len(t) == n_tri + 256 * tmc.MAX_LOOPS + 12
    tri = t[:n_tri].reshape(256, mc_ops.MAX_TRIS, 3)
    np.testing.assert_array_equal(tri[:, :tmc.TRI_TABLE.shape[1]], tmc.TRI_TABLE)
    assert (tri[:, tmc.TRI_TABLE.shape[1]:] == -1).all()
    loops = t[n_tri:n_tri + 256 * tmc.MAX_LOOPS].reshape(256, tmc.MAX_LOOPS)
    np.testing.assert_array_equal((loops[..., None] >> np.arange(12)) & 1, tmc.LOOP_MASK)
    np.testing.assert_array_equal(t[-12:], tmc.EDGE_BASE)


# ---------------------------------------------------------------- the reference


def test_reference_tables_equal_the_program_tables():
    tri, loops = ref_mc.case_tables()
    np.testing.assert_array_equal(tri.numpy(), tmc.TRI_TABLE)
    np.testing.assert_array_equal(loops.numpy(), tmc.LOOP_MASK)


def _fused(kind, res, views, seed):
    """A grid fused from the views in a seeded order, each view's colours
    scaled by a seeded factor."""
    v = _volume(kind, res)
    rng = np.random.default_rng(seed)
    for i in rng.permutation(len(views)):
        depth, color, cam, _ = views[int(i)]
        v.integrate(depth, color * float(rng.uniform(0.5, 1.0)), cam)
    return v


def _reference_mesh(v: TsdfVolume, t_dtype=torch.float64) -> dict:
    contracted = v.kind == "contracted"
    return ref_mc.triangulate(v.tsdf, v.weight, v.colors, (v.res,) * 3,
                              (-2.0,) * 3 if contracted else v.base,
                              v.step if contracted else v.scale,
                              contract=(v.scale, v.base) if contracted else None,
                              t_dtype=t_dtype)


def _cell_gaps(want: dict, got) -> dict:
    from bench_port.loops.extract2d import _gaps

    return _gaps(want, got)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_program_matches_the_reference(views, kind, seed):
    v = _fused(kind, 40, views, seed)
    want, got = _reference_mesh(v), v.triangulate()
    assert len(got[1]) > 200
    np.testing.assert_array_equal(want["faces"].numpy(), got[1])
    assert _same((want["vertices"].numpy(), want["colors"].numpy()), (got[0], got[2]))
    gaps = _cell_gaps(want, got)
    assert gaps == dict(face_mismatch=0.0, position_gap=0.0, color_gap=0.0)
    assert want["observed"] == int((v.weight > 0).sum()) and want["edge_corners"] > 0


def test_float32_t_control_fails_the_cell_limits(views):
    """t in float32 moves vertices and colours past their limits; the faces,
    which t does not touch, still match."""
    v = _fused("contracted", 40, views, 5)
    low = _reference_mesh(v, torch.float32)
    gaps = _cell_gaps(_reference_mesh(v), (low["vertices"], low["faces"], low["colors"]))
    assert gaps["face_mismatch"] <= CELL_LIMITS["face_mismatch"]
    assert gaps["position_gap"] > CELL_LIMITS["position_gap"]
    assert gaps["color_gap"] > CELL_LIMITS["color_gap"]


def test_gaps_count_differing_faces():
    want = dict(vertices=torch.tensor([[0.0, 0, 0], [2, 0, 0], [0, 3, 0]], dtype=torch.float64),
                colors=torch.zeros(3, 3, dtype=torch.float64),
                faces=torch.tensor([[0, 1, 2], [2, 1, 0]]))
    got = (np.array([[0.0, 0, 0], [2, 0, 1e-3], [0, 3, 0]]), np.array([[0, 1, 2], [2, 0, 1]]),
           np.full((3, 3), 0.25))
    gaps = _cell_gaps(want, got)
    assert gaps["face_mismatch"] == 1.0
    assert gaps["position_gap"] == pytest.approx(1e-3 / 2)
    assert gaps["color_gap"] == 0.25
    extra = (np.concatenate([got[0], got[0][:1]]), got[1][:1], np.full((4, 3), 0.0))
    assert _cell_gaps(want, extra)["face_mismatch"] == 2.0
    # the control hands the reference's tensors in the program's place
    assert _cell_gaps(want, tuple(torch.as_tensor(a) for a in got)) == gaps


# ---------------------------------------------------------------- readers and work model


def _label(count, busy_s):
    return dict(count=count, host_s=2 * busy_s, device_span_s=1.5 * busy_s, device_busy_s=busy_s)


@pytest.mark.parametrize("metric, span", [("triangulate_ms.mesh", "mesh.triangulate"),
                                          ("mesh_copy_ms.mesh", "mesh.to_host")])
def test_span_readers(metric, span):
    labels = {"unit.extract": _label(5, 0.0), span: _label(5, 0.2)}
    ctx = dict(loop="extract2d", profile=dict(labels=labels))
    read = _reader(metric).read
    assert read(ctx) == pytest.approx(1e3 * 0.2 / 5)
    assert read(dict(ctx, profile=dict(labels={"unit.extract": labels["unit.extract"]}))) is None
    assert read(dict(ctx, loop="fuse2d")) is None


def test_mc_roofline_reader():
    kernels = [["void (anonymous namespace)::mc_verts<true>((anonymous namespace)::Dims)", 0.01],
               ["void (anonymous namespace)::mc_verts<false>((anonymous namespace)::Dims)", 0.01],
               ["(anonymous namespace)::mc_cells_count(float const*)", 0.02],
               ["(anonymous namespace)::mc_cells_emit(float const*)", 0.01],
               ["void at::native::reduce_kernel<512, 1>()", 0.5]]
    ctx = dict(loop="extract2d", primitive="2dgs", least_s={"marching_cubes": 0.01},
               profile=dict(kernels=kernels))
    read = _reader("mc_roofline_pct.mesh").read
    assert read(ctx) == pytest.approx(20.0)
    assert read(dict(ctx, loop="fuse2d")) is None
    assert read(dict(ctx, profile=dict(kernels=kernels[-1:]))) is None


def test_marching_cubes_work_counts():
    from bench_port import harness

    c = harness.work_part("marching_cubes").cost(dict(observed=1000, edge_corners=300,
                                                      vertices=40, faces=70))
    assert (c["flops"], c["bytes"]) == (0.0, 8 * 1000 + 12 * 300 + 48 * 40 + 24 * 70)


# ------------------------------------------------ the cell, tiny, in a fresh process

TINY = dict(n_gaussians=3000, width=96, height=64, n_views=16, test_every=8)
TINY_TRAFFIC = dict(traced_units=2, counted_units=1, warmup_frames=1, sampled_from_first=2)
CPU_RATES = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12, "pcie_bytes_per_s": 64e9}
CELL_RUN = """
import json, tempfile, time, torch
from bench_port import harness
torch.set_num_threads(2)
cell = harness.cell_of("room2dgs-mesh-extract")
cell["config"].update(%r)
cell["config"]["mesh"]["mesh_res"] = 24
cell["traffic"].update(%r)
with tempfile.TemporaryDirectory() as tmp:
    res = harness.run_cell(cell, 2**31 + 555, 0.3, True, torch.device("cpu"), time.time(),
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
    assert set(res["checks"]) == {"face_mismatch", "position_gap", "color_gap"}
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "kernel M calls per triangulation 0.000 (marching_cubes.launches)" in err
    assert "reference mesh" in err
    assert got["end_to_end"] == ["setup_s", "frame_ms", "frame_p95_ms"]


def test_tiny_traced_run_reads_its_layers(tiny_run):
    got, err = tiny_run
    assert got["per_layer"] == ["triangulate_ms.mesh", "mesh_copy_ms.mesh",
                                "mc_roofline_pct.mesh", "host_syncs.mesh", "sync_wait_ms.mesh"]
    metrics = got["result"]["metrics"]
    # the CPU runs no kernel, copies nothing and waits for no device: M's
    # roofline, the copy and the host waits have nothing to read
    for name in ("mc_roofline_pct.mesh", "mesh_copy_ms.mesh", "host_syncs.mesh",
                 "sync_wait_ms.mesh"):
        assert name not in metrics, name
    assert isinstance(metrics["triangulate_ms.mesh"]["value"], float)
    assert "work model counts" in err


def test_tiny_run_loads_no_jax(tiny_run):
    got, _ = tiny_run
    assert got["forbidden"] == []


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [64, 256])
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_kernel_equals_the_plain_path(dev, kind, res):
    """A grid fused by T from three views: M's mesh, in world coordinates,
    is the plain path's on the host copy of the grid, bit for bit."""
    v = _card_volume(kind, res, dev)
    for depth, color, cam in _card_views(dev):
        v.integrate(depth, color, cam)
    launches = mc_ops.marching_cubes.launches
    got = v.triangulate()
    assert mc_ops.marching_cubes.launches - launches == 1
    want = _host_path(v, tmc.marching_cubes)
    assert len(want[1]) > 1000
    assert _same(got, want)


@pytest.mark.cuda
def test_launches_count_triangulations_launched(dev):
    """`marching_cubes.launches` counts what reached the card: a grid under
    two voxels a side launches nothing and counts nothing (no chunk either);
    a grid with no surface launches its count pass, counts one and its 25
    chunks, none of them visited, and gives an empty mesh."""
    for shape, counted in (((1, 5, 5), (0, 0, 0)), ((5, 5, 5), (1, 25, 0))):
        m = int(np.prod(shape))
        before = _counters()
        got = mc_ops.marching_cubes(
            torch.ones(m, device=dev), torch.ones(m, device=dev),
            torch.zeros((m, 3), device=dev), shape, origin=np.zeros(3), voxel_size=1.0)
        assert tuple(a - b for a, b in zip(_counters(), before)) == counted, shape
        assert [tuple(a.shape) for a in got] == [(0, 3)] * 3
        assert [a.dtype for a in got] == [torch.float64, torch.int64, torch.float64]


def _kernel_vs_plain(dev, tsdf, weight, colors, origin=(-2.0, 0.5, 1.0), voxel_size=0.01,
                     contract=None):
    """M's mesh of host arrays against the plain path's, bit for bit; the
    counters' change: (chunks, chunks visited)."""
    shape = tsdf.shape
    before = _counters()
    got = [a.cpu().numpy() for a in mc_ops.marching_cubes(
        torch.as_tensor(tsdf.ravel(), device=dev), torch.as_tensor(weight.ravel(), device=dev),
        torch.as_tensor(colors.reshape(-1, 3), device=dev), shape, origin=np.asarray(origin),
        voxel_size=voxel_size, contract=contract)]
    after = _counters()
    wv, wf, wc = tmc.marching_cubes(tsdf, weight, np.asarray(origin), voxel_size, colors)
    if contract is not None:
        wv = mesh.uncontract(wv) * contract[0] + contract[1]
    assert len(wf) > 1000 and _same(got, (wv, wf, wc))
    assert after[0] - before[0] == 1
    chunks, visited = after[1] - before[1], after[2] - before[2]
    assert chunks == shape[0] * shape[1] * -(-shape[2] // 32) and 0 < visited <= chunks
    return chunks, visited


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bounded", "contracted"])
def test_kernel_on_an_odd_grid(dev, kind):
    """A 101^3 grid fused by T from the card views: odd NX and NY, NZ not a
    multiple of 4 or 32, so its rows start at every 4-byte alignment and
    the count pass reads most of them a float at a time. M's mesh is the
    plain path's, bit for bit."""
    v = _card_volume(kind, 101, dev)
    for depth, color, cam in _card_views(dev):
        v.integrate(depth, color, cam)
    before = _counters()
    got = v.triangulate()
    after = _counters()
    want = _host_path(v, tmc.marching_cubes)
    assert len(want[1]) > 1000 and _same(got, want)
    assert after[0] - before[0] == 1 and after[1] - before[1] == 101 * 101 * 4
    assert 0 < after[2] - before[2] <= after[1] - before[1]


@pytest.mark.cuda
def test_kernel_on_a_surface_dense_grid(dev):
    """Nearly every chunk holds surface, so the lists fill to their
    capacity and the later passes walk almost the whole grid."""
    chunks, visited = _kernel_vs_plain(dev, *_dense_field((64, 70, 131)),
                                       contract=(1.5, np.array([0.1, -0.2, 0.3])))
    assert visited > 0.95 * chunks


@pytest.mark.cuda
@pytest.mark.parametrize("palette", [(-1.0, -0.0, 0.0, 0.5, -0.25, 1.0), (-0.0,)])
def test_kernel_on_signed_colours(dev, palette):
    """Colours of either sign and signed zeros, unobserved speckle, the grid
    at the origin: centroid colours sum as numpy's reduction does (from +0),
    so even a loop of -0.0 colours gives the plain path's +0.0. (No tsdf is
    exactly 0: np.clip keeps or drops the sign of a t of -0.0 by numpy
    release, so the plain path's edge colours then depend on it.)"""
    rng = np.random.default_rng(5)
    shape = (13, 17, 70)
    tsdf = rng.uniform(-1, 1, shape).astype(np.float32)
    weight = (rng.uniform(size=shape) < 0.9).astype(np.float32)
    colors = rng.choice(np.array(palette, np.float32), size=shape + (3,))
    _kernel_vs_plain(dev, tsdf, weight, colors, origin=np.zeros(3), voxel_size=1.0)


@pytest.mark.cuda
def test_kernel_on_the_last_chunk_and_tile_borders(dev):
    """The only surface lies in the last chunk of each row (12 corners of
    it) and in a ball across the count pass's tile borders in x, y and z."""
    chunks, visited = _kernel_vs_plain(dev, *_border_field((19, 31, 300)))
    assert visited < 0.2 * chunks


def _room_grid(dev, views=4):
    cfg, _, _, radius = _room()
    m = cfg["mesh"]
    v = TsdfVolume.contracted(m["center"], radius, int(m["mesh_res"]),
                              float(m["sdf_trunc_voxels"]),
                              float(m["depth_trunc_radii"]) * radius, device=dev)
    for depth, color, cam in _room_views(dev, views):
        v.integrate(depth, color, cam)
    torch.cuda.synchronize(dev)
    return v


@pytest.mark.cuda
def test_kernel_on_slabs_of_the_room_1024_grid(dev):
    """The room's contracted 1024^3 grid after four views. M over the whole
    grid: its device peak stays under the grid, the mesh and 2 GB. M over
    slabs of planes of the grid (views of its tensors, no copy) against the
    whole-grid function on the host copies of the same planes."""
    v = _room_grid(dev)
    res = v.res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    verts, faces, cols = mc_ops.marching_cubes(
        v.tsdf, v.weight, v.colors, (res,) * 3, origin=np.full(3, -2.0), voxel_size=v.step,
        contract=(v.scale, v.base))
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    mesh_bytes = 48 * len(verts) + 24 * len(faces)
    assert len(faces) > 10 ** 5, len(faces)
    assert peak < mesh_bytes + 2 ** 31, (peak, mesh_bytes)
    del verts, faces, cols
    plane = res * res
    live = (v.weight.view(res, res, res) > 0).flatten(1).any(1).nonzero()[:, 0].cpu().numpy()
    rng = np.random.default_rng(3)
    starts = sorted(set(int(s) for s in rng.choice(live[live < res - 9], 4, replace=False)))
    for x0 in starts:
        sl = slice(x0 * plane, (x0 + 9) * plane)
        t, w, c = v.tsdf[sl], v.weight[sl], v.colors[sl]
        got = [a.cpu().numpy() for a in mc_ops.marching_cubes(
            t, w, c, (9, res, res), origin=np.array([0.5, -1.0, 2.0]), voxel_size=0.01)]
        shape = (9, res, res)
        want = tmc.marching_cubes(t.cpu().numpy().reshape(shape), w.cpu().numpy().reshape(shape),
                                  np.array([0.5, -1.0, 2.0]), 0.01,
                                  c.cpu().numpy().reshape(shape + (3,)))
        assert len(want[1]) > 0 and _same(got, want), x0
