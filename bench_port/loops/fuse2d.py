"""The mesh-fusion loop: the TSDF fusion of a 2DGS mesh extraction
(`apps/extract_mesh.py --unbounded`), one view a frame, in a closed loop.

Set-up: the state of the configuration (as loops/render2d.py makes it),
the train views' depth (`render_depth` at the configuration's depth_ratio)
and colour maps rendered once by the program's `render2d` and kept on the
device, and the program's grid (`TsdfVolume.contracted`) at the scene's
radius (the program's nerf++ `cameras_extent` of the train views). A frame
is one `integrate` of the next view's maps into that grid, in an order
drawn from the seed and cycled; the running average keeps accumulating, as
over a mesh run's views. Each frame is timed from the call to the
synchronize after it.

For the check, a few frames drawn from the seed gather the grid before and
after their `integrate` at voxels drawn from the seed: half of the draw
from the voxels the reference counts valid in that frame's view (all of
them where they are fewer), the rest uniform over the grid. The draw and
the gathers are left out of the window's time. After the window the
reference fuses the same maps into the "before" values
(bench_port/reference/tsdf.py).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from .. import room
from ..devtrace import clock, dispatched_ops, host_note, host_probe, labels, traced
from ..reference import camera as ref_camera
from ..reference import tsdf as ref_tsdf
from .train import quarters

# the check's numbers; each compares the program's grid after a sampled
# frame with the reference's update of the same voxels before it
CHECKS = ("weight_mismatch", "tsdf_gap", "color_gap")


def _program():
    from scorp_tpu_torch.core.camera import make_camera
    from scorp_tpu_torch.ops.tsdf import tsdf_fuse
    from scorp_tpu_torch.pipeline.mesh import TsdfVolume
    from scorp_tpu_torch.render2d import render2d
    from scorp_tpu_torch.scene.dataset_readers import nerfpp_norm
    from scorp_tpu_torch.train import GaussianState

    return SimpleNamespace(make_camera=make_camera, tsdf_fuse=tsdf_fuse, TsdfVolume=TsdfVolume,
                           render2d=render2d, nerfpp_norm=nerfpp_norm,
                           GaussianState=GaussianState)


def train_views(cfg: dict) -> list:
    """The views a mesh run fuses: every view but each `test_every`-th."""
    return [i for i in range(int(cfg["n_views"])) if i % int(cfg["test_every"])]


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str,
        hooks: dict) -> dict:
    import torch

    prog = _program()  # first: a program without the grid object stops here
    cfg, traffic = cell["config"], cell["traffic"]
    mesh = cfg["mesh"]
    if cfg["primitive"] != "2dgs" or mesh["grid"] != "contracted":
        raise ValueError("the fusion loop fuses a 2dgs state's maps into a contracted grid")
    cuda = device.type == "cuda"
    poses = room.poses(cfg)
    views = train_views(cfg)
    radius = prog.nerfpp_norm([SimpleNamespace(R=poses[v]["R"], T=poses[v]["T"])
                               for v in views])["radius"]
    params, _, alive, cap = room.state_tensors(cfg, seed, device)
    zeros = torch.zeros(cap, device=device)
    state = prog.GaussianState(params, alive, zeros, zeros.clone(), zeros.clone())
    cams = {v: prog.make_camera(poses[v]["R"], poses[v]["T"], poses[v]["fovx"],
                                poses[v]["fovy"], cfg["width"], cfg["height"], device=device)
            for v in views}
    bg = torch.tensor(mesh["bg"], dtype=torch.float32, device=device)
    maps = {}
    for v in views:
        out = prog.render2d(cams[v], state, bg, sh_degree=cfg["sh_degree"],
                            depth_ratio=float(mesh["depth_ratio"]))
        maps[v] = (out["render_depth"][0].contiguous().clone(), out["render"].contiguous().clone())
    del out, state, params
    volume = prog.TsdfVolume.contracted(mesh["center"], radius, int(mesh["mesh_res"]),
                                        float(mesh["sdf_trunc_voxels"]),
                                        float(mesh["depth_trunc_radii"]) * radius, device=device)
    grid = ref_tsdf.grid_of(mesh, radius)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    order = np.random.default_rng(seed).permutation(len(views))
    sample = set(np.random.default_rng(seed + 1).choice(
        int(traffic["sampled_from_first"]), int(traffic["sampled_frames"]), replace=False).tolist())
    pos = dict(i=0)
    label = labels(trace)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def next_view():
        return views[int(order[pos["i"] % len(order)])]

    def frame():
        view = next_view()
        with label("unit.fuse"):
            volume.integrate(*maps[view], cams[view])
            sync()
        pos["i"] += 1
        return view

    def draw(view):
        """The voxels a sampled frame of `view` compares."""
        k = int(traffic["sampled_voxels"])
        cam = ref_camera.camera(poses[view], cfg["width"], cfg["height"], device)
        valid = ref_tsdf.valid_indices(grid, maps[view][0], cam)
        if valid.numel() > k // 2:
            valid = valid[torch.randperm(valid.numel(), generator=gen, device=device)[:k // 2]]
        uniform = torch.randint(0, volume.voxels, (k - valid.numel(),), generator=gen,
                                device=device)
        return torch.cat([valid, uniform])

    def gather(index):
        got = dict(tsdf=volume.tsdf[index], weight=volume.weight[index],
                   colors=volume.colors[index])
        sync()
        return got

    def before_frame():
        index = draw(next_view())
        return dict(index=index, before=gather(index))

    def sampled_frame():
        k = before_frame()
        view = frame()
        return dict(k, view=view, after=gather(k["index"]))

    for _ in range(int(traffic["warmup_frames"])):
        frame()
    pos["i"] = 0
    sync()
    setup_s = time.time() - t0

    lat, kept, stamps = [], [], []
    paused = 0.0
    probe = host_probe()
    launches0 = prog.tsdf_fuse.launches
    w0 = clock()
    while True:
        if len(lat) in sample:  # the draw and gathers stand outside the window's time
            t = clock()
            before = before_frame()
            paused += clock() - t
        t = clock()
        view = frame()
        lat.append(clock() - t)
        if len(lat) - 1 in sample:
            t = clock()
            kept.append(dict(before, view=view, after=gather(before["index"])))
            paused += clock() - t
        stamps.append(clock() - w0 - paused)
        if stamps[-1] >= seconds:
            break
    window_s = clock() - w0 - paused
    n = len(lat)
    launches = (prog.tsdf_fuse.launches - launches0) / n
    host = host_note(probe, host_probe(), n)
    p95 = float(np.quantile(np.asarray(lat), 0.95, method="higher"))
    res = dict(attempted=n, failed=0, window_s=window_s, units=n, kept=kept, poses=poses,
               maps=maps, radius=radius,
               end_to_end={"setup_s": setup_s, "frame_ms": 1e3 * window_s / n,
                           "frame_p95_ms": 1e3 * p95},
               notes=[f"window {window_s:.3f} s ({paused:.3f} s of sampling left out), {n} "
                      f"views fused, median {1e3 * float(np.median(lat)):.3f} ms; ms per view "
                      f"by quarter of the window {quarters(stamps)}",
                      f"grid {volume.res}^3 contracted, radius {radius!r}, sdf_trunc "
                      f"{volume.sdf_trunc!r}, depth_trunc {volume.depth_trunc!r}",
                      f"kernel T launches per view {launches:.3f} (tsdf_fuse.launches)",
                      host])
    # sampled frames the window did not reach come late, not wrong
    while len(kept) < len(sample):
        pos["i"] = sorted(sample)[len(kept)]
        kept.append(sampled_frame())
    if trace:
        traced_views = []

        def unit():
            traced_views.append(frame())

        res["profile"] = traced(unit, int(traffic["traced_units"]), "unit.window", device)
        res["traced"] = list(traced_views)  # the views the profile holds, and no later ones
        counts = [dispatched_ops(unit) for _ in range(int(traffic["counted_units"]))]
        res["host_ops"] = sum(counts) / len(counts)
        res["notes"].append(f"host ops per view {res['host_ops']:.1f}")
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    del volume
    if cuda:
        torch.cuda.empty_cache()
    return res


def _gaps(want: list, got: list) -> dict:
    """The check's numbers over the sampled frames: voxels whose weight
    differs, the largest |tsdf| and |colour| differences."""
    out = dict.fromkeys(CHECKS, 0.0)
    for w, g in zip(want, got):
        out["weight_mismatch"] += float((w["weight"] != g["weight"]).sum())
        out["tsdf_gap"] = max(out["tsdf_gap"], float((w["tsdf"] - g["tsdf"]).abs().max()))
        out["color_gap"] = max(out["color_gap"], float((w["colors"] - g["colors"]).abs().max()))
    return out


def _reference(cell: dict, out: dict, device, dtype=None) -> list:
    """The reference's update of each sampled frame's voxels from their
    values before it, with the voxel centres in `dtype` (float64 unless
    the control asks for float32)."""
    import torch

    cfg = cell["config"]
    grid = ref_tsdf.grid_of(cfg["mesh"], out["radius"])
    refs = []
    for k in out["kept"]:
        centres = ref_tsdf.voxel_centres(k["index"], grid, dtype or torch.float64)
        cam = ref_camera.camera(out["poses"][k["view"]], cfg["width"], cfg["height"], device)
        refs.append(ref_tsdf.update(k["before"], centres, *out["maps"][k["view"]], cam, grid))
    return refs


def check(cell: dict, seed: int, out: dict, device) -> dict:
    """The program's grid after each sampled frame against the reference's
    update of the same voxels from the maps and pose of that frame."""
    refs = _reference(cell, out, device)
    out["notes"].append("valid sampled voxels per sampled frame "
                        f"{[int(r['valid'].sum()) for r in refs]} of "
                        f"{[k['index'].numel() for k in out['kept']]}")
    return _gaps(refs, [k["after"] for k in out["kept"]])


def control(cell: dict, seed: int, out: dict, device) -> tuple[dict, dict]:
    """(the control's readings: the reference with its voxel centres in
    float32 in the program's place, the program's readings) of one run."""
    import torch

    low = _reference(cell, out, device, torch.float32)
    return _gaps(_reference(cell, out, device), low), check(cell, seed, out, device)


def trace_context(cell: dict, seed: int, out: dict, device, rates: dict) -> dict:
    """The readers' context: the profile, and the work model's least
    seconds of the traced views, from the reference's masks of each view
    over the whole grid (voxels in the image, valid voxels)."""
    from .. import harness

    cfg = cell["config"]
    grid = ref_tsdf.grid_of(cfg["mesh"], out["radius"])
    distinct = sorted(set(out["traced"]))
    pairs = [(out["maps"][v][0], ref_camera.camera(out["poses"][v], cfg["width"], cfg["height"],
                                                   device)) for v in distinct]
    counted = dict(zip(distinct, ref_tsdf.counts(grid, pairs)))
    parts = cfg["work"]["fuse"]
    least = {p: 0.0 for p in parts}
    for v in out["traced"]:
        inside, valid = counted[v]
        shape = dict(inside=inside, valid=valid, pixels=cfg["width"] * cfg["height"])
        for p, s in harness.least_seconds(parts, shape, rates).items():
            least[p] += s
    out["notes"].append("traced views' voxels in the image, valid: "
                        f"{[counted[v] for v in out['traced']]}")
    return dict(loop="fuse2d", primitive=cfg["primitive"], profile=out["profile"],
                least_s=least, traced_units=len(out["traced"]), window_s=out["window_s"],
                units=out["units"], host_ops=out["host_ops"])
