"""The mesh-export loop: the triangulation of a 2DGS mesh extraction
(`apps/extract_mesh.py --unbounded`), one whole marching cubes of the fused
grid a frame, in a closed loop.

Set-up: the state of the configuration (as loops/fuse2d.py makes it), the
program's grid (`TsdfVolume.contracted`) at the scene's radius, and the
train views rendered by the program's `render2d` and fused by `integrate`
one at a time, in an order drawn from the seed; no map is kept. A frame is
one `TsdfVolume.triangulate()` of that grid, timed from the call until its
three numpy arrays (world vertices, faces, colours) are in host memory.

For the check, one frame drawn from the seed keeps its arrays; after the
window the reference (bench_port/reference/marching_cubes.py) triangulates
the same grid, read from the program's grid tensors, and the check compares
the faces as index triples and the vertices and colours.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from .. import room
from ..devtrace import clock, dispatched_ops, host_note, host_probe, labels, traced
from ..reference import marching_cubes as ref_mc
from .fuse2d import train_views
from .train import quarters

# the check's numbers; each compares the sampled frame's mesh with the
# reference's mesh of the same grid
CHECKS = ("face_mismatch", "position_gap", "color_gap")


def _program():
    # first: a program without the card's triangulation stops here
    from scorp_tpu_torch.ops.marching_cubes import marching_cubes
    from scorp_tpu_torch.pipeline import mesh
    from scorp_tpu_torch.pipeline.mesh import TsdfVolume
    from scorp_tpu_torch.core.camera import make_camera
    from scorp_tpu_torch.render2d import render2d
    from scorp_tpu_torch.scene.dataset_readers import nerfpp_norm
    from scorp_tpu_torch.train import GaussianState

    return SimpleNamespace(marching_cubes=marching_cubes, mesh=mesh, TsdfVolume=TsdfVolume,
                           make_camera=make_camera, render2d=render2d, nerfpp_norm=nerfpp_norm,
                           GaussianState=GaussianState)


def _fused_volume(prog, cfg: dict, seed: int, device):
    """The program's grid after every train view, fused in a seeded order,
    and the scene's radius."""
    import torch

    mesh = cfg["mesh"]
    poses = room.poses(cfg)
    views = train_views(cfg)
    radius = prog.nerfpp_norm([SimpleNamespace(R=poses[v]["R"], T=poses[v]["T"])
                               for v in views])["radius"]
    params, _, alive, cap = room.state_tensors(cfg, seed, device)
    zeros = torch.zeros(cap, device=device)
    state = prog.GaussianState(params, alive, zeros, zeros.clone(), zeros.clone())
    bg = torch.tensor(mesh["bg"], dtype=torch.float32, device=device)
    volume = prog.TsdfVolume.contracted(mesh["center"], radius, int(mesh["mesh_res"]),
                                        float(mesh["sdf_trunc_voxels"]),
                                        float(mesh["depth_trunc_radii"]) * radius, device=device)
    for i in np.random.default_rng(seed).permutation(len(views)):
        p = poses[views[int(i)]]
        cam = prog.make_camera(p["R"], p["T"], p["fovx"], p["fovy"], cfg["width"],
                               cfg["height"], device=device)
        out = prog.render2d(cam, state, bg, sh_degree=cfg["sh_degree"],
                            depth_ratio=float(mesh["depth_ratio"]))
        volume.integrate(out["render_depth"][0].contiguous(), out["render"].contiguous(), cam)
        del out
    return volume, radius


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str,
        hooks: dict) -> dict:
    import torch

    prog = _program()  # first: a program without the card's triangulation stops here
    cfg, traffic = cell["config"], cell["traffic"]
    if cfg["primitive"] != "2dgs" or cfg["mesh"]["grid"] != "contracted":
        raise ValueError("the export loop triangulates a 2dgs state's contracted grid")
    cuda = device.type == "cuda"
    volume, radius = _fused_volume(prog, cfg, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    sample = int(np.random.default_rng(seed + 1).integers(int(traffic["sampled_from_first"])))
    label = labels(trace)

    def frame():
        with label("unit.extract"):
            return volume.triangulate()

    for _ in range(int(traffic["warmup_frames"])):
        frame()
    setup_s = time.time() - t0

    lat, stamps, kept = [], [], None
    probe = host_probe()
    launches0 = prog.marching_cubes.launches
    counted0 = (prog.mesh.vertices, prog.mesh.faces)
    w0 = clock()
    while True:
        t = clock()
        mesh = frame()
        lat.append(clock() - t)
        if len(lat) - 1 == sample:
            kept = mesh
        del mesh
        stamps.append(clock() - w0)
        if stamps[-1] >= seconds:
            break
    window_s = clock() - w0
    n = len(lat)
    launches = (prog.marching_cubes.launches - launches0) / n
    verts = (prog.mesh.vertices - counted0[0]) / n
    faces = (prog.mesh.faces - counted0[1]) / n
    host = host_note(probe, host_probe(), n)
    if kept is None:  # a sampled frame the window did not reach comes late, not wrong
        kept = frame()
    p95 = float(np.quantile(np.asarray(lat), 0.95, method="higher"))
    res = dict(attempted=n, failed=0, window_s=window_s, units=n, kept=kept, volume=volume,
               radius=radius,
               end_to_end={"setup_s": setup_s, "frame_ms": 1e3 * window_s / n,
                           "frame_p95_ms": 1e3 * p95},
               notes=[f"window {window_s:.3f} s, {n} triangulations, median "
                      f"{1e3 * float(np.median(lat)):.3f} ms; ms per triangulation by "
                      f"quarter of the window {quarters(stamps)}",
                      f"grid {volume.res}^3 contracted, radius {radius!r}; observed voxels "
                      f"{int((volume.weight > 0).sum())}",
                      f"mesh {len(kept[0])} vertices, {len(kept[1])} faces; per triangulation "
                      f"{verts:.1f} vertices, {faces:.1f} faces (mesh.vertices, mesh.faces)",
                      f"kernel M calls per triangulation {launches:.3f} "
                      "(marching_cubes.launches)",
                      host])
    if trace:
        res["profile"] = traced(frame, int(traffic["traced_units"]), "unit.window", device)
        res["traced"] = int(traffic["traced_units"])
        counts = [dispatched_ops(frame) for _ in range(int(traffic["counted_units"]))]
        res["host_ops"] = sum(counts) / len(counts)
        res["notes"].append(f"host ops per triangulation {res['host_ops']:.1f}")
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    return res


def _reference(cell: dict, out: dict, t_dtype=None) -> dict:
    """The reference's mesh of the run's grid, with t in `t_dtype` (float64
    unless the control asks for float32)."""
    import torch

    v = out["volume"]
    if "reference" in out and t_dtype is None:
        return out["reference"]
    ref = ref_mc.triangulate(v.tsdf, v.weight, v.colors, (v.res,) * 3, (-2.0, -2.0, -2.0),
                             4.0 / v.res, contract=(out["radius"], v.base),
                             t_dtype=t_dtype or torch.float64)
    if t_dtype is None:
        out["reference"] = ref
    return ref


def _gaps(want: dict, got) -> dict:
    """The check's numbers: faces that differ as index triples plus the
    differences in face and vertex counts; the largest vertex gap over
    max(|reference vertex|, 1); the largest colour gap."""
    import torch

    dev = want["vertices"].device
    verts, faces, cols = (torch.as_tensor(a).to(dev) for a in got)  # numpy or tensors
    nv, nf = min(len(verts), len(want["vertices"])), min(len(faces), len(want["faces"]))
    mismatch = int((faces[:nf] != want["faces"][:nf]).any(-1).sum())
    mismatch += abs(len(faces) - len(want["faces"])) + abs(len(verts) - len(want["vertices"]))
    ref_v = want["vertices"][:nv]
    gap = (verts[:nv] - ref_v).norm(dim=-1) / ref_v.norm(dim=-1).clamp_min(1.0)
    return dict(face_mismatch=float(mismatch),
                position_gap=float(gap.max()) if nv else 0.0,
                color_gap=float((cols[:nv] - want["colors"][:nv]).abs().max()) if nv else 0.0)


def check(cell: dict, seed: int, out: dict, device) -> dict:
    """The sampled frame's mesh against the reference's mesh of the grid."""
    ref = _reference(cell, out)
    out["notes"].append(f"reference mesh {len(ref['vertices'])} vertices, "
                        f"{len(ref['faces'])} faces")
    return _gaps(ref, out["kept"])


def control(cell: dict, seed: int, out: dict, device) -> tuple[dict, dict]:
    """(the control's readings: the reference with t in float32 in the
    program's place, the program's readings) of one run."""
    import torch

    low = _reference(cell, out, torch.float32)
    low = (low["vertices"], low["faces"], low["colors"])
    return _gaps(_reference(cell, out), low), check(cell, seed, out, device)


def trace_context(cell: dict, seed: int, out: dict, device, rates: dict) -> dict:
    """The readers' context: the profile, and the work model's least seconds
    of the traced triangulations, counted from the reference's mesh and
    masks of the grid."""
    from .. import harness

    ref = _reference(cell, out)
    shape = dict(observed=ref["observed"], edge_corners=ref["edge_corners"],
                 vertices=len(ref["vertices"]), faces=len(ref["faces"]))
    parts = cell["config"]["work"]["extract"]
    least = {p: s * out["traced"] for p, s in harness.least_seconds(parts, shape, rates).items()}
    out["notes"].append(f"work model counts {shape}")
    return dict(loop="extract2d", primitive=cell["config"]["primitive"], profile=out["profile"],
                least_s=least, traced_units=out["traced"], window_s=out["window_s"],
                units=out["units"], host_ops=out["host_ops"])
