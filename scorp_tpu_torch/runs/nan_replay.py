"""Replay a faulting train step dumped by `runs.nan_hunt` (or by the JAX
package's `scripts/nan_hunt.py`), port of the JAX package's
`scripts/nan_replay.py`.

Loads the dump (parameters, Adam moments, statistics, camera, background and
ground truth of the step that made the first non-finite value), prints a
host-side report of near-degenerate inputs (scale and quaternion extremes,
view depths at the near plane), and re-runs that one `train_step` with
`OptParams()` and `tuned_raster_config(capacity)`. It names the first
non-finite stage: one of the rasterizer's outputs (color, accumulated depth,
alpha), the loss, or the first backward function that returns a NaN under
`torch.autograd.detect_anomaly(check_nan=True)` (a second run of the step,
made when anything was non-finite), where the JAX script's `jax_debug_nans`
names the primitive; then the non-finite counts after the step.

    python -m scorp_tpu_torch.runs.nan_replay fault_iter7432.npz              # the card
    python -m scorp_tpu_torch.runs.nan_replay fault_iter7432.npz --device cpu # plain versions

`--device cpu` runs the kernels' plain PyTorch versions, the counterpart of
the JAX script's `--xla`.
"""

from __future__ import annotations

import re
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from ..core.camera import Camera
from ..device import resolve_device
from ..ops.raster import rasterize
from ..render import tuned_raster_config
from ..train import OptParams, adam_from_numpy, state_from_numpy, train_step
from ..train.state import PARAM_KEYS, raster_inputs

FORWARD_OUTPUTS = ("color", "depth_accum", "alpha")


def load(path, device: str | torch.device = "cuda"):
    """-> (state, adam, cam, bg, iteration, active_sh, gt_img) on `device`,
    the JAX script's `load` tuple. The camera takes the dumped fov tangents
    as they are (a round trip through the angle could move their last
    bit)."""
    dev = resolve_device(device)
    z = np.load(path)

    def t(key):
        return torch.as_tensor(z[key], device=dev)

    state = state_from_numpy({k: z[f"param.{k}"] for k in PARAM_KEYS}, z["alive"], dev,
                             z["max_radii2d"], z["xyz_grad_accum"], z["denom"])
    adam = adam_from_numpy({k: z[f"adam_m.{k}"] for k in PARAM_KEYS},
                           {k: z[f"adam_v.{k}"] for k in PARAM_KEYS}, int(z["adam_step"]), dev)
    cam = Camera(viewmatrix=t("viewmatrix"), projmatrix=t("projmatrix"), campos=t("campos"),
                 tanfovx=t("tanfovx"), tanfovy=t("tanfovy"),
                 width=int(z["width"]), height=int(z["height"]))
    return state, adam, cam, t("bg"), int(z["iteration"]), int(z["active_sh"]), t("gt_img")


def diagnose_inputs(state, cam) -> None:
    """Host-side near-degeneracy report on the pre-step parameters (the JAX
    script's lines, computed in numpy)."""
    alive = state.alive.cpu().numpy()
    p = {k: v.detach().cpu().numpy()[alive] for k, v in state.params.items()}
    scales = np.exp(p["scaling"])
    q = p["rotation"]
    qn = np.linalg.norm(q, axis=1)
    print(f"alive rows: {alive.sum()}")
    print(f"scale range: [{scales.min():.3e}, {scales.max():.3e}]  "
          f"aspect max: {(scales.max(1) / np.maximum(scales.min(1), 1e-30)).max():.3e}")
    print(f"quat norm range: [{qn.min():.3e}, {qn.max():.3e}]")
    print(f"opacity logit range: [{p['opacity'].min():.3f}, {p['opacity'].max():.3f}]")
    xyz_h = np.concatenate([p["xyz"], np.ones((len(p["xyz"]), 1), np.float32)], 1)
    depth = (xyz_h @ cam.viewmatrix.cpu().numpy())[:, 2]
    print(f"view-depth range: [{depth.min():.3f}, {depth.max():.3f}]  "
          f"(near-plane 0.2 crossers: {(np.abs(depth - 0.2) < 1e-3).sum()})")
    for k, v in p.items():
        nb = int((~np.isfinite(v)).sum())
        if nb:
            print(f"  !! pre-step {k} already has {nb} non-finite entries")


def forward_outputs(state, cam, bg, active_sh: int, cfg) -> dict:
    """The rasterizer's outputs for the step's inputs, as `train_step`
    calls it (without the gradient)."""
    with torch.no_grad():
        out = rasterize(cam=cam, bg=bg, sh_degree=active_sh, cfg=cfg,
                        **raster_inputs(state.params, state.alive))
    return {k: getattr(out, k) for k in FORWARD_OUTPUTS}


def replay(state, adam, cam, bg, iteration: int, active_sh: int, gt_img) -> dict:
    """Re-run one step on the inputs' device -> {"stage", "loss",
    "post_step" ({name: non-finite entries}), "state", "adam", "seconds"}.
    "stage" names the first non-finite value: "forward:<output>" of the
    rasterizer, "loss", "backward:<function>" (the first backward function
    that returns a NaN, from a second run of the step under anomaly
    detection), "step" (the update alone), or None when all is finite."""
    dev = state.alive.device
    cfg = tuned_raster_config(state.capacity)
    zeros1 = torch.zeros((1, cam.height, cam.width), device=dev)

    def step():
        return train_step(state, adam, cam, gt_img, zeros1, zeros1, iteration, bg,
                          opt=OptParams(), sh_degree=active_sh, cfg=cfg,
                          has_depth_cam=False, has_depth_est=False)

    print(f"re-running iter {iteration} (sh={active_sh}) on {dev}...")
    t0 = time.perf_counter()
    fwd = forward_outputs(state, cam, bg, active_sh, cfg)
    state2, adam2, metrics = step()
    loss = float(metrics.loss)
    print(f"step completed: loss={loss}")
    post = {}
    for name, d in (("", state2.params), ("adam_m.", adam2.m), ("adam_v.", adam2.v)):
        for k, v in d.items():
            nb = int((~torch.isfinite(v)).sum())
            if nb:
                post[name + k] = nb
                print(f"  post-step {name + k}: {nb} non-finite entries")
    seconds = time.perf_counter() - t0
    stages = [f"forward:{k}" for k, v in fwd.items() if not bool(torch.isfinite(v).all())]
    if not np.isfinite(loss):
        stages.append("loss")
    if stages or post:
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                step()
        except RuntimeError as e:
            fn = re.search(r"Function '(\w+)' returned nan values", str(e))
            if fn is None:
                raise
            print(f"detect_anomaly caught: {e}")
            stages.append(f"backward:{fn.group(1)}")
        stages.append("step")
    stage = stages[0] if stages else None
    print(f"first non-finite stage: {stage}")
    return {"stage": stage, "loss": loss, "post_step": post, "state": state2, "adam": adam2,
            "seconds": seconds}


def main(argv=None) -> dict:
    ap = ArgumentParser(description="replay one faulting train step from a NaN-hunt dump")
    ap.add_argument("path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    state, adam, cam, bg, iteration, active_sh, gt_img = load(args.path, args.device)
    diagnose_inputs(state, cam)
    return replay(state, adam, cam, bg, iteration, active_sh, gt_img)


if __name__ == "__main__":
    main()
