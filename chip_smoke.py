#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`scorp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):
  1. setup: print the card's name and power limit; build every CUDA kernel
     from `scorp_tpu_torch/csrc/` (one nvcc per source, in parallel; the
     key sort `csrc/sort.cu` is CUB's) and print each kernel's registers
     and spills from nvcc's report (for the sort: its kernel count and
     largest spill).
  2. full width, eval path: write a COLMAP scene (4 views at 1600x1066, 2
     test views; its points3D.bin holds the centres and colours of a
     250k-Gaussian SH-3 scene drawn from `--seed` with bench.py's room-scale
     distribution, its PNGs are that scene rendered by the port) and the
     scene's PLY, then render the test views through
     `scorp_tpu_torch.apps.render_3dgs.main` on cuda. Checks the PNGs, zero
     dropped keys, a non-empty frame, and that K1 and K2's launch counters
     rose during that run (the key sort's once per K1, the fused
     preprocess's once per frame).
  3. kernel vs plain version on identical inputs at 50k / 800x600: K1
     (every key slot and kept identical, without and with the cull, with
     the keys' own width and with 64-bit keys); K2 on one stream (color,
     alpha and depth/alpha within max 5e-3 and mean 1e-5; n_contrib equal
     on >= 99.9% of pixels); a 2k-Gaussian
     render on the GPU against the plain path on the CPU.
  4. at full width, on the eval path's inputs: the fused preprocess against
     its plain version (every field bit for bit) and its times; the same K1
     and K2 checks,
     K1 against the expansion golden (0.8 golden <= kept <= golden + 1000),
     the keys-only sort against torch.sort on K1's keys and the route
     (gid, tile ranges, dropped) against the decode of the same keys
     widened to int64 and sorted by torch.sort (the route's earlier form);
     then times, the key sort's beside torch.sort's of the same keys and of
     the int64 keys: each kernel beside its plain version and its bound, each
     stage of a frame, the ATen ops a frame dispatches, and the device's
     busy time per frame from a torch.profiler trace. A kernel's "ms" is its
     device time from a profiler (CUPTI) trace of 20 calls, which must hold
     20 launches of it (one retrace, then a failure); "ms_per_call"
     is the CUDA-event median of 20 calls, each after a synchronize, which
     also counts the host's launch work while the device waits. K2 is
     also held bit-identical to its plain version (every output, n_contrib on
     100% of pixels) here, in phase 3 and on phase 7's training stream, and
     its (warp, key) slots on the eval stream are counted (walked, left by
     the warp mask, with a lane at alpha >= 1/255) with the plain
     gauss_alpha and gauss_warp_mask on the card.
  5. K3 (the backward compositor) against its plain version at 50k /
     800x600 on the differentiable rasterizer's inputs with cotangents from
     `--seed`: d_table per column within 1e-4 x the column's largest value
     (atomics add in a run-dependent order), d_bg within 1e-5, all finite;
     and a 2k / 128x96 `rasterize` backward on the GPU against the CPU plain
     path (every gradient within 1e-4 of its largest value).
  6. full width, training path: `scorp_tpu_torch.apps.train_3dgs.main` on
     cuda from the 250k points for 30 iterations (densification from
     iteration 10 every 10, so one densify/prune and the capacity growth
     run; evaluate after iteration 1 and at the end, printing the test and
     train views' L1 and PSNR; save at the end). Checks that K1, K2 and K3
     launched, finite losses (first and last printed), no NaN in the
     parameters, the PLY written and loading back, and no dropped keys after
     any regrow.
  7. one `train_step` at bench.py's training measurement (250k SH-3, one
     1600x1066 view, OptParams() at iteration 1000, random GT, black bg):
     the step's CUDA-event median of 10, the device's busy time in its
     forward, backward and Adam + statistics (from the program's spans,
     `step_parts_ms`), ATen ops per step, device busy time, peak memory;
     the L1 + SSIM loss's forward and backward alone at that size; K3
     against its plain version on the step's inputs (the checks of phase
     5), its time beside its plain version and its bound, and K2's time with
     n_contrib and t_final; the sort and route checks of phase 4 on the
     step's training stream; K2's and K3's (warp, key) slots on that stream
     and K3's global atomics (10 per touched (block, gaussian row) pair)
     beside the bound's count (10 per walked (warp, key) pair, kept
     unchanged as K2's 24 ops per pair are, so that shares of the bound
     stay comparable across kernel versions).
  8. full width, 2DGS eval path: the scene's 250k Gaussians as surfels
     (their first two scales, bench.py:293-300) written as a PLY and
     rendered through `scorp_tpu_torch.apps.render_2dgs.main` on cuda
     (PNGs, zero dropped keys, a non-black frame, K1's and K4's launch
     counters rose); K1 with its second ellipse and K4 against their plain
     versions at 50k / 800x600 and at full width (every channel within max
     5e-3 and mean 1e-5), and the sort and route checks of phase 4 on the
     full-width stream; K4 on the uncut stream (every rect key) against
     the culled one at 50k, so the union cull drops no contributing key;
     K4's time beside its plain version and its bound, and a whole
     `render2d` frame's time, ATen ops and device busy time.
  9. K5 against its plain version (the phase 8 checks, and n_contrib and
     n_med equal on >= 99.9% of pixels) and K6 against its plain version
     (per column 1e-4 x max, d_bg 1e-5) on a training stream at 50k /
     800x600; a 2k / 128x96 `rasterize_surfel` backward on the GPU against
     the CPU plain path, every channel in the loss.
  10. full width, 2DGS training path: `scorp_tpu_torch.apps.train_2dgs.main`
     on cuda from the 250k points for 30 iterations (one densification,
     K1/K5/K6 once per step and K4 in the evaluations, finite losses, no
     NaN, the PLY with 2 scale columns); then one `train_step_2d` at
     bench.py's 2DGS measurement (Opt2DParams(lambda_dist=100) at iteration
     8000, so the normal and distortion losses are on): its time and parts,
     ATen ops, device busy time, peak memory, and K5 and K6 on its inputs
     against their plain versions, with times and bounds, and the sort and
     route checks of phase 4 on its stream; and K5's and
     K6's (warp, key) slots on that stream (walked, left by the warp mask,
     left to hit() by the pre-test, with a lane past the exact alpha and z
     tests), counted with the plain surfel_hit, surfel_warp_mask and
     surfel_pretest on the card.
  11. the host synchronisations PyTorch is asked for by one `render()` of
     the scene and by one `train_step` at phase 7's setting (each
     rasterization reads its expanded-key count once, to size the key
     buffers: `expand.key_slots`), counted under
     torch.cuda.set_sync_debug_mode("warn") (`host_sync_counts`, which runs
     on earlier versions of the port too: import this file by its path with
     another checkout's root first on sys.path to count theirs).
  12. full width, the SCORP object path (`phase_scorp`): write_scene's room
     scene with 10 orbiting views (8 train, 2 test) as the trained model, the
     object (the cluster whose centre is nearest the origin) rendered alone
     into RGBA masks; then `apps.segmentation_3dgs.main` (one K1, sort, K2
     and K3 per vote; the votes summed over the cameras through the kernels
     against the plain versions, max |diff| <= 1e-4 x max, the selections
     and the app's equal where the sum is clear of 0; the selection at
     least half the cluster, and at least half of it projecting into at
     least half of the masks, its precision and IoU printed; camera 0's raw
     votes of all three voting methods through the kernels against the
     plain versions on the card, max |diff| <= 1e-4 x max |vote| and equal
     signs where |vote| > 1e-4 x max; the vote's ms),
     `apps.view_selection.main` (1-3 crops, no kernel), the proxy (the
     object cluster at SH 0, scaled 0.6, rotated 0.5 rad about z,
     translated; the cluster is also the alignment's scene object in
     gs_seg/obj.ply, as the crops show it alone),
     `apps.align_3dgs_clpe_9dof.align` with the generated 64-rotation
     bank and the app's default matcher ("auto": SIFT on the card,
     pipeline/sift.py) for ALIGN_ROUNDS rounds, the 9-DoF Adam in the last
     (one K1, sort and K2 per render; per round the SIFT calls,
     keypoints, cross-checked matches, correspondences lifted and the
     in-app RANSAC / Adam calls and times; at least one round lifting >= 3
     correspondences into a solver; the aligned proxy's centroid within
     0.35 x the object's xyz std; the centroid error after the coarse init
     and after the rounds, the recovered scale and rotation beside the
     true ones; the ICP's seconds and host syncs), the SIFT of one of the
     alignment's crop pairs on the card against the CPU (keypoint counts
     within 1%, >= 99% of the CPU's keypoints within 1e-3 px on the card
     with descriptors within +-1, >= 95% of its cross-checked pairs on the
     card; ms per pair, host syncs, peak memory), a 3.375x render of the aligned
     proxy equal to the plain versions', at default_raster_config's key
     slots and at twice as many, where none is dropped, `pc_align_ransac` (2,000 hypotheses)
     and `adam_algorithm_3d3d_9dof` (3,000 steps) recovering a known
     similarity to 1e-3, `apps.post_refine_gs.main` for 30
     steps (one K1, sort, K2 and K3 each; the loss falls; geometry
     bit-unchanged; PLYs written), `apps.render_3dgs.main` (RGBA PNGs, one
     K1 and K2 per view), and one `refine_step`'s time, device busy time and
     host syncs.
  13. full width, the 2DGS object path and mesh extraction
     (`phase_scorp2d`), on phase 12's scene and masks with the scene's
     Gaussians as surfels at iteration 25000: `apps.segmentation_2dgs.main`
     (one K1, sort, K5 and K6 per surfel vote; the summed votes and camera
     0's votes of the three methods against the plain versions, as in phase
     12; recall and precision against the cluster printed, no limit),
     `apps.view_selection.main`, `apps.trellis_img2gs.main --proxy_dir`
     (the object cluster as the scene object and as a 3DGS proxy, as phase
     12 builds it; copied byte for byte), `apps.truncate_opacity.main` (the
     .bak, the count kept at opacity >= 0.1),
     `apps.align_2dgs_clpe_9dof.align` (ALIGN2D_ROUNDS rounds matched by
     ORB on the card: one K1, sort and K4 per scene-object render, one K1,
     sort and K2 per proxy render; per round the ORB calls, keypoints,
     matches, lifted pairs, RANSAC calls and times, the centroid, scale and
     rotation errors; a round lifts >= 3 pairs into a solver; the aligned
     centroid within 0.35 x the object's xyz std), the ORB of the largest
     crop pair on the card against the CPU (every keypoint, descriptor and
     pair equal; ms per pair, device busy, ATen ops, host syncs, peak
     memory), and
     `apps.extract_mesh.main` at its defaults (256^3 voxels, 8 train views:
     one K1, sort and K4 per view; the card's TSDF grid against tsdf_fuse
     on the CPU from the same depth and colour maps, weights equal, tsdf
     and colours within 1e-5; fuse.ply and fuse_post.ply non-empty; the
     seconds of fusion, marching cubes and post-processing and the peak
     device memory printed).
  14. full width, the scale-out and what consumes renders (`phase_dp`), on
     phase 12's scene: `parallel.dp_train_step` for DP_STEPS steps of
     DP_BATCH train cameras in a one-rank NCCL group (one K1, sort, K2 and K3
     per camera), its first step against the same step with no group
     (parameters, Adam moments, the three statistics: per column within 1e-4
     x the column's largest), its gradient against the mean of the
     single-camera steps' and its statistics against their sum (max for the
     radii), and camera 0's gradient through the kernels against the plain
     versions; the same for `dp_train_step_2d` with the scene as surfels (K1,
     K5, K6); the DP step's time, device busy time, idle share and peak
     memory beside DP_BATCH x one train_step; `dp_render` of the 2 test views
     bit-equal to `render()`'s; an ORBIT_FRAMES-frame `generate_ellipse_path`
     rendered by `render` and `render2d` and saved by `save_img_u8` (finite,
     mean alpha above 0), and each orbit's PNGs encoded by
     `render_paths.create_videos` into an MPEG-4 Part 2 `.mp4` on the card
     (`pipeline/video.py`, no cv2; no kernel of K1-K6 launched): byte-equal
     to the encode with device="cpu", the container parsed back
     (ORBIT_FRAMES samples, the VOL's width, height and VIDEO_FPS, stsz
     summing to mdat's payload), the encoder's reconstruction against the
     PNGs at PSNR >= VIDEO_PSNR_MIN, the encode's ms per frame split into
     PNG read, device stages and bit packing plus container, and its bytes
     per frame; `apps.metrics.evaluate_dirs` (use_alpha) over phase 2's renders
     on the card against the CPU (PSNR, SSIM 1e-5, lpips_proxy 1e-4
     relative) and LPIPS with random weights of the true shapes on a 256x256
     crop (1e-4 relative), with each metric's ms per full-width image; one
     `gui_tick` round trip from a client thread on 127.0.0.1 whose frame
     equals encode_image(render()) of the same MiniCam; and
     `apps.segmentation_2d --mask_dir` on a copy of the scene with cv2
     blocked, each alpha equal to the 5x5-ellipse open-then-close of its
     mask. The multi-rank all-reduce needs several cards; the CPU tests hold
     it on gloo ranks (`tests/test_torch_parallel.py`).
  15. long training (`phase_long_training`) on the densification run's
     scene at its own widths (96 views at 800x600, 200k GT gaussians, an
     8k-point init; only the depth is cut): the dataset built on the card
     by `runs.densify_scale_run.build_dataset` (one K1, sort and K2 per
     render, no key dropped in any written image, the card's gaussians
     bit-equal to the CPU's generator; the views that the JAX scripts' 2^21
     key slots would cut are counted); `runs.densify_scale_run.main --pilot
     --grad_threshold 1e-4` (3,000 iterations; finite losses, parameters,
     moments and PLY; 25 densify rounds from 600 with no candidate dropped;
     a Gaussian-capacity growth and a raster regrow; training key drops only
     on iterations followed by their regrow; no evaluation key dropped; the
     SH degree at 3; the opacity reset at 3,000; test PSNR at 3,000 >=
     LONG_PSNR_3K_DB, and the saved PLY re-rendered through `render` on the
     test views within 0.01 dB of it); LONG_PROFILED_STEPS `train_step`s at
     the final state (wall, device busy share); and `apps.train_2dgs` for
     LONG_2DGS_ITERS iterations at its defaults (the same checks but PSNR,
     and each densify round printed). Each stage's launches are held to
     its own tally (steps, evaluation renders, GT renders, re-renders,
     profiled steps).
  16. the NaN hunt and its replay (`phase_nan_hunt`) on phase 15's scene,
     which is removed after it: (a) `apps.train_3dgs.main`, then
     `runs.nan_hunt.main`, each for NAN_HUNT_ITERS (700) iterations at the
     app's defaults, through the densify rounds at 600 and 700: for the
     hunt no fault, no dump, all losses finite; K1, the sort, K2 and K3
     once per step in both; the hunt's ms per iteration beside the
     trainer's (from the first to the last step's start) and phase 15's
     pilot's; (b)
     the hunt again with its `train_step` wrapped: after step
     NAN_PLANT_AFTER (649) returns, the DC colour of every alive row is set
     to 1e30 (the render stays finite at ~1e29, the SSIM's second moments
     overflow, so step 650's loss is NaN; a zero quaternion, the round-4
     trigger, stays finite since the norm is clamped inside the square
     root), and before step NAN_CLEAN_DUMP_AT (640) its inputs are dumped
     by `runs.nan_hunt.dump_step_inputs`: the fault found at 650 (or at
     the full check at 660), the ring's older snapshot (620) replayed with
     the fault planted again, `fault_iter650.npz` written, finite, with
     the planted colours; the replayed losses at 621-649 within 1e-4
     relative of the first pass's (only K3's atomics differ); launches
     equal to the wrapper's count of steps; (c) `runs.nan_replay.main` on
     that dump on the card and with `--device cpu`: both non-finite, first
     at the loss, the same near-degeneracy report, the card's launches 3
     of K1, the sort and K2 and 1 of K3; the clean dump replayed as one
     step on the card and on the CPU's plain versions: the loss within
     1e-5 relative, every parameter and moment column within 1e-4 x its
     largest (K3's atomics rule); each path's time and a snapshot's bytes.
Every phase holds the fused preprocess's launches to its tally with
K1-K6's: one per 3DGS render without grad, none in a training step.
The kernels are printed as one {"kernels": [...]} JSON line: the fused
preprocess (P) with its launches in phase 2's eval run, phase 6's
evaluations and phases 12-16, and its times from phase 4; K1-K3 with
their launches in the 3DGS training run of phase 6 (K1/K2's in the eval run
of phase 2, and K1's on the 2DGS paths too), K4 with its launches in the
2DGS eval run of phase 8, K5 and K6 with theirs in the 2DGS training run of
phase 10; K1-K3 also with their launches in phase 12 (`launches_scorp`),
K1, K2 and K4-K6 with theirs in phase 13's object stages
(`launches_scorp2d`), K1 and K4 with theirs in its mesh extraction
(`launches_mesh`), and every kernel with its launches on phase 14's main
path (`launches_dp`) and, apart, in that phase's checks
(`launches_dp_checks`), each kernel's launches in each stage of phase 15
(`launches_long`), and K1-K3's in each stage of phase 16 (`launches_nan`:
the clean hunt, the planted hunt's two passes, the card's replay of the
fault).
K1's entry also holds its key width, the key sort's device time
per call (`sort_ms`; `sort_int64_torch_ms` for torch.sort of the keys as
int64, the earlier route), torch.sort's on the same keys as `library_ms`,
and its bound with 8-byte keys beside the bound at the keys' own width.
The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result. Scratch files go to build/smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 rate outside the tensor cores
K2_FLOPS_PER_PAIR = 24      # f32 ops per evaluated (pixel, key) pair in K2
K1_FLOPS_PER_KEY = 60       # f32 ops of the edge-minimum cull per in-range key
K3_FLOPS_PER_PAIR = 45      # f32 ops per (pixel, key) pair up to n_contrib in K3
FOVX, FOVY = 1.2, 0.9       # bench.py's camera


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(text: str):
    """(kernel, line) for each register and spill line of nvcc's
    `-Xptxas -v` report, the kernel named from the entry function that
    precedes it (its template argument kept, e.g. <1> for K5, <3> for the
    fused preprocess at SH degree 3)."""
    kernel = "?"
    for line in text.splitlines():
        if "entry function '_ZN" in line:
            # the nested name: <length><identifier> pieces, the kernel last
            i = line.index("'_ZN") + 4
            while (m := re.match(r"\d+", line[i:])) is not None:
                j = i + m.end()
                kernel, i = line[j:j + int(m.group())], j + int(m.group())
            args = re.match(r"I((?:Lb[01]E)+)E", line[i:])
            if args:
                kernel += "<" + ",".join(re.findall(r"Lb([01])E", args.group(1))) + ">"
            key = re.match(r"I([jy])E", line[i:])  # K1's key type
            if key:
                kernel += {"j": "<u32>", "y": "<u64>"}[key.group(1)]
            deg = re.match(r"ILi(n?)(\d+)EE", line[i:])  # the fused preprocess's SH degree
            if deg:
                kernel += f"<{'-' if deg.group(1) else ''}{deg.group(2)}>"
        elif "registers" in line or "spill" in line:
            yield kernel, line.strip()


def bench_scene_arrays(n: int, seed: int):
    """bench.py:21-49's room-scale distribution: a box plus 32 clusters,
    SH degree 3, log-normal scales around 0.02, random rotations."""
    return bench_scene_draw(n, seed)[:5]


def bench_scene_draw(n: int, seed: int):
    """bench_scene_arrays' arrays, then each Gaussian's cluster and the 32
    cluster centres."""
    from scorp_tpu_torch.core.sh import rgb_to_sh

    rng = np.random.default_rng(seed)
    base = rng.uniform(-2, 2, size=(n, 3))
    cluster_idx = rng.integers(0, 32, size=n)
    centers = rng.uniform(-2, 2, size=(32, 3))
    xyz = (0.35 * base + centers[cluster_idx]).astype(np.float32)
    k = 16
    shs = np.zeros((n, k, 3), np.float32)
    shs[:, 0] = rgb_to_sh(rng.uniform(0.05, 0.95, size=(n, 3))).astype(np.float32)
    shs[:, 1:] = rng.normal(0, 0.03, size=(n, k - 1, 3)).astype(np.float32)
    scales = np.exp(rng.normal(np.log(0.02), 0.5, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1.0 / (1.0 + np.exp(-rng.normal(0.0, 2.0, size=n)))).astype(np.float32)
    return xyz, shs, scales, quats, opacity, cluster_idx, centers


def orbit_pose(angle: float, radius: float = 6.5, height: float = 0.5):
    """C2W rotation (columns right/down/forward) and W2C translation of a
    camera orbiting the origin; angle 0 is bench.py's eye (0, 0.5, -6.5)."""
    eye = np.array([radius * np.sin(angle), height, -radius * np.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_c2w = np.stack([right, down, fwd], axis=1)
    return r_c2w, -r_c2w.T @ eye


def write_scene(scene_dir: str, model_dir: str | None, n: int, width: int, height: int,
                seed: int, device, n_views: int = 4):
    """A COLMAP scene (PINHOLE, `n_views` orbiting views, split.yml with the
    first two views as the test split) and, unless `model_dir` is None, the
    model's refined_aligned/refined_1000.ply: an `n`-gaussian SH-3 scene
    drawn with bench.py's distribution. points3D.bin holds the same `n`
    centres with their DC colours, and the view PNGs are that scene rendered
    by the port on `device`, so training from the points has something to
    fit. Returns the scene's GaussianData, each view's (name, C2W rotation,
    W2C translation), each Gaussian's cluster and the cluster centres."""
    import yaml
    from PIL import Image

    from scorp_tpu_torch.core import colmap
    from scorp_tpu_torch.core.camera import fov2focal, make_camera
    from scorp_tpu_torch.core.plyio import GaussianData, save_gaussian_ply
    from scorp_tpu_torch.core.sh import sh_to_rgb
    from scorp_tpu_torch.render import render

    xyz, shs, scales, quats, opacity, cluster_idx, centers = bench_scene_draw(n, seed)
    g = GaussianData(
        xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
        opacity=np.log(opacity / (1.0 - opacity))[:, None].astype(np.float32),
        scaling=np.log(scales), rotation=quats,
    )
    if model_dir is not None:
        save_gaussian_ply(os.path.join(model_dir, "refined_aligned", "refined_1000.ply"), g)

    os.makedirs(os.path.join(scene_dir, "images"))
    os.makedirs(os.path.join(scene_dir, "sparse"))
    names, images, views = [], {}, []
    bg = np.zeros(3, np.float32)
    for i in range(n_views):
        r_c2w, t_w2c = orbit_pose(2 * np.pi * i / n_views)
        name = f"view_{i:03d}"
        names.append(name)
        views.append((name, r_c2w, t_w2c))
        cam = make_camera(r_c2w, t_w2c, FOVX, FOVY, width, height, device=device)
        img = render(cam, g, bg)["render"].clamp(0.0, 1.0).cpu().numpy()
        Image.fromarray(np.round(img.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            os.path.join(scene_dir, "images", name + ".png"))
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(r_c2w.T), t_w2c, 1, name + ".png",
            np.zeros((0, 2)), np.zeros(0, np.int64))
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array(
        [fov2focal(FOVX, width), fov2focal(FOVY, height), width / 2, height / 2]))}
    colmap.write_intrinsics_binary(cams, os.path.join(scene_dir, "sparse", "cameras.bin"))
    colmap.write_extrinsics_binary(images, os.path.join(scene_dir, "sparse", "images.bin"))
    rgb = np.round(np.clip(sh_to_rgb(shs[:, 0]), 0, 1) * 255).astype(np.uint8)
    colmap.write_points3D_binary(xyz, rgb, np.zeros((n, 1)),
                                 os.path.join(scene_dir, "sparse", "points3D.bin"))
    with open(os.path.join(scene_dir, "split.yml"), "w") as f:
        yaml.safe_dump({"train": names[2:], "test": names[:2]}, f)
    return g, views, cluster_idx, centers


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PAD_KERNELS = 256  # spin kernels that open and close each kernel_ms trace, not counted


def kernel_ms(fn, name: str, reps: int = 20, per_call: int | None = 1) -> float:
    """Device time in ms per call of the CUDA kernels whose name contains
    `name`, over `reps` calls of fn() after a warm-up, from a torch.profiler
    (CUPTI) trace: the kernel alone, without the host's work per call
    (allocating outputs, the ctypes launch) that `cuda_ms` counts when the
    device waits for it. The trace must hold `reps` x `per_call` such
    kernels (`per_call=None`: as many as a trace of one call holds): a
    trace that lost records is taken once more, and raises if it is short
    again. On the H100 a trace can lose its first kernel records (none in
    phases 3-4, then 1-2 from phase 7 on, up to ~20 on a slower host, in
    PR 13's runs) and rarely its last, so each trace opens and closes with
    PAD_KERNELS spin kernels, which are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(calls: int) -> tuple[int, float]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(100)
            for _ in range(calls):
                fn()
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        matched = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and name in e.key and "spin_kernel" not in e.key]
        return (sum(e.count for e in matched),
                sum(e.self_device_time_total for e in matched))

    fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        expected = reps * (per_call if per_call is not None else trace(1)[0])
        count, total = trace(reps)
        if count == expected > 0:
            return total / 1e3 / reps
        print(f"  kernel_ms({name!r}): the trace of {reps} calls holds {count} kernels, "
              f"not {expected} (attempt {attempt} of 2)")
    raise AssertionError(f"kernel_ms({name!r}): the trace lost records twice")


def dispatched_ops(fn) -> int:
    """ATen ops that one call of fn() dispatches: its host-side work, which
    does not depend on the tensor sizes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with _Count() as counter:
        fn()
    return counter.n


def device_profile(fn, reps: int):
    """torch.profiler trace of `reps` calls of fn(): (device ms per call,
    [(kernel, device ms per call)] of the 8 longest). Device time is the sum
    over the trace's CUDA events; one stream, so they do not overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the device's own work: the program's spans also appear on its timeline
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    dev.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    return busy, [(e.key[:110], e.self_device_time_total / 1e3 / reps) for e in dev[:8]]


def step_parts_ms(step, reps: int = 10) -> dict:
    """Medians over `reps` calls of step() (after a warm-up) of the device's
    busy ms in each of a training step's three parts, read from the
    program's spans in a torch.profiler trace. On the device's timeline
    "forward" runs from the first kernel of `step.forward` to the last of
    its `step.loss` (CUPTI ties a kernel to the innermost open span),
    "adam + statistics" is the footprint of `step.update`, and "backward"
    the time between the two: autograd launches the backward's kernels from
    its own thread, where `step.backward` is not open. Busy time, not the
    parts' lengths, since the profiler slows the host that feeds the
    device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    spans = {"step.forward": [], "step.loss": [], "step.update": []}
    kernels = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif not getattr(e, "is_user_annotation", False):
            kernels.append((e.time_range.start, e.time_range.end))
    if any(len(v) != reps for v in spans.values()):
        raise AssertionError(f"step_parts_ms: the trace holds "
                             f"{ {k: len(v) for k, v in spans.items()} } spans, not {reps} each")

    def busy(a, b):
        return sum(max(0.0, min(e, b) - max(s, a)) for s, e in kernels) / 1e3

    fwd, loss, upd = (sorted(spans[k]) for k in spans)
    parts = {"forward": [busy(f[0], lo[1]) for f, lo in zip(fwd, loss)],
             "backward": [busy(lo[1], u[0]) for lo, u in zip(loss, upd)],
             "adam + statistics": [busy(*u) for u in upd]}
    return {k: statistics.median(v) for k, v in parts.items()}

def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def check_composite(got, ref, label: str) -> float:
    """K2 kernel outputs against its plain version's: color, alpha and
    depth/alpha within max 5e-3 and mean 1e-5, n_contrib equal on >= 99.9%
    of pixels. Returns the largest max |diff|."""
    import torch

    one = torch.ones((), device=got[0].device)

    def depth_norm(out):
        return out[1] / torch.where(out[2] == 0, one, out[2])

    err = 0.0
    for name, a, b in [("color", got[0], ref[0]), ("alpha", got[2], ref[2]),
                       ("depth/alpha", depth_norm(got), depth_norm(ref))]:
        d = (a - b).abs()
        mx, mean = float(d.max()), float(d.mean())
        err = max(err, mx)
        check(mx <= 5e-3 and mean <= 1e-5,
              f"K2 {label} {name}: max |diff| {mx:.3g} <= 5e-3, mean {mean:.3g} <= 1e-5")
    same = float((got[3] == ref[3]).to(torch.float32).mean())
    check(same >= 0.999, f"K2 {label} n_contrib equal on {100 * same:.4f}% of pixels")
    names = ["color", "depth", "alpha", "n_contrib", "t_final"]
    differ = [f"{name} ({int((a != b).sum())} values)" for name, a, b in zip(names, got, ref)
              if a is not None and not torch.equal(a, b)]
    check(not differ, f"K2 {label}: every output bit-identical to the plain version, n_contrib "
          f"equal on every pixel (differing: {', '.join(differ) or 'none'})")
    return err


def gauss_slot_counts(data, tile_start, tile_count, n_contrib, tiles_x: int,
                      chunk: int = 32):
    """The (warp, key) slots K2 and K3 walk on a stream, counted from the
    plain `gauss_alpha` and `gauss_warp_mask` on the card, chunked over keys
    (the kernels count nothing): {kernel: {"walked", "mask", "live"}}: the
    slots walked, those the warp mask leaves (the warp loads the key), and
    those in which some active lane has alpha >= 1/255. A K3 lane is active
    below its n_contrib and its warp walks up to the warp's largest; a K2
    lane is active up to the key that ends its pixel (the first key at or
    after n_contrib with alpha >= 1/255) and its warp walks until every lane
    has ended. K3 also gets "touched": the (tile, key) rows its blocks flush
    (some warp emits), 10 global atomics each."""
    import torch

    from scorp_tpu_torch.ops.raster.common import ALPHA_MIN
    from scorp_tpu_torch.ops.raster.composite import (
        PIXELS, TILE, gauss_alpha, gauss_warp_mask, pixel_coords,
    )

    dev = data.device
    count = tile_count.to(torch.int64)
    n_tiles = count.shape[0]
    nc = n_contrib[:, 0].to(torch.int64)                                   # [T, P]
    px, py = pixel_coords(n_tiles, tiles_x, torch.float32, dev)
    t = torch.arange(n_tiles, device=dev)
    x0, y0 = (t % tiles_x) * TILE, (t // tiles_x) * TILE
    max_count = int(count.max())

    def chunks():
        for c0 in range(0, max_count, chunk):
            j = torch.arange(c0, min(c0 + chunk, max_count), device=dev)
            valid = (j[None, :] < count[:, None])[..., None]                # [T, C, 1]
            idx = (tile_start.to(torch.int64)[:, None] + j[None, :]).clamp_max(
                data.shape[0] - 1)
            rows = data[idx]
            yield (j, valid & (gauss_alpha(rows, px, py)["alpha"] >= ALPHA_MIN),
                   gauss_warp_mask(rows, x0, y0))

    with torch.no_grad():
        end = count[:, None].expand(-1, PIXELS).clone()                     # K2 lane ends
        found = torch.zeros_like(end, dtype=torch.bool)
        for j, passes, _ in chunks():
            cand = passes & (j[None, :, None] >= nc[:, None, :])
            first = j[0] + cand.to(torch.int32).argmax(dim=1) + 1
            end = torch.where(cand.any(dim=1) & ~found, first, end)
            found |= cand.any(dim=1)
        limits = {"K2": (end, end.view(n_tiles, 8, 32).amax(-1)),
                  "K3": (nc, torch.minimum(nc.view(n_tiles, 8, 32).amax(-1), count[:, None]))}
        out = {k: dict(walked=0, mask=0, live=0) for k in limits}
        out["K3"]["touched"] = 0
        for j, passes, mask in chunks():
            for name, (lane_end, warp_end) in limits.items():
                active = j[None, :, None] < lane_end[:, None, :]                 # [T, C, P]
                walked = j[None, :, None] < warp_end[:, None, :]                 # [T, C, 8]
                live = (passes & active).view(n_tiles, -1, 8, 32).any(-1) & walked
                out[name]["walked"] += int(walked.sum())
                out[name]["mask"] += int((walked & mask).sum())
                out[name]["live"] += int(live.sum())
                if name == "K3":
                    out[name]["touched"] += int(live.any(-1).sum())
    return out


def print_slots(slots) -> None:
    for name, s in slots.items():
        walked = max(s["walked"], 1)
        print(f"  {name} (warp, key) slots: {s['walked']} walked, {s['mask']} left by the warp "
              f"mask, {s['live']} with a lane at alpha >= 1/255; dead share "
              f"{1 - s['live'] / walked:.4f}, skipped by the mask {1 - s['mask'] / walked:.4f}")


def check_expand(x, label: str) -> int:
    """K1 kernel against its plain version on the same inputs, without the
    cull and with x's cull (one or two ellipses): every key slot identical
    and kept equal, with the keys' own width and, where that is 32 bits,
    with 64-bit keys too. Returns the max |diff| of the keys."""
    import torch

    from scorp_tpu_torch.ops.raster.expand import expand_keys, expand_keys_plain

    widths = [x.key_dtype] + ([torch.int64] if x.key_dtype == torch.int32 else [])
    err = 0
    for xc, cull in ((x._replace(geo=None, geo2=None), "cull=False"), (x, "cull=True")):
        for dtype in widths:
            keys_k, kept_k = expand_keys(xc._replace(key_dtype=dtype))
            keys_p, kept_p = expand_keys_plain(xc._replace(key_dtype=dtype))
            err = max(err, int((keys_k.long() - keys_p.long()).abs().max()))
            check(torch.equal(keys_k, keys_p) and int(kept_k) == int(kept_p),
                  f"K1 {label} {cull}, {str(dtype)[6:]} keys: all {x.slots} keys identical to "
                  f"the plain version, kept {int(kept_k)}")
    return err


def full_capacity_route(x, cfg):
    """The route as the full-capacity form built it: K1 over all k_cap slots
    (not the frame's x.slots), the keys widened to int64, sorted by
    torch.sort and decoded -> (gid [k2], tile_start, tile_count, dropped)."""
    import torch

    from scorp_tpu_torch.ops.raster.common import _tile_bounds
    from scorp_tpu_torch.ops.raster.expand import expand_keys

    keys, kept = expand_keys(x._replace(slots=x.k_cap))
    s = torch.sort(keys.to(torch.int64)).values
    k2 = min(cfg.stream_cap, x.k_cap)
    start, count = _tile_bounds(s[:k2] >> x.bits_g, x.num_tiles)
    gid = x.order[s[:k2] & ((1 << x.bits_g) - 1)].to(torch.int32)
    dropped = torch.clamp_min(x.total - x.k_cap, 0) + torch.clamp_min(kept - k2, 0)
    return gid, start.to(torch.int32), count.to(torch.int32), dropped


def check_route(x, route, cfg, label: str) -> None:
    """The keys-only sort against torch.sort on K1's keys (the frame's
    x.slots of them), and the route the path built against the
    full-capacity form's int64 decode (`full_capacity_route`): gid on the
    live prefix, its length min(k2, slots), tile_start, tile_count and
    dropped equal."""
    import torch

    from scorp_tpu_torch.ops.raster.expand import expand_keys
    from scorp_tpu_torch.ops.raster.sort import sort_keys

    keys, _ = expand_keys(x)
    check(torch.equal(sort_keys(keys, x.end_bit), torch.sort(keys).values),
          f"sort {label}: keys-only sort of {x.slots} {str(x.key_dtype)[6:]} keys over "
          f"{x.end_bit} bits equals torch.sort")
    gid, start, count, dropped = full_capacity_route(x, cfg)
    live = int(route.tile_count.sum())
    check(route.gid.shape[0] == min(gid.shape[0], x.slots)
          and torch.equal(route.gid[:live], gid[:live])
          and torch.equal(route.tile_start, start) and torch.equal(route.tile_count, count)
          and int(route.num_dropped_keys) == int(dropped),
          f"route {label}: {route.gid.shape[0]} stream slots of a {x.k_cap} capacity; gid's "
          f"{live} live slots, tile ranges and dropped ({int(dropped)}) equal the "
          "full-capacity int64 decode")


def counted_syncs(fn):
    """(fn(), the host synchronisations that call asks of PyTorch), counted
    as the warnings of torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def host_syncs(fn) -> int:
    """Host synchronisations that one call of fn() asks of PyTorch, after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    return counted_syncs(fn)[1]


def host_sync_counts(args, device) -> dict:
    """Host synchronisations of one `render()` of the scene at
    default_raster_config and of one `train_step` at phase 7's setting,
    through APIs that earlier versions of the port have too, so that the
    same count can be taken of a parent's package (put first on sys.path)."""
    import torch

    from scorp_tpu_torch.core.plyio import GaussianData
    from scorp_tpu_torch.render import default_raster_config, render, tuned_raster_config
    from scorp_tpu_torch.train import OptParams, from_gaussian_data, init_adam, train_step

    w, h = args.width, args.height
    xyz, shs, scales, quats, opacity = bench_scene_arrays(args.n, args.seed)
    g = GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                     opacity=np.log(opacity / (1.0 - opacity))[:, None].astype(np.float32),
                     scaling=np.log(scales), rotation=quats)
    state = from_gaussian_data(g, device=device)
    cam = device_camera(w, h, device)
    bg = torch.zeros(3, device=device)
    out = {"render": host_syncs(lambda: render(cam, state, bg,
                                               cfg=default_raster_config(state.capacity)))}
    adam = init_adam(state)
    gt = torch.as_tensor(np.random.default_rng(args.seed).uniform(0, 1, (3, h, w)),
                         dtype=torch.float32, device=device)
    zeros = torch.zeros(1, h, w, device=device)
    cfg = tuned_raster_config(args.n, max_keys=(1 << 20) + (1 << 19) + (1 << 18),
                              stream_keys=(1 << 20) + (1 << 19))
    out["train_step"] = host_syncs(lambda: train_step(
        state, adam, cam, gt, zeros, zeros, 1000, bg, opt=OptParams(), sh_degree=3, cfg=cfg))
    return out


def device_camera(width: int, height: int, device):
    from scorp_tpu_torch.core.camera import look_at_camera

    return look_at_camera(eye=[0, 0.5, -6.5], target=[0, 0, 0], up=[0, 1, 0],
                          fovx=FOVX, fovy=FOVY, width=width, height=height,
                          device=device)


def prep_of(arrays, cam, device):
    import torch

    from scorp_tpu_torch.ops.raster import preprocess_kernel

    xyz, shs, scales, quats, opacity = (torch.as_tensor(a, device=device) for a in arrays)
    return preprocess_kernel(xyz, opacity, cam, shs=shs, sh_degree=3, scales=scales,
                             quats=quats)


def phase_full_width(args, device):
    """Phase 2: the main path through the app, with launch counters."""
    import torch
    from PIL import Image

    from scorp_tpu_torch.apps import render_3dgs
    from scorp_tpu_torch.ops.raster.composite import composite
    from scorp_tpu_torch.ops.raster.expand import expand_keys
    from scorp_tpu_torch.ops.raster.fused_preprocess import preprocess_kernel
    from scorp_tpu_torch.ops.raster.sort import sort_keys

    scene_dir = os.path.join(WORK, "scene")
    model_dir = os.path.join(WORK, "model")
    t0 = time.perf_counter()
    write_scene(scene_dir, model_dir, args.n, args.width, args.height, args.seed, device)
    print(f"  wrote scene (GT rendered by the port) + {args.n}-gaussian PLY in {time.perf_counter() - t0:.2f} s")

    argv = ["-s", scene_dir, "-m", model_dir, "--eval", "--split_yml_name", "split.yml",
            "--not_render_baseline", "--device", str(device)]
    expand_keys.launches = sort_keys.launches = composite.launches = 0
    preprocess_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = render_3dgs.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"preprocess": preprocess_kernel.launches, "expand": expand_keys.launches,
                "sort": sort_keys.launches, "composite": composite.launches}
    peak = torch.cuda.max_memory_allocated()

    records = results[os.path.join(model_dir, "rendered_refined")]
    for r in records:
        print(f"  view {r['image']}: {1e3 * r['seconds']:.3f} ms (render + copy to host), "
              f"dropped {r['num_dropped_keys']}, mean alpha {r['alpha_mean']:.4f}")
    print(f"  app wall {wall:.3f} s; peak device memory {peak / 2**20:.1f} MiB")
    print(f"  launches during the app run: {launches}")
    check(len(records) == 2, "two test views rendered")
    for r in records:
        path = os.path.join(model_dir, "rendered_refined", r["image"] + ".png")
        check(os.path.exists(path), f"{r['image']}.png exists")
        with Image.open(path) as im:
            rgba = np.asarray(im)
        check(rgba.shape == (args.height, args.width, 4), f"{r['image']}.png is RGBA "
              f"{args.width}x{args.height}")
        check(r["num_dropped_keys"] == 0, f"{r['image']}: no dropped keys")
        check(r["alpha_mean"] > 0.01, f"{r['image']}: mean alpha {r['alpha_mean']:.4f} > 0.01")
        covered = float((rgba[..., 3] > 0).mean())
        check(covered > 0.01, f"{r['image']}: {covered:.3f} of pixels covered")
    check(launches["expand"] > 0 and launches["composite"] > 0,
          "both kernels launched on the main path")
    check(launches["sort"] == launches["expand"], "the keys-only sort ran once per expansion")
    check(launches["preprocess"] == launches["composite"],
          "the fused preprocess ran once per eval frame")
    return scene_dir, model_dir, launches, peak


def phase_parity_mid(args, device):
    """Phase 3a: K1 and K2 against their plain versions at 50k / 800x600."""
    import torch

    from scorp_tpu_torch.ops.raster.common import (
        RasterConfig, grid_dims, route_stream, stream_table,
    )
    from scorp_tpu_torch.ops.raster.composite import composite, composite_plain
    from scorp_tpu_torch.ops.raster.expand import expand_inputs

    w, h, k_cap = args.mid_width, args.mid_height, 1 << 19
    cam = device_camera(w, h, device)
    prep = prep_of(bench_scene_arrays(args.mid_n, args.seed), cam, device)
    k1_err = check_expand(expand_inputs(prep, w, h, k_cap, cull=True), "mid")

    bg = torch.tensor([0.2, 0.3, 0.4], device=device)
    route = route_stream(prep, w, h, RasterConfig(max_keys=k_cap))
    args2 = (stream_table(prep)[route.gid].contiguous(), route.tile_start, route.tile_count, bg)
    tiles_x = grid_dims(w, h)[0]
    k2_err = check_composite(composite(*args2, tiles_x=tiles_x, track_ncontrib=True),
                             composite_plain(*args2, tiles_x=tiles_x, track_ncontrib=True),
                             "mid")
    return k1_err, k2_err


def phase_small_reference(args, device):
    """Phase 3b: a small render on the GPU against the plain path on the CPU."""
    import torch

    from scorp_tpu_torch.ops.raster import RasterConfig, rasterize

    w, h = 128, 96
    arrays = bench_scene_arrays(2000, args.seed + 7)
    outs = []
    for dev in (device, torch.device("cpu")):
        xyz, shs, scales, quats, opacity = (torch.as_tensor(a, device=dev) for a in arrays)
        out = rasterize(xyz, opacity, device_camera(w, h, dev), torch.zeros(3, device=dev),
                        shs=shs, sh_degree=3, scales=scales, quats=quats,
                        cfg=RasterConfig(max_keys=1 << 16))
        outs.append(out)
    g, c = outs
    check(bool(torch.isfinite(g.color).all()) and tuple(g.color.shape) == (3, h, w),
          "GPU render finite, shape [3, 96, 128]")
    for name in ("color", "alpha"):
        mx = float((getattr(g, name).cpu() - getattr(c, name)).abs().max())
        check(mx <= 5e-3, f"GPU vs CPU plain path {name}: max |diff| {mx:.3g} <= 5e-3")


def phase_full_kernels(args, device, scene_dir, model_dir):
    """Phase 3c + 4: K1 against the golden at full width, then times."""
    import torch

    from scorp_tpu_torch.core.plyio import load_gaussian_ply
    from scorp_tpu_torch.ops.raster.common import (
        _expand_keys_core, _tile_bounds, grid_dims, route_stream, stream_table,
    )
    from scorp_tpu_torch.ops.raster.composite import composite, composite_plain
    from scorp_tpu_torch.ops.raster.expand import (
        expand_inputs, expand_keys, expand_keys_plain,
    )
    from scorp_tpu_torch.ops.raster.common import preprocess_plain
    from scorp_tpu_torch.ops.raster.fused_preprocess import preprocess_kernel
    from scorp_tpu_torch.ops.raster.sort import sort_keys
    from scorp_tpu_torch.render import default_raster_config, render
    from scorp_tpu_torch.scene import Scene
    from scorp_tpu_torch.config import ModelParams
    from scorp_tpu_torch.train import from_gaussian_data, raster_inputs

    w, h = args.width, args.height
    ply = os.path.join(model_dir, "refined_aligned", "refined_1000.ply")
    g = load_gaussian_ply(ply, max_sh_degree=3)
    state = from_gaussian_data(g, device=device)
    cfg = default_raster_config(state.capacity)
    dataset = ModelParams(source_path=scene_dir, model_path=model_dir, eval=True,
                          split_yml_name="split.yml").finalize()
    scene = Scene(dataset, shuffle=False, load_gaussians=False)
    cam = scene.get_test_cameras()[0].to_torch(device)
    bg = torch.ones(3, device=device)

    route_stream.slots = route_stream.capacity = 0
    frame_ms = cuda_ms(lambda: render(cam, state, bg), 5)
    print(f"  full frame through render(): {frame_ms:.3f} ms (CUDA-event median of 5); key "
          f"slots / capacity over its calls: {route_stream.slots} / {route_stream.capacity} = "
          f"{route_stream.slots / max(route_stream.capacity, 1):.4f}")

    def prep_fn():
        return preprocess_kernel(cam=cam, sh_degree=3,
                                 **raster_inputs(state.params, state.alive))

    prep = prep_fn()
    n = prep.xy.shape[0]
    # the fused preprocess against its plain version on render()'s inputs
    pre_kw = dict(cam=cam, sh_degree=3, **raster_inputs(state.params, state.alive))
    pre_err = check_preprocess(preprocess_kernel(**pre_kw), preprocess_plain(**pre_kw),
                               "full width")
    pre_ms = kernel_ms(lambda: preprocess_kernel(**pre_kw), "::preprocess_kernel<")
    pre_call_ms = cuda_ms(lambda: preprocess_kernel(**pre_kw), 20)
    pre_plain_ms = cuda_ms(lambda: preprocess_plain(**pre_kw), 5)
    # bytes: per row the inputs read (xyz 12, opacity 4, scales 12, quats 16,
    # 16 SH bands 192, alive 1) and the outputs written (xy 8, depth 4, conic
    # 12, color 12, radii 4, rect 16, valid 1), and the camera's 37 floats;
    # its few hundred f32 operations a row take a tenth of that time
    pre_bytes = n * (237 + 57) + 37 * 4
    pre_bound = pre_bytes / HBM_BYTES_PER_S
    x = expand_inputs(prep, w, h, cfg.max_keys, cull=True)
    k1_err = check_expand(x, "full width")
    check_route(x, route_stream(prep, w, h, cfg), cfg, "full-width eval stream")
    kept = int(expand_keys(x)[1])
    golden = int(_expand_keys_core(prep, w, h, cfg.max_keys, cull=True)[7])
    check(0.8 * golden <= kept <= golden + 1000,
          f"K1 full width: kept {kept} within [0.8, 1] x golden {golden} (+1000)")
    in_range = int(torch.clamp_max(x.total, cfg.max_keys))
    print(f"  the full-width frame's keys: total {int(x.total)} expanded, {kept} kept, "
          f"{x.slots} slots of a {x.k_cap} capacity")

    k1_ms = kernel_ms(lambda: expand_keys(x), "::expand_keys_kernel")
    k1_call_ms = cuda_ms(lambda: expand_keys(x), 20)
    k1_plain_ms = cuda_ms(lambda: expand_keys_plain(x), 5)
    # bytes: each key slot written once at the keys' width, and per gaussian
    # its start, rect and ellipse read once; the formula of the 64-bit
    # keys (8 B per slot) is printed beside it
    key_bytes = 4 if x.key_dtype == torch.int32 else 8
    k1_bytes = x.slots * key_bytes + n * (4 + 16 + 24) + 8
    k1_bytes_int64 = x.slots * 8 + n * (4 + 16 + 24) + 8
    k1_ops_s = in_range * K1_FLOPS_PER_KEY / F32_FLOPS_PER_S
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops_s)
    k1_bound_int64 = max(k1_bytes_int64 / HBM_BYTES_PER_S, k1_ops_s)
    k1_bound_by = "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops_s else "operations"
    # the key sort: the keys-only sort, torch.sort of the same keys (its
    # yardstick) and torch.sort of the 64-bit keys the port sorted before;
    # device time of every kernel of the call, and of its radix-sort kernels
    keys = expand_keys(x)[0]
    keys64 = keys.to(torch.int64)
    sorts = {
        "keys-only sort": lambda: sort_keys(keys, x.end_bit),
        "torch.sort": lambda: torch.sort(keys),
        "torch.sort int64": lambda: torch.sort(keys64),
    }
    sort_ms = {name: kernel_ms(fn, "", per_call=None) for name, fn in sorts.items()}
    sort_radix_ms = {name: kernel_ms(fn, "RadixSort", per_call=None)
                     for name, fn in sorts.items()}

    route = route_stream(prep, w, h, cfg)
    data = stream_table(prep)[route.gid].contiguous()
    tiles_x = grid_dims(w, h)[0]
    args2 = (data, route.tile_start, route.tile_count, bg)
    k2_ms = kernel_ms(lambda: composite(*args2, tiles_x=tiles_x), "::composite_kernel")
    k2_call_ms = cuda_ms(lambda: composite(*args2, tiles_x=tiles_x), 20)
    k2_plain_ms = cuda_ms(lambda: composite_plain(*args2, tiles_x=tiles_x), 1)
    k2_out = composite(*args2, tiles_x=tiles_x, track_ncontrib=True)
    k2_err = check_composite(
        k2_out, composite_plain(*args2, tiles_x=tiles_x, track_ncontrib=True), "full width")
    pairs = int(k2_out[3].to(torch.int64).sum())
    slots = gauss_slot_counts(data, route.tile_start, route.tile_count, k2_out[3], tiles_x)
    n_tiles = route.tile_start.shape[0]
    streamed = int(route.tile_count.to(torch.int64).sum())
    k2_bytes = streamed * 40 + n_tiles * 8 + 12 + n_tiles * 256 * 5 * 4
    k2_bytes_s = k2_bytes / HBM_BYTES_PER_S
    k2_ops_s = pairs * K2_FLOPS_PER_PAIR / F32_FLOPS_PER_S
    # where a frame's time goes: each stage of render() alone, same inputs
    s_keys = sort_keys(keys, x.end_bit)
    g_sorted = s_keys & ((1 << x.bits_g) - 1)
    stages = {
        "preprocess": cuda_ms(prep_fn, 5),
        "depth argsort + prefix sums": cuda_ms(
            lambda: expand_inputs(prep, w, h, cfg.max_keys, cull=True), 5),
        "K1 expand_keys": k1_call_ms,
        "sort keys (keys-only sort)": cuda_ms(sorts["keys-only sort"], 5),
        "sort keys (torch.sort, not called)": cuda_ms(sorts["torch.sort"], 5),
        "sort keys (torch.sort int64, not called)": cuda_ms(sorts["torch.sort int64"], 5),
        "stream gather": cuda_ms(
            lambda: stream_table(prep)[x.order][g_sorted[:cfg.stream_cap]].contiguous(), 5),
        "tile bounds": cuda_ms(lambda: _tile_bounds(s_keys >> x.bits_g, x.num_tiles), 5),
        "K2 composite": k2_call_ms,
    }
    print("  stages (ms, CUDA-event medians): " + json.dumps(stages))
    print(f"  ATen ops dispatched per call: preprocess {dispatched_ops(prep_fn)}, "
          f"render() {dispatched_ops(lambda: render(cam, state, bg))}")
    busy_ms, top = device_profile(lambda: render(cam, state, bg), 5)
    if top:
        print(f"  device busy per frame (torch.profiler, 5 frames): {busy_ms:.3f} ms of a "
              f"{frame_ms:.3f} ms frame -> idle share {1 - busy_ms / frame_ms:.3f}")
        for name, ms in top:
            print(f"    {ms:8.4f} ms  {name}")
    else:
        print("  device busy per frame: not measured (the trace held no CUDA events)")
    print(f"  K1: {k1_ms:.4f} ms ({k1_call_ms:.4f} per call), plain {k1_plain_ms:.3f} ms, bound "
          f"{1e3 * k1_bound:.4f} ms ({x.slots} {8 * key_bytes}-bit key slots, {in_range} in "
          f"range, {kept} kept, {n} gaussians; with 64-bit keys the bound would be "
          f"{1e3 * k1_bound_int64:.4f} ms)")
    print(f"  key sort ({x.end_bit} bits), device ms per call, all kernels / radix-sort kernels: "
          + ", ".join(f"{k} {sort_ms[k]:.4f} / {sort_radix_ms[k]:.4f}" for k in sorts))
    print(f"  K2: {k2_ms:.4f} ms ({k2_call_ms:.4f} per call), plain {k2_plain_ms:.3f} ms, bound "
          f"{1e3 * max(k2_bytes_s, k2_ops_s):.4f} ms ({streamed} streamed keys, "
          f"{pairs} (pixel, key) pairs up to n_contrib at {K2_FLOPS_PER_PAIR} ops each, the "
          f"bound's fixed formula, {n_tiles} tiles)")
    print(f"  fused preprocess: {pre_ms:.4f} ms ({pre_call_ms:.4f} per call), plain "
          f"{pre_plain_ms:.3f} ms, bound {1e3 * pre_bound:.4f} ms ({n} rows at SH degree 3, "
          f"{pre_bytes} bytes)")
    print_slots({"K2": slots["K2"]})
    return {
        "frame_ms": frame_ms,
        "stages": stages,
        "preprocess": dict(ms=pre_ms, ms_per_call=pre_call_ms, plain_ms=pre_plain_ms,
                           bound_ms=1e3 * pre_bound, bound_by="bytes", err=pre_err, rows=n),
        "k1": dict(ms=k1_ms, ms_per_call=k1_call_ms, plain_ms=k1_plain_ms,
                   bound_ms=1e3 * k1_bound, bound_by=k1_bound_by, kept=kept, golden=golden,
                   err=k1_err, bound_ms_int64_keys=1e3 * k1_bound_int64,
                   key_bits=8 * key_bytes, end_bit=x.end_bit,
                   sort_ms=sort_ms["keys-only sort"],
                   sort_radix_ms=sort_radix_ms["keys-only sort"],
                   library_ms=sort_ms["torch.sort"],
                   sort_int64_torch_ms=sort_ms["torch.sort int64"]),
        "k2": dict(ms=k2_ms, ms_per_call=k2_call_ms, plain_ms=k2_plain_ms, err=k2_err,
                   slots=slots["K2"], bound_ms=1e3 * max(k2_bytes_s, k2_ops_s),
                   bound_by="bytes" if k2_bytes_s >= k2_ops_s else "operations"),
    }


def check_preprocess(got, ref, label: str) -> float:
    """The fused preprocess's outputs against its plain version's: every
    field of `Preprocessed` (radii, rect and valid too) equal bit for bit,
    NaN where NaN. Returns the largest |diff| of the float fields."""
    import torch

    err = 0.0
    for name in got._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if a.dtype == torch.float32 and a.shape == b.shape:
            diff = torch.nan_to_num((a - b).abs(), nan=0.0)
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        same = a.shape == b.shape and bool(torch.equal(a, b))
        check(same, f"fused preprocess {label}: {name} bit-equal to the plain version's"
              + ("" if same or a.shape != b.shape else f" ({int((a != b).sum())} differ)"))
    return err


def backward_inputs(prep, width: int, height: int, cfg, seed: int, device):
    """K3's arguments as the differentiable rasterizer builds them from a
    preprocessed scene (routing, the table's rows, K2's n_contrib and
    t_final), with cotangents drawn from `seed`; plus K2's outputs."""
    import torch

    from scorp_tpu_torch.ops.raster.common import grid_dims, route_stream, stream_table
    from scorp_tpu_torch.ops.raster.composite import composite

    route = route_stream(prep, width, height, cfg)
    table = stream_table(prep)
    data = table[route.gid].contiguous()
    bg = torch.tensor([0.2, 0.3, 0.4], device=device)
    tiles_x = grid_dims(width, height)[0]
    k2_out = composite(data, route.tile_start, route.tile_count, bg, tiles_x=tiles_x,
                       track_ncontrib=True, with_t_final=True)
    rng = np.random.default_rng(seed)
    n_tiles = route.tile_start.shape[0]
    g = [torch.as_tensor(rng.normal(size=(n_tiles, c, 256)), dtype=torch.float32,
                         device=device) for c in (3, 1, 1)]
    args = (data, route.gid, route.tile_start, route.tile_count, bg, *g, k2_out[4],
            k2_out[3], table.shape[0])
    return args, tiles_x, route, k2_out


def check_backward(args, tiles_x: int, label: str) -> float:
    """K3 against its plain version on the same inputs: every value finite,
    d_table within 1e-4 x the column's largest |plain| value per column
    (the atomics add in a run-dependent order), and d_bg = sum T_final
    g_color from K2's t_final against the plain K2's within 1e-5 relative.
    Returns the largest absolute difference of d_table."""
    import torch

    from scorp_tpu_torch.ops.raster.backward import composite_backward, composite_backward_plain
    from scorp_tpu_torch.ops.raster.composite import composite_plain

    got = composite_backward(*args, tiles_x=tiles_x)
    ref = composite_backward_plain(*args, tiles_x=tiles_x)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all()),
          f"K3 {label}: d_table finite ({tuple(got.shape)})")
    diff = (got - ref).abs().amax(dim=0)
    scale = ref.abs().amax(dim=0)
    ratio = float((diff / torch.clamp_min(scale, 1e-30)).max())
    check(bool((diff <= 1e-4 * scale).all()),
          f"K3 {label}: per column max |diff| <= 1e-4 x max |plain| (worst {ratio:.3g})")
    data, _, start, count, bg, g_color = args[:6]
    t_plain = composite_plain(data, start, count, bg, tiles_x=tiles_x, with_t_final=True)[4]
    d_bg = (args[8] * g_color).sum(dim=(0, 2))
    d_bg_plain = (t_plain * g_color).sum(dim=(0, 2))
    err = float((d_bg - d_bg_plain).abs().max())
    check(err <= 1e-5 * float(d_bg_plain.abs().max()) and bool(torch.isfinite(d_bg).all()),
          f"d_bg {label}: from K2's t_final within 1e-5 relative of the plain K2's ({err:.3g})")
    return float(diff.max())


def phase_backward_parity(args, device):
    """Phase 5: K3 against its plain version at 50k / 800x600, and a small
    rasterize backward on the GPU against the CPU plain path."""
    import torch

    from scorp_tpu_torch.ops.raster import RasterConfig, rasterize

    w, h = args.mid_width, args.mid_height
    prep = prep_of(bench_scene_arrays(args.mid_n, args.seed), device_camera(w, h, device),
                   device)
    k3_args, tiles_x, _, _ = backward_inputs(prep, w, h, RasterConfig(max_keys=1 << 19),
                                             args.seed + 3, device)
    k3_err = check_backward(k3_args, tiles_x, "mid")

    w, h = 128, 96
    arrays = bench_scene_arrays(2000, args.seed + 7)
    target = np.random.default_rng(args.seed).uniform(0, 1, (3, h, w)).astype(np.float32)
    grads = []
    for dev in (device, torch.device("cpu")):
        xyz, shs, scales, quats, opacity = (torch.as_tensor(a, device=dev).requires_grad_(True)
                                            for a in arrays)
        bg = torch.zeros(3, device=dev, requires_grad=True)
        out = rasterize(xyz, opacity, device_camera(w, h, dev), bg, shs=shs, sh_degree=3,
                        scales=scales, quats=quats, cfg=RasterConfig(max_keys=1 << 16))
        loss = ((out.color - torch.as_tensor(target, device=dev)) ** 2).mean() \
            + 0.1 * out.alpha.mean() + 0.01 * out.depth_accum.mean()
        grads.append([x.cpu() for x in torch.autograd.grad(
            loss, [xyz, shs, scales, quats, opacity, bg])])
    for name, a, b in zip(("xyz", "shs", "scales", "quats", "opacity", "bg"), *grads):
        scale = max(float(b.abs().max()), 1e-12)
        mx = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and mx <= 1e-4 * scale,
              f"rasterize backward GPU vs CPU plain path, d{name}: max |diff| {mx:.3g} "
              f"<= 1e-4 x {scale:.3g}")
    return k3_err


def phase_train_app(args, device, scene_dir):
    """Phase 6: the training main path, apps.train_3dgs on cuda from the
    scene's points3D.bin, with launch counters."""
    import torch

    from scorp_tpu_torch.apps import train_3dgs
    from scorp_tpu_torch.core.plyio import load_gaussian_ply
    from scorp_tpu_torch.ops.raster.backward import composite_backward
    from scorp_tpu_torch.ops.raster.composite import composite
    from scorp_tpu_torch.ops.raster.expand import expand_keys
    from scorp_tpu_torch.ops.raster.fused_preprocess import preprocess_kernel
    from scorp_tpu_torch.ops.raster.sort import sort_keys

    model_dir = os.path.join(WORK, "train_model")
    iters = args.train_iters
    # opacity_cull 0.005 is the original 3DGS value: this repo's default
    # (0.6) prunes every point still at its initial opacity 0.1, which after
    # a few iterations is all of them, so nothing would be left to split
    argv = ["-s", scene_dir, "-m", model_dir, "--eval", "--split_yml_name", "split.yml",
            "--iterations", str(iters), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter", str(iters),
            "--test_iterations", "1", str(iters), "--save_iterations", str(iters),
            "--opacity_cull", "0.005", "--device", str(device)]
    expand_keys.launches = sort_keys.launches = 0
    composite.launches = composite_backward.launches = preprocess_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, adam, log = train_3dgs.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"preprocess": preprocess_kernel.launches, "expand": expand_keys.launches,
                "sort": sort_keys.launches, "composite": composite.launches,
                "backward": composite_backward.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = log["loss"]
    n_alive = int(state.num_alive())
    print(f"  app wall {wall:.3f} s for {iters} iterations; peak device memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}")
    print(f"  loss first {losses[0]:.6f}, last {losses[-1]:.6f}; alive {n_alive} of "
          f"capacity {state.capacity}; capacity changes {log['capacity']}; "
          f"raster regrows {log['raster_keys']}; dropped keys per iteration "
          f"{log['dropped_keys']}")
    check(launches["expand"] > 0 and launches["composite"] > 0 and launches["backward"] > 0,
          "K1, K2 and K3 launched on the training path")
    check(launches["backward"] >= iters, f"K3 launched once per step ({launches['backward']})")
    check(0 < launches["preprocess"] == launches["composite"] - launches["backward"],
          "the fused preprocess ran once per evaluation render, in no training step "
          f"({launches['preprocess']})")
    check(launches["sort"] == launches["expand"], "the keys-only sort ran once per expansion")
    check(len(losses) == iters and all(np.isfinite(losses)), "every step's loss is finite")
    for it, res in log["eval"]:
        print(f"  eval after iteration {it}: " + ", ".join(
            f"{name} L1 {l1:.5f} PSNR {p:.3f}" for name, (l1, p) in res.items()))
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values())
          and all(bool(torch.isfinite(v).all()) for v in (*adam.m.values(), *adam.v.values())),
          "no NaN or inf in the parameters and moments")
    check(len(log["capacity"]) > 0 and n_alive != args.n,
          f"densification ran and the capacity grew ({args.n} -> {n_alive} alive)")
    dropped = log["dropped_keys"]
    check(dropped[-1] == 0 and all(dropped[i + 1] == 0 for i in range(iters - 1) if dropped[i]),
          "no keys dropped at the last step nor after any raster regrow")
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{iters}", "point_cloud.ply")
    g = load_gaussian_ply(ply, max_sh_degree=3)
    check(g.n == n_alive and bool(np.isfinite(g.xyz).all()),
          f"iteration_{iters}/point_cloud.ply written and loads back ({g.n} gaussians)")
    return launches, {"wall_s": wall, "loss_first": losses[0], "loss_last": losses[-1],
                      "alive": n_alive, "peak_mib": peak / 2**20, "eval": log["eval"]}


def phase_train_step(args, device):
    """Phase 7: one train_step at full width (bench.py's training
    measurement): times, ops, device busy time and peak memory; K3 against
    its plain version on the step's inputs, and K3's times."""
    import torch

    from scorp_tpu_torch.core.plyio import GaussianData
    from scorp_tpu_torch.ops.losses import l1_loss, ssim
    from scorp_tpu_torch.ops.raster.backward import composite_backward, composite_backward_plain
    from scorp_tpu_torch.ops.raster.composite import composite, composite_plain
    from scorp_tpu_torch.ops.raster.expand import expand_inputs
    from scorp_tpu_torch.ops.raster.fused_preprocess import preprocess_kernel
    from scorp_tpu_torch.render import tuned_raster_config
    from scorp_tpu_torch.train import (OptParams, from_gaussian_data, init_adam, raster_inputs,
                                       train_step)

    w, h = args.width, args.height
    xyz, shs, scales, quats, opacity = bench_scene_arrays(args.n, args.seed)
    g = GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                     opacity=np.log(opacity / (1.0 - opacity))[:, None].astype(np.float32),
                     scaling=np.log(scales), rotation=quats)
    state = from_gaussian_data(g, device=device)
    adam = init_adam(state)
    cam = device_camera(w, h, device)
    gt = torch.as_tensor(np.random.default_rng(args.seed).uniform(0, 1, (3, h, w)),
                         dtype=torch.float32, device=device)
    zeros = torch.zeros(1, h, w, device=device)
    bg = torch.zeros(3, device=device)
    cfg = tuned_raster_config(args.n, max_keys=(1 << 20) + (1 << 19) + (1 << 18),
                              stream_keys=(1 << 20) + (1 << 19))
    opt = OptParams()

    def step():
        return train_step(state, adam, cam, gt, zeros, zeros, 1000, bg, opt=opt,
                          sh_degree=3, cfg=cfg)

    first = step()[2]
    check(int(first.num_dropped_keys) == 0, "first step: no dropped keys")
    composite_backward.launches = composite.launches = preprocess_kernel.launches = 0
    last = step()[2]
    per_step = {"K2": composite.launches, "K3": composite_backward.launches}
    check(int(last.num_dropped_keys) == 0 and bool(torch.isfinite(last.loss)),
          f"last step: no dropped keys, loss {float(last.loss):.6f} finite")
    check(preprocess_kernel.launches == 0, "the training step launches no fused preprocess")

    # the step between CUDA events, and its three parts from the program's
    # spans (step_parts_ms): medians of 10 steps after one warm-up step
    totals = []
    for _ in range(11):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        totals.append(ev[0].elapsed_time(ev[1]))
    step_ms = statistics.median(totals[1:])
    parts = step_parts_ms(step, 10)
    ops = dispatched_ops(step)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    busy_ms, top = device_profile(step, 5)
    print(f"  train_step: {step_ms:.3f} ms (CUDA-event median of 10 after a warm-up; "
          f"fastest {min(totals[1:]):.3f}, slowest {max(totals[1:]):.3f}); "
          "parts' device busy ms " + json.dumps({k: round(v, 4) for k, v in parts.items()}))
    print(f"  ATen ops dispatched per step: {ops}; peak device memory {peak / 2**20:.1f} MiB; "
          f"launches per step {per_step}")
    if top:
        print(f"  device busy per step (torch.profiler, 5 steps): {busy_ms:.3f} ms of a "
              f"{step_ms:.3f} ms step -> idle share {1 - busy_ms / step_ms:.3f}")
        for name, ms in top:
            print(f"    {ms:8.4f} ms  {name}")
    else:
        print("  device busy per step: not measured (the trace held no CUDA events)")

    # the loss alone: L1 + SSIM forward and backward on a rendered-size image
    image = torch.rand(3, h, w, device=device, requires_grad=True)

    def loss_fn():
        loss = (1.0 - opt.lambda_dssim) * l1_loss(image, gt) \
            + opt.lambda_dssim * (1.0 - ssim(image, gt))
        return torch.autograd.grad(loss, image)

    loss_ms = cuda_ms(loss_fn, 10)
    loss_busy, _ = device_profile(loss_fn, 5)
    print(f"  L1 + SSIM forward + backward alone: {loss_ms:.3f} ms (CUDA-event median of 10), "
          f"device busy {loss_busy:.3f} ms, {dispatched_ops(loss_fn)} ATen ops")

    # K3 on the step's own inputs (the routing of the step's forward)
    with torch.no_grad():
        prep = preprocess_kernel(cam=cam, sh_degree=3,
                                 **raster_inputs(state.params, state.alive))
        k3_args, tiles_x, route, k2_out = backward_inputs(prep, w, h, cfg, args.seed + 5,
                                                          device)
        x = expand_inputs(prep, w, h, cfg.max_keys, cull=True)
        check_route(x, route, cfg, "full-width training stream")
        k3_err = check_backward(k3_args, tiles_x, "full width")
        k2_args = (k3_args[0], *k3_args[2:5])  # data, tile_start, tile_count, bg
        k2_err = check_composite(k2_out, composite_plain(*k2_args, tiles_x=tiles_x,
                                                         track_ncontrib=True, with_t_final=True),
                                 "training stream")
        k3_ms = kernel_ms(lambda: composite_backward(*k3_args, tiles_x=tiles_x),
                          "::composite_backward_kernel")
        k3_call_ms = cuda_ms(lambda: composite_backward(*k3_args, tiles_x=tiles_x), 20)
        k3_plain_ms = cuda_ms(lambda: composite_backward_plain(*k3_args, tiles_x=tiles_x), 1)
        k2_train_ms = kernel_ms(lambda: composite(*k2_args, tiles_x=tiles_x, track_ncontrib=True,
                                                  with_t_final=True), "::composite_kernel")
        nc = k2_out[3][:, 0].to(torch.int64)                                # [T, 256]
        count = route.tile_count.to(torch.int64)[:, None]
        pairs = int(torch.minimum(nc, count).sum())
        # (warp, key) pairs a warp walks: up to the warp's largest n_contrib
        warp_keys = int(torch.minimum(nc.view(-1, 8, 32).amax(dim=2), count).sum())
        streamed = int(route.tile_count.to(torch.int64).sum())
        slots = gauss_slot_counts(k3_args[0], route.tile_start, route.tile_count, k2_out[3],
                                  tiles_x)
    n_tiles, n_rows = route.tile_start.shape[0], k3_args[-1]
    atomics = 10 * warp_keys
    k3_ops = pairs * K3_FLOPS_PER_PAIR + atomics
    k3_bytes = streamed * 44 + n_tiles * 8 + 12 + n_tiles * 256 * 28 + n_rows * 40
    k3_bytes_s, k3_ops_s = k3_bytes / HBM_BYTES_PER_S, k3_ops / F32_FLOPS_PER_S
    print(f"  K3: {k3_ms:.4f} ms ({k3_call_ms:.4f} per call), plain {k3_plain_ms:.3f} ms, bound "
          f"{1e3 * max(k3_bytes_s, k3_ops_s):.4f} ms ({streamed} streamed keys, {pairs} "
          f"(pixel, key) pairs up to n_contrib, {atomics} atomic adds at most = "
          f"{100 * atomics / k3_ops:.2f}% of its operations, {n_rows} table rows)")
    print(f"  K2 with n_contrib and t_final (the training forward): {k2_train_ms:.4f} ms")
    print_slots(slots)
    touched = slots["K3"]["touched"]
    print(f"  K3 global atomics: {10 * touched} (10 per touched (block, gaussian row) pair, "
          f"{touched} pairs) against the bound's {atomics} (10 per walked (warp, key) pair, the "
          "bound's fixed formula, so that its share stays comparable across versions)")
    return {
        "step_ms": step_ms, "parts": parts, "ops": ops, "busy_ms": busy_ms if top else None,
        "loss_ms": loss_ms, "loss_busy_ms": loss_busy,
        "peak_mib": peak / 2**20, "per_step": per_step, "k2_train_ms": k2_train_ms,
        "key_bits": 32 if x.key_dtype == torch.int32 else 64,
        "k2_err": k2_err, "k2_slots": slots["K2"],
        "k3": dict(ms=k3_ms, ms_per_call=k3_call_ms, plain_ms=k3_plain_ms, err=k3_err,
                   slots=slots["K3"], atomics=10 * touched,
                   bound_ms=1e3 * max(k3_bytes_s, k3_ops_s),
                   bound_by="bytes" if k3_bytes_s >= k3_ops_s else "operations"),
    }


# --- the 2DGS surfel path (phases 8-10) -------------------------------------

K4_FLOPS_PER_PAIR = 42      # f32 ops of the surfel geometry per evaluated (pixel, key) pair
K6_FLOPS_PER_PAIR = 130     # f32 ops per (pixel, key) pair up to n_contrib in K6


def surfel_gaussians(n: int, seed: int):
    """bench.py's scene as surfels (bench.py:293-300): its first two scales."""
    from scorp_tpu_torch.core.plyio import GaussianData

    xyz, shs, scales, quats, opacity = bench_scene_arrays(n, seed)
    return GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                        opacity=np.log(opacity / (1.0 - opacity))[:, None].astype(np.float32),
                        scaling=np.log(scales[:, :2]), rotation=quats)


def surfel_stream(means3d, opacities, cam, w, h, cfg, **kw):
    """The surfel routing as `rasterize_surfel` builds it, without grad:
    (prep, K1's inputs with the conic and the circle, routing, per-surfel
    table, stream rows)."""
    import torch

    from scorp_tpu_torch.ops.raster import (
        preprocess_surfel, route_stream, surfel_cull_ellipses, surfel_table,
    )
    from scorp_tpu_torch.ops.raster.expand import expand_inputs

    with torch.no_grad():
        prep = preprocess_surfel(means3d, opacities, cam, **kw)
        ell, circ = surfel_cull_ellipses(prep)
        x = expand_inputs(prep, w, h, cfg.max_keys, True, ell, circ)
        route = route_stream(prep, w, h, cfg, geo=ell, geo2=circ)
        table = surfel_table(prep)
        data = table[route.gid].contiguous()
    return prep, x, route, table, data


def surfel_stream_of_state(state, cam, w, h, cfg):
    from scorp_tpu_torch.train import raster_inputs

    return surfel_stream(cam=cam, w=w, h=h, cfg=cfg, sh_degree=3,
                         **raster_inputs(state.params, state.alive))


def check_surfel_forward(got, ref, label: str, kernel: str) -> float:
    """K4/K5 outputs against the plain version's: every float channel within
    max 5e-3 and mean 1e-5; K5's n_contrib and n_med equal on >= 99.9% of
    pixels. Returns the largest max |diff|."""
    import torch

    names = ["color", "alpha", "depth", "normal", "median", "distortion",
             "n_contrib", "n_med", "sum w m", "sum w m^2", "T_final"]
    err = 0.0
    for name, a, b in zip(names, got, ref):
        if a.dtype == torch.int32:
            same = float((a == b).to(torch.float32).mean())
            check(same >= 0.999, f"{kernel} {label} {name} equal on {100 * same:.4f}% of pixels")
            continue
        d = (a - b).abs()
        mx, mean = float(d.max()), float(d.mean())
        err = max(err, mx)
        check(bool(torch.isfinite(a).all()) and mx <= 5e-3 and mean <= 1e-5,
              f"{kernel} {label} {name}: max |diff| {mx:.3g} <= 5e-3, mean {mean:.3g} <= 1e-5")
    return err


def surfel_backward_inputs(route, table, data, tiles_x, seed, device):
    """K6's arguments as `_SurfelComposite` builds them (K5's residuals on
    the stream) with the six cotangents drawn from `seed`; and K5's outputs."""
    import torch

    from scorp_tpu_torch.ops.raster.surfel_composite import surfel_composite_train

    bg = torch.tensor([0.2, 0.3, 0.4], device=device)
    k5 = surfel_composite_train(data, route.tile_start, route.tile_count, bg, tiles_x=tiles_x)
    rng = np.random.default_rng(seed)
    n_tiles = route.tile_start.shape[0]
    g = [torch.as_tensor(rng.normal(size=(n_tiles, c, 256)), dtype=torch.float32,
                         device=device) for c in (3, 1, 1, 3, 1, 1)]
    n_contrib, n_med, wm, wm2, t_final = k5[6:]
    args = (data, route.gid, route.tile_start, route.tile_count, bg, *g, t_final, n_contrib,
            n_med, wm, wm2, table.shape[0])
    return args, k5


def check_surfel_backward(args, tiles_x: int, label: str) -> float:
    """K6 against its plain version on the same inputs: every value finite,
    d_table within 1e-4 x the column's largest |plain| value per column (the
    atomics add in a run-dependent order), and d_bg = sum T_final g_color from
    K5's T_final against the plain K5's within 1e-5 relative. Returns the
    largest absolute difference of d_table and the largest per-column ratio
    of difference to column maximum."""
    import torch

    from scorp_tpu_torch.ops.raster.surfel_backward import surfel_backward, surfel_backward_plain
    from scorp_tpu_torch.ops.raster.surfel_composite import surfel_composite_plain

    got = surfel_backward(*args, tiles_x=tiles_x)
    ref = surfel_backward_plain(*args, tiles_x=tiles_x)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all()),
          f"K6 {label}: d_table finite ({tuple(got.shape)})")
    diff = (got - ref).abs().amax(dim=0)
    scale = ref.abs().amax(dim=0)
    ratio = float((diff / torch.clamp_min(scale, 1e-30)).max())
    check(bool((diff <= 1e-4 * scale).all()),
          f"K6 {label}: per column max |diff| <= 1e-4 x max |plain| (worst {ratio:.3g}; "
          f"largest column maximum {float(scale.max()):.3g})")
    data, _, start, count, bg, g_color = args[:6]
    t_plain = surfel_composite_plain(data, start, count, bg, tiles_x=tiles_x, train=True)[10]
    d_bg = (args[11] * g_color).sum(dim=(0, 2))
    d_bg_plain = (t_plain * g_color).sum(dim=(0, 2))
    err = float((d_bg - d_bg_plain).abs().max())
    check(err <= 1e-5 * float(d_bg_plain.abs().max()) and bool(torch.isfinite(d_bg).all()),
          f"d_bg {label}: from K5's T_final within 1e-5 relative of the plain K5's ({err:.3g})")
    return float(diff.max()), ratio


def surfel_pairs(n_contrib, route):
    """(pixel, key) pairs up to each pixel's last contributor, and the
    (warp, key) pairs a warp walks (up to the warp's largest n_contrib)."""
    import torch

    nc = n_contrib[:, 0].to(torch.int64)
    count = route.tile_count.to(torch.int64)[:, None]
    pairs = int(torch.minimum(nc, count).sum())
    warp_keys = int(torch.minimum(nc.view(-1, 8, 32).amax(dim=2), count).sum())
    return pairs, warp_keys


def surfel_slot_counts(data, route, n_contrib, tiles_x: int, chunk: int = 32):
    """The (warp, key) slots K5 and K6 walk on a stream, counted from the
    plain `surfel_hit`, `surfel_warp_mask` and `surfel_pretest` on the card,
    chunked over keys (the kernels count nothing): {kernel: {"walked",
    "mask", "pretest", "live"}}: the slots walked, those the warp mask
    leaves (the warp loads the key's geometry), those in which some active
    lane passes the pre-test (hit() runs), and those in which some active
    lane clears the exact tests (alpha >= 1/255, z >= 0.2). A K6 lane is
    active below its n_contrib and its warp walks up to the warp's largest;
    a K5 lane is active up to the key that ends its pixel (the first key at
    or after n_contrib that clears the tests) and its warp walks until every
    lane has ended."""
    import torch

    from scorp_tpu_torch.ops.raster.composite import PIXELS, TILE, pixel_coords
    from scorp_tpu_torch.ops.raster.surfel import ALPHA_MIN, NEAR_PLANE
    from scorp_tpu_torch.ops.raster.surfel_composite import (
        surfel_hit, surfel_pretest, surfel_warp_mask,
    )

    dev = data.device
    count = route.tile_count.to(torch.int64)
    n_tiles = count.shape[0]
    nc = n_contrib[:, 0].to(torch.int64)                                   # [T, P]
    px, py = pixel_coords(n_tiles, tiles_x, torch.float32, dev)
    t = torch.arange(n_tiles, device=dev)
    x0, y0 = (t % tiles_x) * TILE, (t // tiles_x) * TILE
    max_count = int(count.max())

    def chunks():
        for c0 in range(0, max_count, chunk):
            j = torch.arange(c0, min(c0 + chunk, max_count), device=dev)
            valid = (j[None, :] < count[:, None])[..., None]                # [T, C, 1]
            idx = (route.tile_start.to(torch.int64)[:, None] + j[None, :]).clamp_max(
                data.shape[0] - 1)
            rows = data[idx]
            hit = surfel_hit(rows, px, py)
            passes = valid & (hit["alpha"] >= ALPHA_MIN) & (hit["z"] >= NEAR_PLANE)
            yield (j, passes, valid & surfel_pretest(rows, px, py),
                   surfel_warp_mask(rows, x0, y0))

    with torch.no_grad():
        end = count[:, None].expand(-1, PIXELS).clone()                     # K5 lane ends
        found = torch.zeros_like(end, dtype=torch.bool)
        for j, passes, _, _ in chunks():
            cand = passes & (j[None, :, None] >= nc[:, None, :])
            first = j[0] + cand.to(torch.int32).argmax(dim=1) + 1
            end = torch.where(cand.any(dim=1) & ~found, first, end)
            found |= cand.any(dim=1)
        limits = {"K5": (end, end.view(n_tiles, 8, 32).amax(-1)),
                  "K6": (nc, torch.minimum(nc.view(n_tiles, 8, 32).amax(-1), count[:, None]))}
        out = {k: dict(walked=0, mask=0, pretest=0, live=0) for k in limits}
        for j, passes, pre, mask in chunks():
            for name, (lane_end, warp_end) in limits.items():
                active = j[None, :, None] < lane_end[:, None, :]                 # [T, C, P]
                walked = j[None, :, None] < warp_end[:, None, :]                 # [T, C, 8]
                out[name]["walked"] += int(walked.sum())
                out[name]["mask"] += int((walked & mask).sum())
                for key, lanes in (("pretest", pre), ("live", passes)):
                    warp_any = (lanes & active).view(n_tiles, -1, 8, 32).any(-1)
                    out[name][key] += int((warp_any & walked).sum())
    return out


def bound_of(nbytes: float, ops: float):
    """(least time in ms, "bytes" or "operations") on the H100's published rates."""
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def surfel_forward_bound(route, n_contrib, out_floats: int):
    """K4/K5's least time: the geometry of every pair up to n_contrib at the
    f32 rate, or the bytes (84 B per streamed key, 8 B per tile, bg, and
    `out_floats` outputs per pixel: 10 for K4, 15 with K5's residuals)."""
    import torch

    pairs, _ = surfel_pairs(n_contrib, route)
    n_tiles = route.tile_start.shape[0]
    streamed = int(route.tile_count.sum(dtype=torch.int64))
    nbytes = streamed * 84 + n_tiles * 8 + 12 + n_tiles * 256 * out_floats * 4
    return (*bound_of(nbytes, pairs * K4_FLOPS_PER_PAIR), pairs, streamed)


def surfel_backward_bound(route, n_contrib, n_rows: int):
    """K6's least time: ~130 f32 ops per pair up to n_contrib plus 21 atomic
    adds per (warp, key) pair at the f32 rate, or the bytes (88 B per
    streamed key with its gid, 8 B per tile, 15 floats of cotangents and
    residuals per pixel, the [n_rows, 21] gradient)."""
    import torch

    pairs, warp_keys = surfel_pairs(n_contrib, route)
    n_tiles = route.tile_start.shape[0]
    streamed = int(route.tile_count.sum(dtype=torch.int64))
    nbytes = streamed * 88 + n_tiles * 8 + 12 + n_tiles * 256 * 15 * 4 + n_rows * 84
    ops = pairs * K6_FLOPS_PER_PAIR + 21 * warp_keys
    return (*bound_of(nbytes, ops), pairs, 21 * warp_keys)


def phase_surfel_eval(args, device, scene_dir):
    """Phase 8: the 2DGS eval path through apps.render_2dgs at full width,
    with launch counters; K1 with its second ellipse and K4 against their
    plain versions at 50k / 800x600 and at full width, the cull against no
    cull; K4's and a render2d frame's times."""
    import torch
    from PIL import Image

    from scorp_tpu_torch.apps import render_2dgs
    from scorp_tpu_torch.core.plyio import save_gaussian_ply
    from scorp_tpu_torch.ops.raster import RasterConfig, grid_dims
    from scorp_tpu_torch.ops.raster.common import _tile_bounds, sorted_expansion
    from scorp_tpu_torch.ops.raster.expand import expand_keys
    from scorp_tpu_torch.ops.raster.sort import sort_keys
    from scorp_tpu_torch.ops.raster.surfel_composite import (
        surfel_composite, surfel_composite_plain, surfel_composite_train,
    )
    from scorp_tpu_torch.render import default_raster_config
    from scorp_tpu_torch.render2d import render2d
    from scorp_tpu_torch.train import from_gaussian_data

    model_dir = os.path.join(WORK, "model2d")
    g = surfel_gaussians(args.n, args.seed)
    save_gaussian_ply(os.path.join(model_dir, "refined_aligned", "refined_1000.ply"), g)
    argv = ["-s", scene_dir, "-m", model_dir, "--eval", "--split_yml_name", "split.yml",
            "--not_render_baseline", "--device", str(device)]
    expand_keys.launches = sort_keys.launches = surfel_composite.launches = 0
    t0 = time.perf_counter()
    results = render_2dgs.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"expand": expand_keys.launches, "sort": sort_keys.launches,
                "surfel_composite": surfel_composite.launches}
    records = results[os.path.join(model_dir, "rendered_refined")]
    for r in records:
        print(f"  view {r['image']}: {1e3 * r['seconds']:.3f} ms (render2d + copy to host), "
              f"dropped {r['num_dropped_keys']}, mean alpha {r['alpha_mean']:.4f}")
    print(f"  app wall {wall:.3f} s; launches during the app run: {launches}")
    check(len(records) == 2, "two test views rendered")
    for r in records:
        with Image.open(os.path.join(model_dir, "rendered_refined", r["image"] + ".png")) as im:
            rgba = np.asarray(im)
        check(rgba.shape == (args.height, args.width, 4),
              f"{r['image']}.png is RGBA {args.width}x{args.height}")
        check(r["num_dropped_keys"] == 0, f"{r['image']}: no dropped keys")
        covered = float((rgba[..., 3] > 0).mean())
        check(r["alpha_mean"] > 0.01 and covered > 0.01 and float(rgba[..., :3].mean()) > 1.0,
              f"{r['image']}: not black (mean alpha {r['alpha_mean']:.4f}, {covered:.3f} "
              "of pixels covered)")
    check(launches["expand"] > 0 and launches["surfel_composite"] > 0,
          "K1 and K4 launched on the 2DGS eval path")
    check(launches["sort"] == launches["expand"], "the keys-only sort ran once per expansion")

    bg = torch.tensor([0.2, 0.3, 0.4], device=device)
    # 50k / 800x600: K1 with both ellipses and K4 against their plain versions
    w, h = args.mid_width, args.mid_height
    xyz, shs, scales, quats, opacity = (torch.as_tensor(a, device=device)
                                        for a in bench_scene_arrays(args.mid_n, args.seed))
    prep, x, route, table, data = surfel_stream(
        xyz, opacity, device_camera(w, h, device), w, h, RasterConfig(max_keys=1 << 20),
        shs=shs, sh_degree=3, scales=scales[:, :2], quats=quats)
    k1_err = check_expand(x, "surfel mid")
    tiles_x = grid_dims(w, h)[0]
    a4 = (data, route.tile_start, route.tile_count, bg)
    k4 = surfel_composite(*a4, tiles_x=tiles_x)
    k4_err = check_surfel_forward(k4, surfel_composite_plain(*a4, tiles_x=tiles_x), "mid", "K4")
    # the union cull drops only keys with alpha < 1/255 on their whole tile:
    # K4 on the uncut stream (every key of every rect) gives the same images
    with torch.no_grad():
        total = int(x.total)
        st, gs, order, _, _ = sorted_expansion(prep, w, h, total + 1, cull=False)
        start, count = _tile_bounds(st[:total], route.tile_start.shape[0])
        uncut = table[order[gs[:total]]].contiguous()
    k4_uncut = surfel_composite(uncut, start, count, bg, tiles_x=tiles_x)
    worst = max(float((a - b).abs().max()) for a, b in zip(k4, k4_uncut))
    kept = int(route.tile_count.sum())
    check(worst <= 1e-6, f"K1's union cull changes no K4 output at mid size ({kept} of {total} "
          f"rect keys kept; max |diff| {worst:.3g})")

    # full width, on the eval path's state
    w, h = args.width, args.height
    state = from_gaussian_data(g, device=device)
    cfg = default_raster_config(state.capacity)
    cam = device_camera(w, h, device)
    _, x, route, _, data = surfel_stream_of_state(state, cam, w, h, cfg)
    k1_err = max(k1_err, check_expand(x, "surfel full width"))
    check_route(x, route, cfg, "full-width 2DGS eval stream")
    tiles_x = grid_dims(w, h)[0]
    a4 = (data, route.tile_start, route.tile_count, bg)
    k4_err = max(k4_err, check_surfel_forward(
        surfel_composite(*a4, tiles_x=tiles_x), surfel_composite_plain(*a4, tiles_x=tiles_x),
        "full width", "K4"))
    n_contrib = surfel_composite_train(*a4, tiles_x=tiles_x)[6]
    k4_ms = kernel_ms(lambda: surfel_composite(*a4, tiles_x=tiles_x),
                      "::surfel_composite_kernel<false>")
    k4_call_ms = cuda_ms(lambda: surfel_composite(*a4, tiles_x=tiles_x), 20)
    k4_plain_ms = cuda_ms(lambda: surfel_composite_plain(*a4, tiles_x=tiles_x), 1)
    bound_ms, bound_by, pairs, streamed = surfel_forward_bound(route, n_contrib, 10)

    def frame():
        return render2d(cam, state, bg, cfg=cfg)

    frame_ms = cuda_ms(frame, 5)
    ops = dispatched_ops(frame)
    busy_ms, top = device_profile(frame, 5)
    print(f"  K4: {k4_ms:.4f} ms ({k4_call_ms:.4f} per call), plain {k4_plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms "
          f"({bound_by}; {streamed} streamed keys of {int(x.total)} rect keys, {pairs} "
          f"(pixel, key) pairs up to n_contrib, {route.tile_start.shape[0]} tiles)")
    print(f"  2DGS frame through render2d(): {frame_ms:.3f} ms (CUDA-event median of 5), "
          f"{ops} ATen ops")
    if top:
        print(f"  device busy per frame (torch.profiler, 5 frames): {busy_ms:.3f} ms -> idle "
              f"share {1 - busy_ms / frame_ms:.3f}")
        for name, ms in top:
            print(f"    {ms:8.4f} ms  {name}")
    else:
        print("  device busy per frame: not measured (the trace held no CUDA events)")
    return launches, {"k4": dict(ms=k4_ms, ms_per_call=k4_call_ms, plain_ms=k4_plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, err=k4_err),
                      "k1_err": k1_err, "frame_ms": frame_ms}


def phase_surfel_parity(args, device):
    """Phase 9: K5 and K6 against their plain versions on a training stream
    at 50k / 800x600, and a small rasterize_surfel backward on the GPU
    against the CPU plain path."""
    import torch

    from scorp_tpu_torch.ops.raster import RasterConfig, grid_dims, rasterize_surfel
    from scorp_tpu_torch.ops.raster.surfel_composite import surfel_composite_plain

    w, h = args.mid_width, args.mid_height
    xyz, shs, scales, quats, opacity = (torch.as_tensor(a, device=device)
                                        for a in bench_scene_arrays(args.mid_n, args.seed))
    _, _, route, table, data = surfel_stream(
        xyz, opacity, device_camera(w, h, device), w, h, RasterConfig(max_keys=1 << 20),
        shs=shs, sh_degree=3, scales=scales[:, :2], quats=quats)
    tiles_x = grid_dims(w, h)[0]
    k6_args, k5 = surfel_backward_inputs(route, table, data, tiles_x, args.seed + 3, device)
    a5 = (k6_args[0], *k6_args[2:5])  # data, tile_start, tile_count, bg
    k5_plain = surfel_composite_plain(*a5, tiles_x=tiles_x, train=True)
    k5_err = check_surfel_forward(k5, k5_plain, "mid", "K5")
    k6_err = check_surfel_backward(k6_args, tiles_x, "mid")  # (absolute, relative)

    w, h = 128, 96
    arrays = bench_scene_arrays(2000, args.seed + 7)
    target = np.random.default_rng(args.seed).uniform(0, 1, (3, h, w)).astype(np.float32)
    grads = []
    for dev in (device, torch.device("cpu")):
        xyz, shs, scales, quats, opacity = (torch.as_tensor(a, device=dev) for a in arrays)
        leaves = [x.requires_grad_(True) for x in (xyz, shs, scales[:, :2].contiguous(), quats,
                                                   opacity)]
        bg = torch.zeros(3, device=dev, requires_grad=True)
        out = rasterize_surfel(leaves[0], leaves[4], device_camera(w, h, dev), bg,
                               shs=leaves[1], sh_degree=3, scales=leaves[2], quats=leaves[3],
                               cfg=RasterConfig(max_keys=1 << 16))
        loss = (((out.color - torch.as_tensor(target, device=dev)) ** 2).mean()
                + 0.1 * out.alpha.mean() + 0.01 * out.depth_accum.mean()
                + 0.1 * out.normal.square().mean() + 0.01 * out.depth_median.mean()
                + 100.0 * out.distortion.mean())
        grads.append([x.cpu() for x in torch.autograd.grad(loss, leaves + [bg])])
    for name, a, b in zip(("xyz", "shs", "scales", "quats", "opacity", "bg"), *grads):
        scale = max(float(b.abs().max()), 1e-12)
        mx = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and mx <= 1e-4 * scale,
              f"rasterize_surfel backward GPU vs CPU plain path, d{name}: max |diff| "
              f"{mx:.3g} <= 1e-4 x {scale:.3g}")
    return k5_err, k6_err


def phase_surfel_train_app(args, device, scene_dir):
    """Phase 10a: the 2DGS training main path, apps.train_2dgs on cuda from
    the scene's points3D.bin, with launch counters."""
    import torch

    from scorp_tpu_torch.apps import train_2dgs
    from scorp_tpu_torch.core.plyio import load_gaussian_ply
    from scorp_tpu_torch.ops.raster.expand import expand_keys
    from scorp_tpu_torch.ops.raster.sort import sort_keys
    from scorp_tpu_torch.ops.raster.surfel_backward import surfel_backward
    from scorp_tpu_torch.ops.raster.surfel_composite import (
        surfel_composite, surfel_composite_train,
    )

    model_dir = os.path.join(WORK, "train_model2d")
    iters = args.train_iters
    # opacity_cull 0.005: the 2DGS default 0.5 would prune every point
    # still at its initial opacity 0.1 at the first densify
    argv = ["-s", scene_dir, "-m", model_dir, "--eval", "--split_yml_name", "split.yml",
            "--iterations", str(iters), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter", str(iters),
            "--test_iterations", "1", str(iters), "--save_iterations", str(iters),
            "--opacity_cull", "0.005", "--device", str(device)]
    expand_keys.launches = sort_keys.launches = surfel_composite.launches = 0
    surfel_composite_train.launches = surfel_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, adam, log = train_2dgs.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"expand": expand_keys.launches, "sort": sort_keys.launches,
                "surfel_composite": surfel_composite.launches,
                "surfel_composite_train": surfel_composite_train.launches,
                "surfel_backward": surfel_backward.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = log["loss"]
    n_alive = int(state.num_alive())
    print(f"  app wall {wall:.3f} s for {iters} iterations; peak device memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}")
    print(f"  loss first {losses[0]:.6f}, last {losses[-1]:.6f}; alive {n_alive} of "
          f"capacity {state.capacity}; capacity changes {log['capacity']}; "
          f"raster regrows {log['raster_keys']}; dropped keys per iteration "
          f"{log['dropped_keys']}")
    check(launches["expand"] > 0 and launches["surfel_composite_train"] >= iters
          and launches["surfel_backward"] >= iters and launches["surfel_composite"] > 0,
          "K1, K5 and K6 launched once per step, K4 in the evaluations")
    check(launches["sort"] == launches["expand"], "the keys-only sort ran once per expansion")
    check(len(losses) == iters and all(np.isfinite(losses)), "every step's loss is finite")
    for it, res in log["eval"]:
        print(f"  eval after iteration {it}: " + ", ".join(
            f"{name} L1 {l1:.5f} PSNR {p:.3f}" for name, (l1, p) in res.items()))
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values())
          and all(bool(torch.isfinite(v).all()) for v in (*adam.m.values(), *adam.v.values())),
          "no NaN or inf in the parameters and moments")
    check(len(log["densify"]) == 1,
          "one densification ran: (iteration, alive before, clone/split candidates, alive "
          f"after) = {log['densify'][0] if log['densify'] else None}")
    dropped = log["dropped_keys"]
    check(dropped[-1] == 0 and all(dropped[i + 1] == 0 for i in range(iters - 1) if dropped[i]),
          "no keys dropped at the last step nor after any raster regrow")
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{iters}", "point_cloud.ply")
    g = load_gaussian_ply(ply, max_sh_degree=3)
    check(g.n == n_alive and g.scaling.shape[1] == 2 and bool(np.isfinite(g.xyz).all()),
          f"iteration_{iters}/point_cloud.ply written with 2 scale columns ({g.n} surfels)")
    return launches, {"wall_s": wall, "loss_first": losses[0], "loss_last": losses[-1],
                      "alive": n_alive, "peak_mib": peak / 2**20}


def phase_surfel_train_step(args, device):
    """Phase 10b: one train_step_2d at bench.py's 2DGS training measurement
    (bench.py:302-350, 510-524): times, ops, device busy and peak memory; K5
    and K6 on the step's inputs against their plain versions, with times."""
    import torch

    from scorp_tpu_torch.ops.raster import grid_dims
    from scorp_tpu_torch.ops.raster.surfel_backward import surfel_backward, surfel_backward_plain
    from scorp_tpu_torch.ops.raster.surfel_composite import (
        surfel_composite_plain, surfel_composite_train,
    )
    from scorp_tpu_torch.render import tuned_raster_config
    from scorp_tpu_torch.train import Opt2DParams, from_gaussian_data, init_adam, train_step_2d

    w, h = args.width, args.height
    state = from_gaussian_data(surfel_gaussians(args.n, args.seed), capacity=args.n,
                               device=device)
    adam = init_adam(state)
    cam = device_camera(w, h, device)
    gt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (3, h, w)),
                         dtype=torch.float32, device=device)
    zeros = torch.zeros(1, h, w, device=device)
    bg = torch.zeros(3, device=device)
    cfg = tuned_raster_config(args.n, max_keys=(1 << 20) + (1 << 19) + (1 << 18),
                              stream_keys=(1 << 20) + (1 << 19) + (1 << 17))
    opt = Opt2DParams(lambda_dist=100.0)  # the normal and distortion losses on at 8000

    def step():
        return train_step_2d(state, adam, cam, gt, zeros, zeros, 8000, bg, opt=opt,
                             sh_degree=3, cfg=cfg)

    first = step()[2]
    check(int(first.num_dropped_keys) == 0, "first step: no dropped keys")
    surfel_composite_train.launches = surfel_backward.launches = 0
    last = step()[2]
    per_step = {"K5": surfel_composite_train.launches, "K6": surfel_backward.launches}
    check(int(last.num_dropped_keys) == 0 and bool(torch.isfinite(last.loss)),
          f"last step: no dropped keys, loss {float(last.loss):.6f} finite")

    totals = []
    for _ in range(11):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        totals.append(ev[0].elapsed_time(ev[1]))
    step_ms = statistics.median(totals[1:])
    parts = step_parts_ms(step, 10)
    ops = dispatched_ops(step)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    busy_ms, top = device_profile(step, 5)
    print(f"  train_step_2d: {step_ms:.3f} ms (CUDA-event median of 10 after a warm-up; "
          f"fastest {min(totals[1:]):.3f}, slowest {max(totals[1:]):.3f}); "
          "parts' device busy ms " + json.dumps({k: round(v, 4) for k, v in parts.items()}))
    print(f"  ATen ops dispatched per step: {ops}; peak device memory {peak / 2**20:.1f} MiB; "
          f"launches per step {per_step}")
    if top:
        print(f"  device busy per step (torch.profiler, 5 steps): {busy_ms:.3f} ms of a "
              f"{step_ms:.3f} ms step -> idle share {1 - busy_ms / step_ms:.3f}")
        for name, ms in top:
            print(f"    {ms:8.4f} ms  {name}")
    else:
        print("  device busy per step: not measured (the trace held no CUDA events)")

    # K5 and K6 on the step's own inputs (the routing of its forward)
    _, x, route, table, data = surfel_stream_of_state(state, cam, w, h, cfg)
    check_route(x, route, cfg, "full-width 2DGS training stream")
    tiles_x = grid_dims(w, h)[0]
    k6_args, k5 = surfel_backward_inputs(route, table, data, tiles_x, args.seed + 5, device)
    a5 = (k6_args[0], *k6_args[2:5])  # data, tile_start, tile_count, bg
    k5_err = check_surfel_forward(
        k5, surfel_composite_plain(*a5, tiles_x=tiles_x, train=True), "full width", "K5")
    k6_err = check_surfel_backward(k6_args, tiles_x, "full width")
    k5_ms = kernel_ms(lambda: surfel_composite_train(*a5, tiles_x=tiles_x),
                      "::surfel_composite_kernel<true>")
    k5_call_ms = cuda_ms(lambda: surfel_composite_train(*a5, tiles_x=tiles_x), 20)
    k5_plain_ms = cuda_ms(lambda: surfel_composite_plain(*a5, tiles_x=tiles_x, train=True), 1)
    k6_ms = kernel_ms(lambda: surfel_backward(*k6_args, tiles_x=tiles_x),
                      "::surfel_backward_kernel")
    k6_call_ms = cuda_ms(lambda: surfel_backward(*k6_args, tiles_x=tiles_x), 20)
    k6_plain_ms = cuda_ms(lambda: surfel_backward_plain(*k6_args, tiles_x=tiles_x), 1)
    k5_bound, k5_by, pairs, streamed = surfel_forward_bound(route, k5[6], 15)
    k6_bound, k6_by, _, atomics = surfel_backward_bound(route, k5[6], table.shape[0])
    print(f"  K5: {k5_ms:.4f} ms ({k5_call_ms:.4f} per call), plain {k5_plain_ms:.3f} ms, bound "
          f"{k5_bound:.4f} ms ({k5_by}; {streamed} streamed keys, {pairs} (pixel, key) pairs up "
          "to n_contrib)")
    print(f"  K6: {k6_ms:.4f} ms ({k6_call_ms:.4f} per call), plain {k6_plain_ms:.3f} ms, bound "
          f"{k6_bound:.4f} ms ({k6_by}; {atomics} atomic adds at most, {table.shape[0]} table "
          "rows)")
    slots = surfel_slot_counts(data, route, k5[6], tiles_x)
    for name, s in slots.items():
        walked = max(s["walked"], 1)
        print(f"  {name} (warp, key) slots: {s['walked']} walked, {s['mask']} left by the warp "
              f"mask, {s['pretest']} left to hit() by the pre-test, {s['live']} with a lane past "
              f"the exact tests; dead share {1 - s['live'] / walked:.4f}, skipped by the mask "
              f"{1 - s['mask'] / walked:.4f}, by the mask or the pre-test "
              f"{1 - s['pretest'] / walked:.4f}")
    return {
        "slots": slots,
        "step_ms": step_ms, "parts": parts, "ops": ops, "busy_ms": busy_ms if top else None,
        "peak_mib": peak / 2**20, "per_step": per_step,
        "k5": dict(ms=k5_ms, ms_per_call=k5_call_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound,
                   bound_by=k5_by, err=k5_err),
        "k6": dict(ms=k6_ms, ms_per_call=k6_call_ms, plain_ms=k6_plain_ms, bound_ms=k6_bound,
                   bound_by=k6_by, err=k6_err),
    }


SCORP_VIEWS = 10  # 8 train + 2 test orbiting views
REFINE_ITERS = 30  # post_refine_gs steps in the SCORP phase
ALIGN_ROUNDS = 4   # render-match-solve rounds of phase 12's align (the app's default: 6)


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel of the rasterizers (the fused preprocess, K1, the
    key sort, K2, K3, and the surfel compositors K4-K6) to its plain PyTorch
    version, on whatever device the tensors lie, so that a whole entry point
    can be held against itself through the kernels. The plain versions count
    no launches: the block fails if a kernel was launched inside it, as it
    would be if a module looked a wrapper up by another name than these."""
    import scorp_tpu_torch.pipeline.mask3d  # noqa: F401  (its projection votes preprocess)

    before = kernel_launches()
    mods = sys.modules
    raster = mods["scorp_tpu_torch.ops.raster"]
    ex = mods["scorp_tpu_torch.ops.raster.expand"]
    so = mods["scorp_tpu_torch.ops.raster.sort"]
    co = mods["scorp_tpu_torch.ops.raster.composite"]
    bw = mods["scorp_tpu_torch.ops.raster.backward"]
    sc = mods["scorp_tpu_torch.ops.raster.surfel_composite"]
    sb = mods["scorp_tpu_torch.ops.raster.surfel_backward"]
    m3 = mods["scorp_tpu_torch.pipeline.mask3d"]
    names = ("composite", "composite_backward", "surfel_composite", "surfel_composite_train",
             "surfel_backward", "preprocess_kernel")
    saved = tuple(getattr(raster, k) for k in names) + (ex.expand_keys, so.sort_keys,
                                                        m3.preprocess_kernel)
    raster.composite = co.composite_plain
    raster.composite_backward = bw.composite_backward_plain
    raster.surfel_composite = sc.surfel_composite_plain
    raster.surfel_composite_train = functools.partial(sc.surfel_composite_plain, train=True)
    raster.surfel_backward = sb.surfel_backward_plain
    raster.preprocess_kernel = m3.preprocess_kernel = raster.preprocess_plain
    ex.expand_keys = ex.expand_keys_plain
    so.sort_keys = lambda keys, end_bit: so.sort_keys_plain(keys)
    try:
        yield
    finally:
        for k, fn in zip(names, saved):
            setattr(raster, k, fn)
        ex.expand_keys, so.sort_keys, m3.preprocess_kernel = saved[-3:]
    check(kernel_launches() == before, "the plain versions' pass launched no kernel")


def _wrappers() -> dict:
    from scorp_tpu_torch.ops.raster.backward import composite_backward
    from scorp_tpu_torch.ops.raster.composite import composite
    from scorp_tpu_torch.ops.raster.expand import expand_keys
    from scorp_tpu_torch.ops.raster.fused_preprocess import preprocess_kernel
    from scorp_tpu_torch.ops.raster.sort import sort_keys
    from scorp_tpu_torch.ops.raster.surfel_backward import surfel_backward
    from scorp_tpu_torch.ops.raster.surfel_composite import (
        surfel_composite, surfel_composite_train,
    )

    return {"preprocess": preprocess_kernel, "expand": expand_keys, "sort": sort_keys,
            "composite": composite, "backward": composite_backward,
            "surfel_composite": surfel_composite,
            "surfel_composite_train": surfel_composite_train,
            "surfel_backward": surfel_backward}


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count (the fused preprocess, K1, the
    sort, K2-K6)."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def launches_of(**counts) -> dict:
    """kernel_launches()' form with these counts and 0 for every other
    kernel."""
    return {k: counts.get(k, 0) for k in _wrappers()}


def write_scorp_scene(args, device, scene_dir: str, model_dir: str):
    """The SCORP stages' inputs: write_scene's room scene with 10 orbiting
    views (8 train, 2 test) as the 'trained' model point_cloud/iteration_7000,
    the object (the cluster whose centre is nearest the origin) rendered
    alone by the port into per-view RGBA masks (alpha > 0.5) under
    masked_image_rgba/obj/, the scene images with the same alpha (the union
    of the objects' masks) under masked_image_rgba/masked/, and
    description.yml. Returns (the object's mask over the scene's Gaussians,
    the object's GaussianData)."""
    import yaml
    from PIL import Image

    from scorp_tpu_torch.core.camera import make_camera
    from scorp_tpu_torch.core.plyio import save_gaussian_ply
    from scorp_tpu_torch.render import render

    g, views, cluster_idx, centers = write_scene(scene_dir, None, args.n, args.width,
                                                 args.height, args.seed, device,
                                                 n_views=SCORP_VIEWS)
    save_gaussian_ply(os.path.join(model_dir, "point_cloud", "iteration_7000",
                                   "point_cloud.ply"), g)
    obj_mask = cluster_idx == int(np.argmin(np.linalg.norm(centers, axis=1)))
    g_obj = g.select(obj_mask)
    obj_dir = os.path.join(scene_dir, "masked_image_rgba", "obj")
    masked_dir = os.path.join(scene_dir, "masked_image_rgba", "masked")
    os.makedirs(obj_dir)
    os.makedirs(masked_dir)
    for name, r_c2w, t_w2c in views:
        cam = make_camera(r_c2w, t_w2c, FOVX, FOVY, args.width, args.height, device=device)
        out = render(cam, g_obj, np.zeros(3, np.float32))
        alpha = ((out["render_alpha"][0] > 0.5).cpu().numpy() * 255).astype(np.uint8)
        rgb = (out["render"].clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
        Image.fromarray(np.dstack([rgb.transpose(1, 2, 0), alpha])).save(
            os.path.join(obj_dir, name + ".png"))
        scene_rgb = np.asarray(Image.open(os.path.join(scene_dir, "images", name + ".png")))
        Image.fromarray(np.dstack([scene_rgb, alpha])).save(
            os.path.join(masked_dir, name + ".png"))
    with open(os.path.join(scene_dir, "description.yml"), "w") as f:
        yaml.safe_dump({"prompts": "obj", "img_num": 3}, f)
    return obj_mask, g_obj


def check_votes(state, cam, mask, bg, cfg, label: str, surfel: bool = False) -> dict:
    """One camera's raw vote vector of each voting method through the kernels
    against the plain versions on the card: max |diff| <= 1e-4 x max |vote|,
    equal signs wherever |vote| > 1e-4 x max |vote|."""
    import torch

    from scorp_tpu_torch.pipeline.mask3d import camera_votes

    errs = {}
    for method in ("gradient", "binary", "projection"):
        got = camera_votes(state, cam, mask, bg, method, cfg, surfel)
        with plain_kernels():
            ref = camera_votes(state, cam, mask, bg, method, cfg, surfel)
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        clear = ref.abs() > 1e-4 * scale
        same_sign = torch.equal(torch.sign(got[clear]), torch.sign(ref[clear]))
        check(bool(got.isfinite().all()) and scale > 0, f"{label} {method} votes finite, "
              f"not all zero (max |vote| {scale:.4g})")
        check(err <= 1e-4 * scale, f"{label} {method} votes: max |diff| {err:.3g} <= 1e-4 x "
              f"{scale:.4g}")
        check(same_sign, f"{label} {method} votes: equal signs on the {int(clear.sum())} votes "
              "clear of 0")
        errs[method] = err
    return errs


def check_sift_card_vs_cpu(image1, image2, device) -> dict:
    """The port's SIFT (pipeline/sift.py) on one crop pair of the alignment
    (the masked object crop and the proxy render) on the card against the
    CPU: keypoint counts within 1%, >= 99% of the CPU's keypoints on the
    card within 1e-3 px (same octave word, angle within 0.01 deg) with
    every descriptor entry within +-1, >= 95% of the CPU's cross-checked
    pairs on the card (both ends within 1e-3 px); the card's ms per pair
    (CUDA events, median of 5), device busy time, ATen ops, host syncs and
    peak memory."""
    import torch
    from scipy.spatial import cKDTree

    from scorp_tpu_torch.pipeline import sift

    grays = [sift.to_gray(image1), sift.to_gray(image2)]
    shapes = [g.shape for g in grays]
    kps = {}
    for dev in (device, torch.device("cpu")):
        kps[dev.type] = [sift.detect_and_compute(torch.as_tensor(g, device=dev))
                         for g in grays]
    out = {"shapes": [list(s) for s in shapes], "keypoints": {}, "paired": [],
           "desc_within_1": []}
    for i in range(2):
        card = {k: v.cpu().numpy() for k, v in kps[device.type][i].items()}
        cpu = {k: v.numpy() for k, v in kps["cpu"][i].items()}
        n_card, n_cpu = len(card["size"]), len(cpu["size"])
        out["keypoints"][f"image{i}"] = [n_card, n_cpu]
        check(abs(n_card - n_cpu) <= 0.01 * n_cpu,
              f"SIFT image {i} ({shapes[i][1]}x{shapes[i][0]}): {n_card} keypoints on the "
              f"card, {n_cpu} on the CPU (within 1%)")
        tree = cKDTree(card["pt"])
        paired = within = 0
        used = set()
        for j in range(n_cpu):
            for k in tree.query_ball_point(cpu["pt"][j], 1e-3):
                da = abs(float(card["angle"][k]) - float(cpu["angle"][j]))
                if (k not in used and card["octave"][k] == cpu["octave"][j]
                        and min(da, 360 - da) <= 0.01):
                    used.add(k)
                    paired += 1
                    within += int(np.abs(card["desc"][k] - cpu["desc"][j]).max() <= 1)
                    break
        out["paired"].append(paired / max(n_cpu, 1))
        out["desc_within_1"].append(within / max(n_cpu, 1))
        check(within >= 0.99 * n_cpu,
              f"SIFT image {i}: {paired} of the CPU's {n_cpu} keypoints on the card within "
              f"1e-3 px, {within} of them with every descriptor entry within +-1 (>= 99%)")
    pairs = {}
    for dev, k in kps.items():
        q, t, _ = sift.cross_check_match(k[0]["desc"], k[1]["desc"])
        pairs[dev] = np.concatenate([k[0]["pt"][q].cpu().numpy(), k[1]["pt"][t].cpu().numpy()],
                                    1)
    tree = cKDTree(pairs[device.type])
    shared = sum(any(np.abs(pairs[device.type][k] - p).max() <= 1e-3
                     for k in tree.query_ball_point(p, 2e-3)) for p in pairs["cpu"])
    out["pairs"] = [len(pairs[device.type]), len(pairs["cpu"]), shared]
    check(shared >= 0.95 * len(pairs["cpu"]) and len(pairs["cpu"]) > 0,
          f"SIFT pairs: {shared} of the CPU's {len(pairs['cpu'])} cross-checked pairs on the "
          f"card (>= 95%; the card has {len(pairs[device.type])})")
    g0, g1 = (torch.as_tensor(g, device=device) for g in grays)
    out["ms_per_pair"] = cuda_ms(lambda: sift.match_sift(g0, g1), 5)
    out["host_syncs"] = counted_syncs(lambda: sift.match_sift(g0, g1))[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sift.match_sift(g0, g1)
    torch.cuda.synchronize()
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out["busy_ms"], top = device_profile(lambda: sift.match_sift(g0, g1), 3)
    out["ops"] = dispatched_ops(lambda: sift.match_sift(g0, g1))
    print(f"  SIFT of a crop pair ({shapes[0][1]}x{shapes[0][0]}, {shapes[1][1]}x{shapes[1][0]}):"
          f" {out['ms_per_pair']:.3f} ms per pair on the card (CUDA events, median of 5), "
          f"device busy {out['busy_ms']:.3f} ms, {out['ops']} ATen ops, {out['host_syncs']} "
          f"host syncs, peak {out['peak_mib']:.1f} MiB above the {base / 2**20:.1f} MiB held "
          "before")
    for name, ms in top[:5]:
        print(f"    {ms:8.3f} ms  {name}")
    return out


@contextlib.contextmanager
def counting_align_rounds(align_app, features, match_owner, match_name: str, ref_xyz):
    """Within the block, count each render-and-match round of `align_app`'s
    `align`: the feature module's keypoints, the cross-checked matches of
    `match_owner.<match_name>`, the pairs the matcher keeps, the pairs lifted
    to 3D, the solver calls and seconds. Yields (rounds, current,
    crop_pairs): round -> its counts; the matcher's class name and the
    coarse init's centroid error against `ref_xyz`; (pixels, image1,
    image2) of every matcher call."""
    import torch

    rounds, current, crop_pairs = {}, {}, []
    names = ("get_matcher", "get_pcd_pair", "pc_align_ransac", "adam_algorithm_3d3d_9dof")
    real = {name: getattr(align_app, name) for name in names}
    real_detect, real_match = features.detect_and_compute, getattr(match_owner, match_name)

    def round_log():
        return rounds.setdefault(current["round"], {
            "match_calls": 0, "keypoints": 0, "matches": 0, "kept": 0, "lifted": 0,
            "ransac": 0, "adam": 0, "solver_s": 0.0})

    def counting_detect(*a, **kw):
        kp = real_detect(*a, **kw)
        round_log()["keypoints"] += len(kp["size"])
        return kp

    def counting_match(*a, **kw):
        out = real_match(*a, **kw)
        log = round_log()
        log["match_calls"] += 1
        log["matches"] += len(out[0])
        return out

    def recording_matcher(*a, **kw):
        matcher = real["get_matcher"](*a, **kw)
        current["matcher"] = type(matcher).__name__

        def call(image1, image2, **k2):
            uv0, uv1 = matcher(image1, image2, **k2)
            round_log()["kept"] += len(uv0)
            crop_pairs.append((image1.size[0] * image1.size[1]
                               + image2.size[0] * image2.size[1], image1, image2))
            return uv0, uv1
        return call

    def recording_pcd_pair(gaussians, *a, **kw):
        current["round"] = kw["iteration"]
        round_log()
        if "coarse_err" not in current:
            current["coarse_err"] = float(np.linalg.norm(gaussians.xyz.mean(0)
                                                         - ref_xyz.mean(0)))
        pcd_o, pcd_r = real["get_pcd_pair"](gaussians, *a, **kw)
        round_log()["lifted"] = len(pcd_o)
        return pcd_o, pcd_r

    def timed_solver(name, fn):
        def solve(*a, **kw):
            log = round_log()
            log[name] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            log["solver_s"] += time.perf_counter() - t
            return out
        return solve

    patched = {"get_matcher": recording_matcher, "get_pcd_pair": recording_pcd_pair,
               "pc_align_ransac": timed_solver("ransac", real["pc_align_ransac"]),
               "adam_algorithm_3d3d_9dof": timed_solver("adam",
                                                        real["adam_algorithm_3d3d_9dof"])}
    for name in names:
        setattr(align_app, name, patched[name])
    features.detect_and_compute = counting_detect
    setattr(match_owner, match_name, counting_match)
    try:
        yield rounds, current, crop_pairs
    finally:
        for name in names:
            setattr(align_app, name, real[name])
        features.detect_and_compute = real_detect
        setattr(match_owner, match_name, real_match)


def print_rounds(rounds: dict, label: str) -> None:
    for it, log in sorted(rounds.items()):
        print(f"    round {it}: {log['match_calls']} {label} calls, {log['keypoints']} "
              f"keypoints, {log['matches']} cross-checked matches, {log['kept']} after the "
              f"border filter and subsample, {log['lifted']} lifted; RANSAC calls "
              f"{log['ransac']}, 9-DoF Adam calls {log['adam']}, solver {log['solver_s']:.3f} s")


def check_orb_card_vs_cpu(image1, image2, device) -> dict:
    """The port's ORB (pipeline/orb.py) on one crop pair of the alignment
    (the masked object crop and the proxy render) on the card against the
    CPU. Its arithmetic is integer up to the Harris score and the angle,
    whose float32 steps are the same on both, so the bar is equality: every
    keypoint field and descriptor, in order, and the cross-checked pairs;
    then the card's ms per pair (CUDA events, median of 5), device busy
    time, ATen ops, host syncs and peak memory."""
    import torch

    from scorp_tpu_torch.pipeline import orb, sift

    grays = [sift.to_gray(image1), sift.to_gray(image2)]
    shapes = [g.shape for g in grays]
    kps = {dev.type: [orb.detect_and_compute(torch.as_tensor(g, device=dev)) for g in grays]
           for dev in (device, torch.device("cpu"))}
    out = {"shapes": [list(s) for s in shapes], "keypoints": []}
    for i in range(2):
        card, cpu = kps[device.type][i], kps["cpu"][i]
        out["keypoints"].append(len(cpu["size"]))
        same = all(torch.equal(card[k].cpu(), cpu[k]) for k in cpu)
        check(same, f"ORB image {i} ({shapes[i][1]}x{shapes[i][0]}): the card's "
              f"{len(card['size'])} keypoints (pt, size, angle, response, octave) and "
              f"descriptors equal the CPU's {len(cpu['size'])}")
    pairs = {dev: [v.cpu() for v in orb.cross_check_match_hamming(k[0]["desc"], k[1]["desc"])]
             for dev, k in kps.items()}
    out["pairs"] = len(pairs["cpu"][0])
    check(out["pairs"] > 0 and all(torch.equal(a, b) for a, b in zip(pairs[device.type],
                                                                       pairs["cpu"])),
          f"ORB pairs: the card's {len(pairs[device.type][0])} cross-checked pairs (query, "
          f"train, distance) equal the CPU's {out['pairs']}")
    g0, g1 = (torch.as_tensor(g, device=device) for g in grays)
    out["ms_per_pair"] = cuda_ms(lambda: orb.match_orb(g0, g1), 5)
    out["host_syncs"] = counted_syncs(lambda: orb.match_orb(g0, g1))[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    orb.match_orb(g0, g1)
    torch.cuda.synchronize()
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out["busy_ms"], top = device_profile(lambda: orb.match_orb(g0, g1), 3)
    out["ops"] = dispatched_ops(lambda: orb.match_orb(g0, g1))
    print(f"  ORB of a crop pair ({shapes[0][1]}x{shapes[0][0]}, {shapes[1][1]}x{shapes[1][0]}):"
          f" {out['ms_per_pair']:.3f} ms per pair on the card (CUDA events, median of 5), "
          f"device busy {out['busy_ms']:.3f} ms, {out['ops']} ATen ops, {out['host_syncs']} "
          f"host syncs, peak {out['peak_mib']:.1f} MiB above the {base / 2**20:.1f} MiB held "
          "before")
    for name, ms in top[:5]:
        print(f"    {ms:8.3f} ms  {name}")
    return out


def phase_scorp(args, device):
    """Phase 12: the SCORP object path at full width through its entry
    points: segmentation_3dgs -> view_selection -> align (coarse init, then
    render-and-match rounds with SIFT correspondences on the card) ->
    post_refine_gs -> render_3dgs, with launch counters per stage; the vote
    and a 3.375x alignment render held against the plain versions; RANSAC
    and the 9-DoF Adam on a known similarity; refine_step's time."""
    import torch
    from PIL import Image

    from scorp_tpu_torch.apps import align_3dgs_clpe_9dof as align_app
    from scorp_tpu_torch.apps import post_refine_gs, render_3dgs, segmentation_3dgs
    from scorp_tpu_torch.apps import view_selection
    from scorp_tpu_torch.config import ModelParams
    from scorp_tpu_torch.core.plyio import GaussianData, load_gaussian_ply, save_gaussian_ply
    from scorp_tpu_torch.pipeline import matching, sift, solvers
    from scorp_tpu_torch.pipeline.gs_transform import (
        gaussians_rotate, gaussians_scale, gaussians_translate,
    )
    from scorp_tpu_torch.pipeline.mask3d import (
        camera_votes, load_mask_rgba, projection_vote_step,
    )
    from scorp_tpu_torch.render import default_raster_config, regrow_config, render
    from scorp_tpu_torch.scene import Scene
    from scorp_tpu_torch.train import (
        OptParams, from_gaussian_data, init_adam, refine_step,
    )

    t_phase = time.perf_counter()
    scene_dir = os.path.join(WORK, "scorp_scene")
    model_dir = os.path.join(WORK, "scorp_model")
    t0 = time.perf_counter()
    obj_mask, g_obj = write_scorp_scene(args, device, scene_dir, model_dir)
    print(f"  wrote the scene ({SCORP_VIEWS} views at {args.width}x{args.height}), the "
          f"model and the masks of a {int(obj_mask.sum())}-gaussian object in "
          f"{time.perf_counter() - t0:.2f} s")
    base = ["-s", scene_dir, "-m", model_dir, "--eval", "--split_yml_name", "split.yml"]
    dev_arg = ["--device", str(device)]
    launches = {}

    # 1. mask lifting
    reset_launches()
    t0 = time.perf_counter()
    masks = segmentation_3dgs.main(base + dev_arg)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    launches["segmentation"] = kernel_launches()
    sel = masks[0]
    inter, union = int((sel & obj_mask).sum()), int((sel | obj_mask).sum())
    print(f"  segmentation_3dgs: {seg_s:.3f} s, {int(sel.sum())} selected, {inter} of them in "
          f"the cluster (precision {inter / max(int(sel.sum()), 1):.4f}), IoU with the cluster "
          f"{inter / union:.4f}; launches {launches['segmentation']}")
    n_train = SCORP_VIEWS - 2
    check(launches["segmentation"] == launches_of(expand=n_train, sort=n_train,
                                                  composite=n_train, backward=n_train),
          f"one K1, sort, K2 and K3 per vote ({n_train} cameras x 1 prompt)")
    dataset = ModelParams(source_path=scene_dir, model_path=model_dir, eval=True,
                          split_yml_name="split.yml").finalize()
    scene = Scene(dataset, load_iteration=7000, shuffle=False)
    state = from_gaussian_data(scene.gaussians, device=device)
    host_cam = scene.get_train_cameras()[0]
    cam = host_cam.to_torch(device)
    mask = load_mask_rgba(os.path.join(scene_dir, "masked_image_rgba", "obj",
                                       host_cam.image_name + ".png"), host_cam.resolution)
    bg = torch.zeros(3, device=device)
    cfg = default_raster_config(state.capacity)
    # the whole lifting again, summed over the cameras as get_mask3d sums
    # it, through the kernels and through the plain versions
    sums = {}
    n_in = torch.zeros(state.capacity, device=device)
    for route in ("kernels", "plain"):
        sums[route] = torch.zeros(state.capacity, device=device)
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            for hc in scene.get_train_cameras():
                m = load_mask_rgba(os.path.join(scene_dir, "masked_image_rgba", "obj",
                                                hc.image_name + ".png"), hc.resolution)
                dcam = hc.to_torch(device)
                sums[route] += camera_votes(state, dcam, m, bg, "gradient", cfg)
                if route == "kernels":
                    n_in += projection_vote_step(state, dcam, torch.as_tensor(m, device=device)) > 0
    n = len(sel)
    v_k, v_p = sums["kernels"][:n], sums["plain"][:n]
    scale = float(v_p.abs().max())
    clear = (v_p.abs() > 1e-4 * scale).cpu().numpy()
    clear_k = (v_k.abs() > 1e-4 * scale).cpu().numpy()
    sel_k, sel_p = (v_k > 0).cpu().numpy(), (v_p > 0).cpu().numpy()
    seg_err = float((v_k - v_p).abs().max())
    check(seg_err <= 1e-4 * scale, f"summed gradient votes through the kernels against the "
          f"plain versions: max |diff| {seg_err:.3g} <= 1e-4 x {scale:.4g}")
    check(np.array_equal(sel_k[clear], sel_p[clear]),
          f"the selections through the kernels and the plain versions are equal on the "
          f"{int(clear.sum())} Gaussians whose summed vote is clear of 0 (|vote| > 1e-4 x max)")
    check(np.array_equal(sel[clear_k], sel_k[clear_k]),
          "segmentation_3dgs' selection is its summed votes > 0 wherever they are clear of 0")
    # the masks are the object's whole silhouette, occluders included, so
    # the lifting also selects what lies in front of the object: the bound
    # is the masks' own 3D region, not the cluster
    n_in = n_in[:n].cpu().numpy()
    half = n_in >= n_train / 2
    print("  train masks that hold the centre, selection: "
          f"{np.bincount(n_in[sel].astype(int), minlength=n_train + 1).tolist()}; cluster: "
          f"{np.bincount(n_in[obj_mask].astype(int), minlength=n_train + 1).tolist()}; all: "
          f"{np.bincount(n_in.astype(int), minlength=n_train + 1).tolist()}")
    check(sel.sum() > 0 and inter >= 0.5 * obj_mask.sum(),
          f"the selection is non-empty and holds at least half of the cluster "
          f"({inter} of {int(obj_mask.sum())})")
    check(int((sel & half).sum()) >= 0.5 * sel.sum(),
          f"at least half of the selection ({int((sel & half).sum())} of {int(sel.sum())}) "
          f"projects into at least {n_train // 2} of the {n_train} masks (of all Gaussians "
          f"{int(half.sum())} of {n})")
    vote_errs = check_votes(state, cam, mask, bg, cfg, "camera 0")
    vote_ms = cuda_ms(lambda: camera_votes(state, cam, mask, bg, "gradient", cfg), 5)
    print(f"  gradient vote: {vote_ms:.3f} ms per camera (CUDA events, median of 5)")
    del state
    torch.cuda.empty_cache()

    # 2. view selection
    reset_launches()
    t0 = time.perf_counter()
    view_selection.main(base + dev_arg)
    view_s = time.perf_counter() - t0
    crops = sorted(os.listdir(os.path.join(model_dir, "masked_image_rgba_selected", "obj")))
    print(f"  view_selection: {view_s:.3f} s, crops {crops}")
    check(1 <= len(crops) <= 3, f"{len(crops)} crops written")
    check(kernel_launches() == launches_of(), "view selection launches no kernel")

    # 3. the scene object and its generated proxy. The masks' crops show the
    #    object (the cluster) alone, while the segmentation also selects the
    #    Gaussians in front of it (precision ~0.2, above), whose depths would
    #    lift the object's matches onto them and whose colours the crops do
    #    not show. So the alignment's scene object (gs_seg/obj.ply) is the
    #    cluster, and the proxy, TRELLIS's stand-in, is the cluster at SH 0,
    #    scaled 0.6, rotated 0.5 rad about z and translated
    #    (tests/test_scorp_pipeline.py): the true alignment is scale 1/0.6
    #    and -0.5 rad about z
    seg = g_obj
    save_gaussian_ply(os.path.join(model_dir, "gs_seg", "obj.ply"), seg)
    proxy = GaussianData(xyz=seg.xyz.copy(), f_dc=seg.f_dc.copy(),
                         f_rest=np.zeros((seg.n, 0, 3), np.float32),
                         opacity=seg.opacity.copy(), scaling=seg.scaling.copy(),
                         rotation=seg.rotation.copy())
    rz = np.array([[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5), 0], [0, 0, 1.0]])
    gaussians_scale(proxy, 0.6)
    gaussians_rotate(proxy, rz)
    gaussians_translate(proxy, np.array([0.8, -0.5, 0.4]))
    save_gaussian_ply(os.path.join(model_dir, "generated", "obj.ply"), proxy)

    # 4. alignment with the app's default matcher ("auto": SIFT on the card,
    #    the MASt3R checkpoint being absent): each round renders the proxy
    #    per camera (upscaling while it covers too few pixels), matches it
    #    against the masked object crop, lifts the pairs through both depths
    #    and solves (RANSAC, the 9-DoF Adam in the last round)
    renders = [0]
    icp = {}
    real_render, real_icp = align_app.render, align_app.best_icp_transform

    def counting_render(*a, **kw):
        renders[0] += 1
        return real_render(*a, **kw)

    def timed_icp(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        T, icp["syncs"] = counted_syncs(lambda: real_icp(*a, **kw))
        icp["seconds"] = time.perf_counter() - t
        return T

    align_app.render, align_app.best_icp_transform = counting_render, timed_icp
    reset_launches()
    t0 = time.perf_counter()
    try:
        with counting_align_rounds(align_app, sift, matching, "match_sift",
                                   seg.xyz) as (rounds, current, crop_pairs):
            align_app.align(dataset, None, "obj", num_iterations=ALIGN_ROUNDS,
                            opt_12dof_iterations=(ALIGN_ROUNDS - 1,),
                            rotations_path=os.path.join(WORK, "rotation_matrices"),
                            device=device)
    finally:
        align_app.render, align_app.best_icp_transform = real_render, real_icp
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    launches["align"] = kernel_launches()
    print(f"  align ({current['matcher']}, {ALIGN_ROUNDS} rounds, the 9-DoF Adam in round "
          f"{ALIGN_ROUNDS - 1}): {align_s:.3f} s, {renders[0]} renders; ICP "
          f"{icp['seconds']:.3f} s with {icp['syncs']} host syncs; launches {launches['align']}")
    print_rounds(rounds, "SIFT")
    check(current["matcher"] == "SIFTMatcher", "align's default matcher is the port's SIFT")
    check(launches["align"] == launches_of(preprocess=renders[0], expand=renders[0],
                                           sort=renders[0], composite=renders[0]),
          f"one fused preprocess, K1, sort and K2 per alignment render ({renders[0]})")
    solved = [it for it, log in sorted(rounds.items())
              if log["lifted"] >= 3 and log["ransac"] + log["adam"] > 0]
    check(len(solved) >= 1, f"rounds {solved} lifted >= 3 SIFT correspondences into "
          "pc_align_ransac or the 9-DoF Adam")
    extent = float(seg.xyz.std())

    def recovered(name):
        # the transform the rounds applied so far: the least-squares affine
        # map from the proxy as written to the aligned proxy, split into
        # rotation x scale (the true one: 1/0.6 and -0.5 rad about z)
        g = load_gaussian_ply(os.path.join(model_dir, "generated_aligned", name))
        src = np.concatenate([proxy.xyz, np.ones((proxy.n, 1))], 1).astype(np.float64)
        affine = np.linalg.lstsq(src, g.xyz.astype(np.float64), rcond=None)[0][:3].T
        u, sv, vt = np.linalg.svd(affine)
        return (g, float(np.linalg.norm(g.xyz.mean(0) - seg.xyz.mean(0))),
                float(np.cbrt(np.prod(sv))), sv,
                float(np.arccos(np.clip((np.trace(u @ vt @ rz) - 1) / 2, -1, 1))))

    for it in sorted(rounds):
        _, e, sc, sv, re = recovered(f"obj_{it}.ply")
        rounds[it].update(centroid_err=e, scale=sc, rot_err=re)
        print(f"    after round {it}: centroid error {e:.4f}, scale {sc:.4f} (singular values "
              f"{np.round(sv, 4).tolist()}), rotation error {re:.4f} rad")
    aligned, c_err, rec_scale, sv, rot_err = recovered("obj.ply")
    print(f"  centroid error: coarse init {current['coarse_err']:.4f}, after the rounds "
          f"{c_err:.4f} (object xyz std {extent:.4f}); recovered scale {rec_scale:.4f} "
          f"(singular values {np.round(sv, 4).tolist()}) against the true {1 / 0.6:.4f}; "
          f"rotation error {rot_err:.4f} rad against the true 0.5 rad about z")
    check(c_err < 0.35 * extent, f"the aligned proxy's centroid is within 0.35 x the "
          f"object's xyz std ({c_err:.4f} < 0.35 x {extent:.4f})")
    sift_card = check_sift_card_vs_cpu(*max(crop_pairs, key=lambda p: p[0])[1:], device)

    # the largest alignment render: 3.375x the camera's resolution
    big_cam = Scene(dataset, shuffle=False, load_gaussians=False).get_train_cameras()[0]
    for _ in range(3):
        big_cam.scale_resolution(1.5)
    bw, bh = big_cam.resolution
    dcam = big_cam.to_torch(device)
    bg_np = np.zeros(3, np.float32)
    tiles = -(-bw // 16) * -(-bh // 16)
    # at default_raster_config's key slots (which drop keys here), then
    # regrown once, as a training loop regrows, until none is dropped
    a_state = from_gaussian_data(aligned, device=device)
    big_cfg = default_raster_config(a_state.capacity)
    for _ in range(2):
        got = render(dcam, a_state, bg_np, cfg=big_cfg)
        with plain_kernels():
            ref = render(dcam, a_state, bg_np, cfg=big_cfg)
        dropped = int(got["num_dropped_keys"])
        print(f"  3.375x render: {bw}x{bh}, {tiles} tiles, {big_cfg.max_keys} key slots, dropped "
              f"keys {dropped} (plain {int(ref['num_dropped_keys'])})")
        for key in ("render", "render_alpha", "render_depth", "num_dropped_keys"):
            check(torch.equal(got[key], ref[key]),
                  f"3.375x render at {big_cfg.max_keys} key slots: {key} equal to the plain "
                  "versions'")
        check(float(got["render_alpha"].max()) > 0, "the proxy covers pixels at 3.375x")
        if not dropped:
            break
        big_cfg = regrow_config(big_cfg, dropped)
    check(dropped == 0, f"no key dropped at {big_cfg.max_keys} key slots")

    # RANSAC and the 9-DoF Adam on 128 correspondences of a known similarity
    rng = np.random.default_rng(args.seed)
    P = rng.normal(size=(128, 3))
    # the Adam's rotation regularizer has a NaN gradient at the identity
    # (arccos' at 1, in the JAX package too: ROADMAP section 3), so the
    # axis is one whose path from the Adam's initial rotation avoids it
    axis = np.array([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R_true = np.eye(3) + np.sin(0.5) * kx + (1 - np.cos(0.5)) * kx @ kx
    s_true, t_true = 1.2, np.array([0.3, -0.2, 0.15])
    Q = s_true * P @ R_true.T + t_true
    bad = rng.choice(128, 26, replace=False)
    Q[bad] += rng.normal(size=(26, 3)) * 5.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R, t, s = solvers.pc_align_ransac(P, Q, threshold=0.05, max_iterations=2000,
                                      device=device)
    ransac_ms = 1e3 * (time.perf_counter() - t0)
    good = np.setdiff1d(np.arange(128), bad)
    t0 = time.perf_counter()
    R9, t9, s9, _ = solvers.adam_algorithm_3d3d_9dof(P[good], Q[good], iterations=3000,
                                                     device=device)
    adam_ms = 1e3 * (time.perf_counter() - t0)
    print(f"  RANSAC (2000 hypotheses, 128 pairs, 26 outliers) {ransac_ms:.3f} ms; 9-DoF Adam "
          f"(3000 steps, the 102 inliers) {adam_ms:.3f} ms (wall, to the result on the host)")
    for name, (Re, te, se) in (("RANSAC", (R, t, s)), ("9-DoF Adam", (R9, t9, s9))):
        r_err = float(np.abs(Re - R_true).max())
        t_err = float(np.linalg.norm(te - t_true) / np.linalg.norm(t_true))
        s_err = float(np.abs(np.asarray(se) - s_true).max() / s_true)
        check(r_err <= 1e-3 and t_err <= 1e-3 and s_err <= 1e-3,
              f"{name} recovers R ({r_err:.3g} <= 1e-3), t ({t_err:.3g}) and s ({s_err:.3g}) "
              "<= 1e-3 relative")

    # 5. refinement
    reset_launches()
    t0 = time.perf_counter()
    refined, log = post_refine_gs.main(
        base + ["--sh_degree", "0", "--images", os.path.join("masked_image_rgba", "masked"),
                "--iterations", str(REFINE_ITERS), "--quiet"] + dev_arg)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    launches["refine"] = kernel_launches()
    losses = log["loss"]
    k = min(10, len(losses) // 2)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    print(f"  post_refine_gs: {refine_s:.3f} s for {len(losses)} iterations; loss mean of the "
          f"first {k} {first:.6f}, of the last {k} {last:.6f}; launches {launches['refine']}")
    n_it = REFINE_ITERS
    check(launches["refine"] == launches_of(expand=n_it, sort=n_it, composite=n_it,
                                            backward=n_it),
          f"one K1, sort, K2 and K3 per refine step ({n_it})")
    check(len(losses) == n_it and all(np.isfinite(losses)) and last < first,
          "every refine loss is finite and the loss falls")
    out_dir = os.path.join(model_dir, "refined_aligned")
    written = load_gaussian_ply(os.path.join(out_dir, f"refined_{n_it}.ply"))
    check(os.path.exists(os.path.join(out_dir, "obj.ply")),
          f"refined_aligned/obj.ply and refined_{n_it}.ply written")
    check(all(np.array_equal(getattr(written, k), getattr(aligned, k))
              for k in ("xyz", "rotation", "scaling", "opacity")),
          "xyz, rotation, scaling and opacity bit-unchanged by the refinement")
    check(not np.array_equal(written.f_dc, aligned.f_dc), "the colours moved")

    # 6. eval rendering of the refined object (and the segmented baseline)
    reset_launches()
    results = render_3dgs.main(base + ["--iter", str(n_it), "--sh_degree", "0"] + dev_arg)
    launches["render"] = kernel_launches()
    n_png = 0
    for out_dir, records in results.items():
        for r in records:
            with Image.open(os.path.join(out_dir, r["image"] + ".png")) as im:
                rgba = np.asarray(im)
            check(rgba.shape == (args.height, args.width, 4) and rgba[..., 3].any(),
                  f"{os.path.basename(out_dir)}/{r['image']}.png: RGBA, object visible")
            n_png += 1
    check(launches["render"]["preprocess"] == launches["render"]["expand"]
          == launches["render"]["composite"] == n_png,
          f"one fused preprocess, K1 and K2 per eval view ({n_png})")

    # refine_step alone at full width: time, device busy, host syncs
    r_state = from_gaussian_data(aligned, device=device)
    r_adam = init_adam(r_state)
    with Image.open(os.path.join(scene_dir, "masked_image_rgba", "masked",
                                 host_cam.image_name + ".png")) as im:
        rgba = np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0
    gt_img = torch.as_tensor(rgba[:3], device=device)
    gt_alpha = torch.as_tensor(rgba[3:4], device=device)
    r_cfg = default_raster_config(r_state.capacity)
    opt = OptParams(iterations=30_000)

    def step():
        return refine_step(r_state, r_adam, cam, gt_img, gt_alpha, 100, bg, opt=opt,
                           sh_degree=0, cfg=r_cfg)

    step_ms = cuda_ms(step, 10)
    busy, top = device_profile(step, 5)
    syncs = host_syncs(step)
    print(f"  refine_step ({r_state.capacity} capacity, {args.width}x{args.height}): "
          f"{step_ms:.3f} ms (median of 10), device busy {busy:.3f} ms, host syncs per step "
          f"{syncs}")
    for name, ms in top[:5]:
        print(f"    {ms:8.3f} ms  {name}")
    wall = time.perf_counter() - t_phase
    print(f"  phase wall {wall:.2f} s")
    totals = {k: sum(v[k] for v in launches.values())
              for k in ("preprocess", "expand", "sort", "composite", "backward")}
    return totals, {
        "launches_by_stage": launches, "vote_ms": vote_ms, "vote_err": vote_errs,
        "icp_s": icp["seconds"], "icp_syncs": icp["syncs"], "ransac_ms": ransac_ms,
        "align_s": align_s, "align_rounds": {str(k): v for k, v in sorted(rounds.items())},
        "align_centroid_err": [current["coarse_err"], c_err], "align_rot_err": rot_err,
        "align_scale": rec_scale, "sift": sift_card,
        "adam_ms": adam_ms, "refine_step_ms": step_ms, "refine_busy_ms": busy,
        "refine_syncs": syncs, "wall_s": wall, "seg_vote_err": seg_err,
        "big_render": [bw, bh, tiles, big_cfg.max_keys], "iou": inter / union,
        "precision": inter / max(int(sel.sum()), 1),
    }


ALIGN2D_ROUNDS = 3  # render-and-match rounds of the 2DGS alignment (the app's default: 6)


def mesh_ply_counts(path: str) -> tuple[int, int]:
    """(vertices, faces) from a mesh PLY's header."""
    with open(path, "rb") as f:
        head = f.read(4096).split(b"end_header")[0]
    return (int(head.split(b"element vertex ")[1].split()[0]),
            int(head.split(b"element face ")[1].split()[0]))


def phase_scorp2d(args, device):
    """Phase 13: the 2DGS object path and mesh extraction at full width
    through their entry points, on phase 12's scene and masks with its
    Gaussians as surfels (iteration 25000): segmentation_2dgs (the surfel
    vote) -> view_selection -> trellis_img2gs --proxy_dir -> truncate_opacity
    -> align_2dgs_clpe_9dof.align -> extract_mesh, with launch counters per
    stage; the summed votes and camera 0's votes held against the plain
    versions, and the card's TSDF grid against tsdf_fuse on the CPU from
    the same depth and colour maps."""
    import torch

    from scorp_tpu_torch.apps import align_2dgs_clpe_9dof as align2d_app
    from scorp_tpu_torch.apps import align_3dgs_clpe_9dof as align_app
    from scorp_tpu_torch.apps import extract_mesh, segmentation_2dgs, trellis_img2gs
    from scorp_tpu_torch.apps import truncate_opacity, view_selection
    from scorp_tpu_torch.config import ModelParams
    from scorp_tpu_torch.core.plyio import GaussianData, load_gaussian_ply, save_gaussian_ply
    from scorp_tpu_torch.pipeline import marching_cubes, matching, mesh, orb
    from scorp_tpu_torch.pipeline.gs_transform import (
        gaussians_rotate, gaussians_scale, gaussians_translate,
    )
    from scorp_tpu_torch.pipeline.mask3d import camera_votes, load_mask_rgba
    from scorp_tpu_torch.render import default_raster_config
    from scorp_tpu_torch.scene import Scene
    from scorp_tpu_torch.train import from_gaussian_data

    t_phase = time.perf_counter()
    scene_dir = os.path.join(WORK, "scorp_scene")  # phase 12's scene and RGBA masks
    model_dir = os.path.join(WORK, "scorp2d_model")
    g3 = load_gaussian_ply(os.path.join(WORK, "scorp_model", "point_cloud", "iteration_7000",
                                        "point_cloud.ply"))
    g = GaussianData(xyz=g3.xyz, f_dc=g3.f_dc, f_rest=g3.f_rest, opacity=g3.opacity,
                     scaling=np.ascontiguousarray(g3.scaling[:, :2]), rotation=g3.rotation)
    save_gaussian_ply(os.path.join(model_dir, "point_cloud", "iteration_25000",
                                   "point_cloud.ply"), g)
    cluster_idx, centers = bench_scene_draw(args.n, args.seed)[5:]
    obj_mask = cluster_idx == int(np.argmin(np.linalg.norm(centers, axis=1)))
    base = ["-s", scene_dir, "-m", model_dir, "--eval", "--split_yml_name", "split.yml"]
    dev_arg = ["--device", str(device)]
    n_train = SCORP_VIEWS - 2
    launches = {}

    # 1. mask lifting through the surfel vote
    reset_launches()
    t0 = time.perf_counter()
    masks = segmentation_2dgs.main(base + dev_arg)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    launches["segmentation"] = kernel_launches()
    sel = masks[0]
    inter = int((sel & obj_mask).sum())
    recall, precision = inter / int(obj_mask.sum()), inter / max(int(sel.sum()), 1)
    print(f"  segmentation_2dgs: {seg_s:.3f} s, {int(sel.sum())} selected, {inter} of them in "
          f"the cluster of {int(obj_mask.sum())} (recall {recall:.4f}, precision "
          f"{precision:.4f}); launches {launches['segmentation']}")
    check(launches["segmentation"] == launches_of(
        expand=n_train, sort=n_train, surfel_composite_train=n_train, surfel_backward=n_train),
        f"one K1, sort, K5 and K6 per surfel vote ({n_train} cameras x 1 prompt)")
    dataset = ModelParams(source_path=scene_dir, model_path=model_dir, eval=True,
                          split_yml_name="split.yml").finalize()
    scene = Scene(dataset, load_iteration=25000, shuffle=False)
    state = from_gaussian_data(scene.gaussians, device=device)
    check(tuple(state.params["scaling"].shape) == (state.capacity, 2),
          f"the surfel PLY loads with 2 scale columns ({state.capacity} rows)")
    bg = torch.zeros(3, device=device)
    cfg = default_raster_config(state.capacity)
    sums = {}
    for route in ("kernels", "plain"):
        sums[route] = torch.zeros(state.capacity, device=device)
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            for hc in scene.get_train_cameras():
                m = load_mask_rgba(os.path.join(scene_dir, "masked_image_rgba", "obj",
                                                hc.image_name + ".png"), hc.resolution)
                sums[route] += camera_votes(state, hc.to_torch(device), m, bg, "gradient", cfg,
                                            surfel=True)
    n = len(sel)
    v_k, v_p = sums["kernels"][:n], sums["plain"][:n]
    scale = float(v_p.abs().max())
    clear = (v_p.abs() > 1e-4 * scale).cpu().numpy()
    clear_k = (v_k.abs() > 1e-4 * scale).cpu().numpy()
    sel_k, sel_p = (v_k > 0).cpu().numpy(), (v_p > 0).cpu().numpy()
    seg_err = float((v_k - v_p).abs().max())
    check(seg_err <= 1e-4 * scale, f"summed surfel votes through the kernels against the "
          f"plain versions: max |diff| {seg_err:.3g} <= 1e-4 x {scale:.4g}")
    check(np.array_equal(sel_k[clear], sel_p[clear]),
          f"the selections through the kernels and the plain versions are equal on the "
          f"{int(clear.sum())} surfels whose summed vote is clear of 0")
    check(np.array_equal(sel[clear_k], sel_k[clear_k]),
          "segmentation_2dgs' selection is its summed votes > 0 wherever they are clear of 0")
    host_cam = scene.get_train_cameras()[0]
    cam = host_cam.to_torch(device)
    mask = load_mask_rgba(os.path.join(scene_dir, "masked_image_rgba", "obj",
                                       host_cam.image_name + ".png"), host_cam.resolution)
    vote_errs = check_votes(state, cam, mask, bg, cfg, "camera 0 (surfels)", surfel=True)
    vote_ms = cuda_ms(lambda: camera_votes(state, cam, mask, bg, "gradient", cfg, True), 5)
    print(f"  surfel vote: {vote_ms:.3f} ms per camera (CUDA events, median of 5)")
    del state
    torch.cuda.empty_cache()

    # 2. view selection
    reset_launches()
    view_selection.main(base + dev_arg)
    crops = sorted(os.listdir(os.path.join(model_dir, "masked_image_rgba_selected", "obj")))
    check(1 <= len(crops) <= 3 and kernel_launches() == launches_of(),
          f"view selection wrote {len(crops)} crops and launched no kernel")

    # 3. the scene object and the proxy stages. As in phase 12, the crops
    #    show the object (the cluster) alone while the segmentation also
    #    selects the surfels in front of it (its precision, above, ~0.2):
    #    with its selection as scene object and proxy the ORB rounds
    #    diverged in a CPU rehearsal (the centroid error grew past the
    #    check's limit). So the alignment's scene object (gs_seg/obj.ply) is
    #    the cluster's surfels, and the proxy is the cluster as a 3DGS SH-0
    #    proxy (its second scale repeated as the third, as TRELLIS writes
    #    3DGS), scaled 0.6, rotated 0.5 rad about z, translated; copied by
    #    trellis_img2gs --proxy_dir, then truncated at opacity 0.1
    seg = GaussianData(xyz=g.xyz[obj_mask], f_dc=g.f_dc[obj_mask], f_rest=g.f_rest[obj_mask],
                       opacity=g.opacity[obj_mask], scaling=g.scaling[obj_mask],
                       rotation=g.rotation[obj_mask])
    save_gaussian_ply(os.path.join(model_dir, "gs_seg", "obj.ply"), seg)
    proxy = GaussianData(xyz=seg.xyz.copy(), f_dc=seg.f_dc.copy(),
                         f_rest=np.zeros((seg.n, 0, 3), np.float32), opacity=seg.opacity.copy(),
                         scaling=np.concatenate([seg.scaling, seg.scaling[:, 1:]], 1),
                         rotation=seg.rotation.copy())
    rz = np.array([[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5), 0], [0, 0, 1.0]])
    gaussians_scale(proxy, 0.6)
    gaussians_rotate(proxy, rz)
    gaussians_translate(proxy, np.array([0.8, -0.5, 0.4]))
    proxy_path = os.path.join(WORK, "proxies", "obj.ply")
    save_gaussian_ply(proxy_path, proxy)
    with open(proxy_path, "rb") as f:
        proxy_bytes = f.read()
    reset_launches()
    trellis_img2gs.main(["-m", model_dir, "--proxy_dir", os.path.dirname(proxy_path)] + dev_arg)
    gen = os.path.join(model_dir, "generated", "obj.ply")
    with open(gen, "rb") as f:
        check(f.read() == proxy_bytes, "trellis_img2gs --proxy_dir copied the proxy")
    kept = truncate_opacity.main(["-m", model_dir] + dev_arg)
    with open(gen + ".bak", "rb") as f:
        check(f.read() == proxy_bytes, "truncate_opacity kept the proxy as generated/obj.ply.bak")
    want = int((1.0 / (1.0 + np.exp(-proxy.opacity[:, 0])) >= 0.1).sum())
    check(kept == {gen: want} and load_gaussian_ply(gen).n == want < proxy.n,
          f"truncate_opacity kept the {want} of {proxy.n} proxy Gaussians at opacity >= 0.1")
    check(kernel_launches() == launches_of(), "the proxy stages launch no kernel")
    print(f"  proxy: {proxy.n} Gaussians, {want} kept at opacity >= 0.1, .bak written")

    # 4. alignment with ORB on the card: each round renders the proxy per
    #    train view through render (K1, K2), matches it against the masked
    #    object crop (whose depth came from render2d: K1, K4) by ORB, lifts
    #    the pairs through both depths and solves by RANSAC
    renders = {"scene": 0, "proxy": 0}
    real_scene_render, real_render = align2d_app._scene_render_2d, align_app.render

    def counting_scene_render(*a, **kw):
        renders["scene"] += 1
        return real_scene_render(*a, **kw)

    def counting_render(*a, **kw):
        renders["proxy"] += 1
        return real_render(*a, **kw)

    align2d_app._scene_render_2d, align_app.render = counting_scene_render, counting_render
    reset_launches()
    t0 = time.perf_counter()
    try:
        with counting_align_rounds(align_app, orb, matching, "match_orb",
                                   seg.xyz) as (rounds, current, crop_pairs):
            align2d_app.align(dataset, None, "obj", num_iterations=ALIGN2D_ROUNDS,
                              opt_12dof_iterations=(3, 4),
                              rotations_path=os.path.join(WORK, "rotation_matrices"),
                              matcher_backend="orb", device=device)
    finally:
        align2d_app._scene_render_2d, align_app.render = real_scene_render, real_render
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    launches["align"] = kernel_launches()
    ns, npx = renders["scene"], renders["proxy"]
    print(f"  align_2dgs ({current['matcher']}, {ALIGN2D_ROUNDS} rounds): {align_s:.3f} s, "
          f"{ns} scene-object renders (render2d), {npx} proxy renders (render); launches "
          f"{launches['align']}")
    print_rounds(rounds, "ORB")
    check(current["matcher"] == "ORBMatcher", "align_2dgs' matcher is the port's ORB")
    n_seen = sum(bool(load_mask_rgba(os.path.join(scene_dir, "masked_image_rgba", "obj",
                                                  hc.image_name + ".png")).any())
                 for hc in scene.get_train_cameras())
    check(ns == n_seen and npx > 0 and launches["align"] == launches_of(
        preprocess=npx, expand=ns + npx, sort=ns + npx, surfel_composite=ns, composite=npx),
        f"one K1, sort and K4 per scene-object render (one per train view that sees the "
        f"object: {n_seen}), one fused preprocess, K1, sort and K2 per proxy render ({npx})")
    solved = [it for it, log in sorted(rounds.items())
              if log["lifted"] >= 3 and log["ransac"] + log["adam"] > 0]
    check(len(solved) >= 1, f"rounds {solved} lifted >= 3 ORB correspondences into "
          "pc_align_ransac or the 9-DoF Adam")
    extent = float(seg.xyz.std())
    # the transform the rounds applied so far: the least-squares affine map
    # from the truncated proxy as written to the aligned one, split into
    # rotation x scale (the true one: 1/0.6 and -0.5 rad about z)
    src = proxy.xyz[1.0 / (1.0 + np.exp(-proxy.opacity[:, 0])) >= 0.1]
    src = np.concatenate([src, np.ones((len(src), 1))], 1).astype(np.float64)
    for it in sorted(rounds):
        g_it = load_gaussian_ply(os.path.join(model_dir, "generated_aligned", f"obj_{it}.ply"))
        affine = np.linalg.lstsq(src, g_it.xyz.astype(np.float64), rcond=None)[0][:3].T
        u, sv, vt = np.linalg.svd(affine)
        rounds[it].update(
            centroid_err=float(np.linalg.norm(g_it.xyz.mean(0) - seg.xyz.mean(0))),
            scale=float(np.cbrt(np.prod(sv))),
            rot_err=float(np.arccos(np.clip((np.trace(u @ vt @ rz) - 1) / 2, -1, 1))))
        print(f"    after round {it}: centroid error {rounds[it]['centroid_err']:.4f}, scale "
              f"{rounds[it]['scale']:.4f} (true {1 / 0.6:.4f}), rotation error "
              f"{rounds[it]['rot_err']:.4f} rad")
    aligned = load_gaussian_ply(os.path.join(model_dir, "generated_aligned", "obj.ply"))
    c_err = float(np.linalg.norm(aligned.xyz.mean(0) - seg.xyz.mean(0)))
    print(f"  centroid error: coarse init {current['coarse_err']:.4f}, after the rounds "
          f"{c_err:.4f} (object xyz std {extent:.4f})")
    check(c_err < 0.35 * extent, f"the aligned proxy's centroid is within 0.35 x the "
          f"object's xyz std ({c_err:.4f} < 0.35 x {extent:.4f})")
    orb_card = check_orb_card_vs_cpu(*max(crop_pairs, key=lambda p: p[0])[1:], device)

    # 5. mesh extraction at extract_mesh's defaults (bounded, mesh_res 256)
    times = {"render_s": 0.0}
    grid = {}
    real_fuse, real_mc = mesh.tsdf_fuse, marching_cubes.marching_cubes
    real_post = extract_mesh.post_process_mesh

    def checked_fuse(render_fn, cameras, *a, **kw):
        maps = {}

        def recording(cam):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pkg = render_fn(cam)
            torch.cuda.synchronize()
            times["render_s"] += time.perf_counter() - t
            maps[cam.image_name] = {"render_depth": pkg["render_depth"], "render": pkg["render"]}
            return pkg

        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_fuse(recording, cameras, *a, **kw)
        times["fuse_s"] = time.perf_counter() - t
        # the same fusion on the CPU from the card's depth and colour maps
        t = time.perf_counter()
        ref = real_fuse(lambda cam: {k: v.cpu() for k, v in maps[cam.image_name].items()},
                        cameras, *a, **{**kw, "device": "cpu"})
        times["fuse_cpu_s"] = time.perf_counter() - t
        grid.update(res=out[0].shape[0], observed=float((out[1] > 0).mean()),
                    weights_equal=bool(np.array_equal(out[1], ref[1])),
                    tsdf_err=float(np.abs(out[0] - ref[0]).max()),
                    color_err=float(np.abs(out[2] - ref[2]).max()))
        return out

    def timed_stage(fn, key):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            times[key] = time.perf_counter() - t
            return out
        return wrapped

    mesh.tsdf_fuse = checked_fuse
    marching_cubes.marching_cubes = timed_stage(real_mc, "marching_cubes_s")
    extract_mesh.post_process_mesh = timed_stage(real_post, "post_process_s")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out_dir = extract_mesh.main(base + dev_arg)
    finally:
        mesh.tsdf_fuse, marching_cubes.marching_cubes = real_fuse, real_mc
        extract_mesh.post_process_mesh = real_post
    mesh_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches["mesh"] = kernel_launches()
    check(launches["mesh"] == launches_of(expand=n_train, sort=n_train,
                                          surfel_composite=n_train),
          f"one K1, sort and K4 per training view ({n_train})")
    check(grid["res"] == 256, f"a 256^3 grid ({grid['res'] ** 3} voxels)")
    check(grid["weights_equal"], "the card's TSDF weights equal the CPU fusion's")
    check(grid["tsdf_err"] <= 1e-5 and grid["color_err"] <= 1e-5,
          f"the card's tsdf and colours within 1e-5 of the CPU fusion's (max |diff| "
          f"{grid['tsdf_err']:.3g}, {grid['color_err']:.3g})")
    counts = {}
    for name in ("fuse.ply", "fuse_post.ply"):
        counts[name] = mesh_ply_counts(os.path.join(out_dir, name))
        check(min(counts[name]) > 0, f"{name}: {counts[name][0]} vertices, "
              f"{counts[name][1]} faces")
    print(f"  extract_mesh: {mesh_s:.3f} s; fusion {times['fuse_s']:.3f} s (of which "
          f"{n_train} render2d {times['render_s']:.3f} s), marching cubes "
          f"{times['marching_cubes_s']:.3f} s, post-processing {times['post_process_s']:.3f} "
          f"s; CPU fusion {times['fuse_cpu_s']:.3f} s; peak device memory {peak_mib:.1f} MiB; "
          f"observed voxels {grid['observed']:.4f}; launches {launches['mesh']}")
    wall = time.perf_counter() - t_phase
    print(f"  phase wall {wall:.2f} s")
    keys = ("preprocess", "expand", "sort", "composite", "surfel_composite",
            "surfel_composite_train", "surfel_backward")
    scorp2d = {k: launches["segmentation"][k] + launches["align"][k] for k in keys}
    return scorp2d, launches["mesh"], {
        "launches_by_stage": launches, "vote_ms": vote_ms, "vote_err": vote_errs,
        "seg_vote_err": seg_err, "selected": int(sel.sum()), "recall": recall,
        "precision": precision, "align_s": align_s, "renders": renders,
        "align_rounds": {str(k): v for k, v in sorted(rounds.items())},
        "align_centroid_err": [current["coarse_err"], c_err], "orb": orb_card,
        "mesh_s": mesh_s, **times, "grid": grid, "peak_mib": peak_mib, "mesh_counts": counts,
        "wall_s": wall,
    }


DP_BATCH = 4      # cameras per data-parallel step in phase 14
DP_STEPS = 3      # data-parallel steps of each kind in phase 14
ORBIT_FRAMES = 8  # frames of phase 14's ellipse path
VIDEO_FPS = 30  # the rate of phase 14's orbit videos (create_videos' default)
# least PSNR (dB) of the encoder's reconstruction of an orbit against its PNGs:
# tests/test_torch_video.py measures this scene's orbit renders at 200x133
# (n/64 gaussians, scales x8) at 37.9-38.6 dB for 3DGS and 34.1-35.4 dB for
# 2DGS at VOP_QUANT 3, and holds them to this limit as well
VIDEO_PSNR_MIN = 32.0
METRICS = os.path.join(ROOT, "build", "smoke_metrics")  # phase 2's renders + GT, for phase 14


def keep_for_metrics(scene_dir: str, model_dir: str) -> None:
    """Copy phase 2's render_3dgs outputs and their ground truth to METRICS
    (pred/, gt/): phase 14 evaluates them after WORK is cleared."""
    shutil.rmtree(METRICS, ignore_errors=True)
    for sub in ("pred", "gt"):
        os.makedirs(os.path.join(METRICS, sub))
    out_dir = os.path.join(model_dir, "rendered_refined")
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".png"):
            shutil.copy(os.path.join(out_dir, name), os.path.join(METRICS, "pred", name))
            shutil.copy(os.path.join(scene_dir, "images", name), os.path.join(METRICS, "gt", name))


def check_columns(got: dict, ref: dict, label: str) -> float:
    """The K3 atomics rule of phases 4/7 on each tensor of a dict: finite,
    and per column (the trailing dimensions flattened) max |diff| <= 1e-4 x
    the column's largest |ref|. Returns the worst ratio of the two."""
    import torch

    worst = 0.0
    for k in ref:
        a = got[k].reshape(got[k].shape[0], -1).to(torch.float64)
        b = ref[k].reshape(ref[k].shape[0], -1).to(torch.float64)
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"{label} {k}: not finite")
        diff = (a - b).abs().amax(dim=0)
        scale = b.abs().amax(dim=0)
        if not bool((diff <= 1e-4 * scale).all()):
            raise AssertionError(f"{label} {k}: per column max |diff| above 1e-4 x max |ref| "
                                 f"(worst {float((diff / scale.clamp_min(1e-30)).max()):.3g})")
        worst = max(worst, float((diff / scale.clamp_min(1e-30)).max()))
    print(f"  ok: {label}: {sorted(ref)} per column within 1e-4 x the column's largest "
          f"(worst {worst:.3g})")
    return worst


def seeded_adam(state, seed: int):
    """Adam state at step 6 with zero first moments and second moments from
    `seed` (U(1e-7, 1e-5), the CPU tests' range): a step's parameter update
    is then smooth in the gradient (no lr x sign(g) from zero moments, whose
    sign the atomics' run-to-run noise could flip), and the gradient comes
    back exactly as m' / 0.1."""
    import torch

    from scorp_tpu_torch.train import AdamState

    gen = torch.Generator(device=state.alive.device).manual_seed(seed)
    return AdamState({k: torch.zeros_like(v) for k, v in state.params.items()},
                     {k: 1e-7 + torch.rand(v.shape, generator=gen, device=v.device) * 9.9e-6
                      for k, v in state.params.items()}, 6)


def recovered_grads(adam1) -> dict:
    """The gradient of one Adam step from zero first moments: m' = 0.1 g."""
    return {k: adam1.m[k].double() / 0.1 for k in adam1.m}


def ellipse_open_close(mask: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx MORPH_OPEN then MORPH_CLOSE with
    getStructuringElement(MORPH_ELLIPSE, (5, 5)) (rows 0 and 4 hold only the
    centre, rows 1-3 all five), by shifted ANDs and ORs: erosion reads 1
    outside the image, dilation 0, as cv2's default borders do."""
    offsets = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if abs(dy) < 2 or dx == 0]
    h, w = mask.shape

    def morph(m, erode):
        p = np.pad(m, 2, constant_values=erode)
        views = [p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w] for dy, dx in offsets]
        return np.logical_and.reduce(views) if erode else np.logical_or.reduce(views)

    m = morph(morph(mask, True), False)
    return morph(morph(m, False), True)


def dp_phase_step(kind, state, adam, batch, gts, it, bg, group, **kw):
    """One dp_train_step (kind "3dgs") or dp_train_step_2d ("2dgs"); raises
    on a non-finite loss."""
    import torch

    from scorp_tpu_torch.parallel import dp_train_step, dp_train_step_2d

    step = dp_train_step_2d if kind == "2dgs" else dp_train_step
    s, a, m = step(state, adam, batch, gts, it, bg, group=group, **kw)
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"{kind} dp step at iteration {it}: loss {float(m['loss'])}")
    return s, a, m


def phase_dp_step(kind, args, device, state, cams, gts, bg, first_it, launches, checks):
    """Phase 14, steps 1-2: DP_STEPS data-parallel steps of DP_BATCH cameras
    in a one-rank NCCL group (the main path, counted), then the checks:
    step 1 against the same step with no group, against the mean (and the
    statistics against the sum, max) of the single-camera steps, and camera
    0's step against the plain versions of its kernels; times beside
    DP_BATCH x one train_step."""
    import torch

    from scorp_tpu_torch.parallel import make_group, replicate, shard_batch, stack_cameras
    from scorp_tpu_torch.render import default_raster_config
    from scorp_tpu_torch.train import Opt2DParams, OptParams, train_step, train_step_2d

    surfel = kind == "2dgs"
    opt = Opt2DParams(lambda_dist=100.0) if surfel else OptParams()
    cfg = default_raster_config(state.capacity)
    kw = dict(opt=opt, sh_degree=3, cfg=cfg, width=args.width, height=args.height)
    batch = stack_cameras(cams)
    adam0 = seeded_adam(state, args.seed)
    w, h = args.width, args.height

    # the main path: DP_STEPS steps, each on the group, counted
    with make_group(1, 0, device=device, timeout=120) as group:
        s, a = replicate(state, group), replicate(adam0, group)
        b_local, g_local = shard_batch(batch, group), shard_batch(gts, group)
        first, losses = None, []
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for i in range(DP_STEPS):
            s, a, m = dp_phase_step(kind, s, a, b_local, g_local, first_it + i, bg, group, **kw)
            first = first or (s, a)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[kind] = kernel_launches()
    print(f"  {kind}: {DP_STEPS} dp steps from iteration {first_it}, losses "
          f"{[round(float(x), 6) for x in losses]}")
    n = DP_BATCH * DP_STEPS
    want = (launches_of(expand=n, sort=n, surfel_composite_train=n, surfel_backward=n)
            if surfel else launches_of(expand=n, sort=n, composite=n, backward=n))
    check(launches[kind] == want, f"{kind}: one K1, sort and {'K5, K6' if surfel else 'K2, K3'} "
          f"per camera of each step ({n}): {launches[kind]}")
    check(all(bool(torch.isfinite(v).all()) for v in s.params.values()),
          f"{kind}: parameters finite after {DP_STEPS} steps")

    reset_launches()
    # step 1 with no group
    s0, a0, _ = dp_phase_step(kind, state, adam0, batch, gts, first_it, bg, None, **kw)
    stats = ("max_radii2d", "xyz_grad_accum", "denom")
    check_columns({**first[0].params, **{k: getattr(first[0], k)[:, None] for k in stats},
                   **{"m." + k: v for k, v in first[1].m.items()},
                   **{"v." + k: v for k, v in first[1].v.items()}},
                  {**s0.params, **{k: getattr(s0, k)[:, None] for k in stats},
                   **{"m." + k: v for k, v in a0.m.items()},
                   **{"v." + k: v for k, v in a0.v.items()}},
                  f"{kind} step 1 on the group vs no group")
    check(bool(torch.equal(first[0].denom, s0.denom)), f"{kind}: denom equal with and "
          "without the group")
    grad_dp = recovered_grads(a0)
    # the single-camera steps
    singles = [dp_phase_step(kind, state, adam0, stack_cameras([c]), gts[i:i + 1], first_it,
                             bg, None, **kw) for i, c in enumerate(cams)]
    mean = {k: sum(recovered_grads(x[1])[k] for x in singles) / DP_BATCH
            for k in grad_dp}
    err_mean = check_columns(grad_dp, mean, f"{kind} batch gradient vs the mean of the "
                             f"{DP_BATCH} single-camera gradients")
    acc = sum(x[0].xyz_grad_accum - state.xyz_grad_accum for x in singles)
    check_columns({"xyz_grad_accum": (s0.xyz_grad_accum - state.xyz_grad_accum)[:, None]},
                  {"xyz_grad_accum": acc[:, None]}, f"{kind} screen-gradient sums vs the "
                  "single-camera sums")
    check(bool(torch.equal(s0.denom - state.denom,
                           sum(x[0].denom - state.denom for x in singles))),
          f"{kind}: denom increments equal the single-camera sum")
    check(bool(torch.equal(s0.max_radii2d, torch.stack([x[0].max_radii2d
                                                        for x in singles]).amax(0))),
          f"{kind}: max_radii2d equals the single-camera maximum")
    # camera 0 through the plain versions of its kernels
    with plain_kernels():
        plain = dp_phase_step(kind, state, adam0, stack_cameras(cams[:1]), gts[:1], first_it,
                              bg, None, **kw)
    err_plain = check_columns(recovered_grads(singles[0][1]),
                              recovered_grads(plain[1]),
                              f"{kind} camera 0's gradient vs the plain versions of "
                              f"K1, {'K5, K6' if surfel else 'K2, K3'}")

    # times: the DP step beside DP_BATCH x one train_step of camera 0
    def dp_step():
        return dp_phase_step(kind, state, adam0, batch, gts, first_it, bg, None, **kw)

    one_step = train_step_2d if surfel else train_step
    zeros = torch.zeros(1, h, w, device=device)

    def single():
        return one_step(state, adam0, cams[0], gts[0], zeros, zeros, first_it, bg, opt=opt,
                        sh_degree=3, cfg=cfg)

    dp_ms = cuda_ms(dp_step, 3)
    single_ms = cuda_ms(single, 5)
    busy, top = device_profile(dp_step, 2)
    torch.cuda.reset_peak_memory_stats()
    dp_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    checks.append(kernel_launches())
    print(f"  {kind} dp step (B={DP_BATCH}): {dp_ms:.3f} ms (CUDA-event median of 3), device "
          f"busy {busy:.3f} ms (CUPTI, 2 steps) -> idle share {1 - busy / dp_ms:.3f}; peak "
          f"{peak / 2**20:.1f} MiB; {DP_BATCH} x train_step{'_2d' if surfel else ''} "
          f"{DP_BATCH * single_ms:.3f} ms ({single_ms:.3f} each); {DP_STEPS} steps "
          f"{run_s:.3f} s")
    for name, ms in top[:4]:
        print(f"    {ms:8.3f} ms  {name}")
    return {"dp_ms": dp_ms, "busy_ms": busy, "idle": 1 - busy / dp_ms, "peak_mib": peak / 2**20,
            "train_step_ms": single_ms, "err_mean": err_mean, "err_plain": err_plain,
            "steps_s": run_s}


def viewer_round_trip(state, host_cam, cfg, bg, device, launches):
    """Phase 14, step 6: a client thread asks gui_tick for one full-width
    frame of `host_cam`; the served bytes equal encode_image of render() of
    the same MiniCam. Returns the round trip in ms."""
    import socket
    import threading

    import torch

    from scorp_tpu_torch.core.camera import projection_matrix
    from scorp_tpu_torch.render import render
    from scorp_tpu_torch.scene import MiniCam
    from scorp_tpu_torch.viewer import NetworkGUI, gui_tick, maybe_create_gui

    w, h = host_cam.resolution
    wvt = host_cam.world_view_transform.astype(np.float32)
    fpt = (host_cam.world_view_transform @ projection_matrix(
        host_cam.znear, host_cam.zfar, host_cam.fovx, host_cam.fovy).T).astype(np.float32)
    sent_v, sent_p = wvt.copy(), fpt.copy()
    sent_v[:, 1:3] *= -1  # the viewer's convention: receive() flips them back
    sent_p[:, 1] *= -1
    payload = {"resolution_x": w, "resolution_y": h, "train": 1, "fov_y": host_cam.fovy,
               "fov_x": host_cam.fovx, "z_near": host_cam.znear, "z_far": host_cam.zfar,
               "shs_python": 0, "rot_scale_python": 0, "keep_alive": 1,
               "scaling_modifier": 1.0,
               "view_matrix": [float(x) for x in sent_v.reshape(-1)],
               "view_projection_matrix": [float(x) for x in sent_p.reshape(-1)]}
    gui = maybe_create_gui("127.0.0.1", 0)
    check(gui is not None, "the viewer socket is bound")
    port = gui.listener.getsockname()[1]
    got = {}
    expected = w * h * 3 + 4 + len("smoke")

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
            msg = json.dumps(payload).encode()
            t0 = time.perf_counter()
            sock.sendall(len(msg).to_bytes(4, "little") + msg)
            buf = bytearray()
            while len(buf) < expected:
                chunk = sock.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
            got["ms"] = 1e3 * (time.perf_counter() - t0)
            got["buf"] = bytes(buf)

    def render_fn(minicam, smod):
        got["cam"] = minicam
        out = render(minicam.to_torch(device), state, bg, scaling_modifier=float(smod), cfg=cfg)
        return out["render"].cpu().numpy()

    thread = threading.Thread(target=client, daemon=True)
    try:
        reset_launches()
        thread.start()
        deadline = time.time() + 60
        while "cam" not in got and time.time() < deadline:
            gui_tick(gui, render_fn, "smoke", iteration=1, max_iterations=10)
            time.sleep(0.005)
        thread.join(timeout=60)
        launches["viewer"] = kernel_launches()
    finally:
        gui.close()
    check(not thread.is_alive() and len(got.get("buf", b"")) == expected,
          f"the viewer client got {len(got.get('buf', b''))} of {expected} bytes")
    check(launches["viewer"] == launches_of(preprocess=1, expand=1, sort=1, composite=1),
          "one fused preprocess, K1, sort and K2 for the viewer's frame")
    ref_cam = MiniCam(w, h, host_cam.fovy, host_cam.fovx, host_cam.znear, host_cam.zfar,
                      wvt, fpt)
    check(np.array_equal(got["cam"].world_view_transform, wvt)
          and np.array_equal(got["cam"].full_proj_transform, fpt),
          "the received MiniCam's matrices equal the sent camera's (Y/Z flips undone)")
    with torch.no_grad():
        frame = render(ref_cam.to_torch(device), state, bg, cfg=cfg)["render"].cpu().numpy()
    check(got["buf"] == NetworkGUI.encode_image(frame) + (5).to_bytes(4, "little") + b"smoke",
          f"the served {w}x{h} frame equals encode_image(render()) of the same MiniCam, "
          "then the verify string")
    return got["ms"]


@contextlib.contextmanager
def proxy_lpips_only():
    """Inside the block the metrics app finds no LPIPS weights outside the
    checkout ($SCORP_LPIPS_WEIGHTS, ~/.cache) and no `lpips` package, so it
    takes the bundled proxy and reads or fetches nothing else."""
    from scorp_tpu_torch.ops import perceptual

    saved = perceptual.default_lpips_weights_path, sys.modules.get("lpips", "absent")
    perceptual.default_lpips_weights_path = lambda: None
    sys.modules["lpips"] = None
    try:
        yield
    finally:
        perceptual.default_lpips_weights_path = saved[0]
        if saved[1] == "absent":
            del sys.modules["lpips"]
        else:
            sys.modules["lpips"] = saved[1]


@contextlib.contextmanager
def timed_calls(module, names, sync):
    """Wrap each `module.<name>` to add its wall seconds, to the end of
    `sync()` after it, to a dict by name; yields the dict."""
    saved = {name: getattr(module, name) for name in names}
    spent = dict.fromkeys(names, 0.0)

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def check_video(frame_dir: str, tag: str, width: int, height: int, device) -> dict:
    """`render_paths.create_videos` of one orbit's PNGs on the card, timed
    by stage (PNG read, the device stages `intra_levels` and `vop_codes`,
    then `pack_bits` and the container), and again with device="cpu": the
    two files byte-equal, the container parsed back (ORBIT_FRAMES samples,
    the VOL's size and rate, stsz summing to mdat's payload) and the
    encoder's reconstruction of every frame against its PNG (PSNR >=
    VIDEO_PSNR_MIN)."""
    import torch

    from scorp_tpu_torch.pipeline import render_paths, video

    path, cpu_path = (os.path.join(WORK, f"{tag}{s}.mp4") for s in ("", "_cpu"))
    torch.cuda.synchronize()
    reset_launches()
    with timed_calls(render_paths, ("read_png",), lambda: None) as read, \
            timed_calls(video, ("intra_levels", "vop_codes", "pack_bits"),
                        torch.cuda.synchronize) as dev:
        t0 = time.perf_counter()
        render_paths.create_videos(frame_dir, path, VIDEO_FPS, device=device)
        total = time.perf_counter() - t0
    check(kernel_launches() == launches_of(), f"{tag}.mp4: the encoder launches no kernel")
    t0 = time.perf_counter()
    render_paths.create_videos(frame_dir, cpu_path, VIDEO_FPS, device="cpu")
    cpu_s = time.perf_counter() - t0
    with open(path, "rb") as f, open(cpu_path, "rb") as g:
        card, cpu = f.read(), g.read()
    check(card == cpu, f"{tag}.mp4 encoded on the card is byte-equal to the CPU's encode "
          f"({len(card)} bytes)")
    info = video.read_mp4(path)
    n = len(info.sample_sizes)
    check(n == ORBIT_FRAMES and (info.width, info.height, info.vop_rate)
          == (width, height, VIDEO_FPS) and sum(info.sample_sizes) == info.mdat_payload,
          f"{tag}.mp4 parses back: {n} samples, VOL {info.width}x{info.height} at "
          f"{info.vop_rate} fps, stsz sum {sum(info.sample_sizes)} = mdat payload "
          f"{info.mdat_payload}")
    sq, count = 0.0, 0
    for name in sorted(os.listdir(frame_dir)):
        src = torch.from_numpy(render_paths.read_png(os.path.join(frame_dir, name))).to(device)
        rec = video.reconstruct(video.intra_levels(src), width, height)
        sq += float(((rec.double() - src.double()) ** 2).sum())
        count += src.numel()
    psnr_db = 10 * np.log10(255.0 ** 2 / (sq / count))
    check(psnr_db >= VIDEO_PSNR_MIN, f"{tag}.mp4: the reconstruction's PSNR against the PNGs "
          f"{psnr_db:.4f} dB >= {VIDEO_PSNR_MIN} dB")
    ms = {"total": 1e3 * total / n, "png_read": 1e3 * read["read_png"] / n,
          "device_stages": 1e3 * (dev["intra_levels"] + dev["vop_codes"]) / n,
          "pack_bits": 1e3 * dev["pack_bits"] / n}
    ms["packing_and_container"] = ms["total"] - ms["png_read"] - ms["device_stages"]
    out = {"bytes_per_frame": info.mdat_payload / n, "file_bytes": len(card),
           "ms_per_frame": ms, "cpu_ms_per_frame": 1e3 * cpu_s / n, "psnr_db": float(psnr_db)}
    print(f"  {tag}.mp4: {n} frames at {width}x{height}, {out['bytes_per_frame']:.0f} bytes "
          f"per frame; encode on the card {ms['total']:.3f} ms per frame = PNG read "
          f"{ms['png_read']:.3f} + device stages {ms['device_stages']:.3f} + bit packing and "
          f"container {ms['packing_and_container']:.3f} (pack_bits alone "
          f"{ms['pack_bits']:.3f}); on the CPU {out['cpu_ms_per_frame']:.3f} ms per frame; "
          f"reconstruction PSNR {psnr_db:.4f} dB")
    return out


def phase_dp(args, device):
    """Phase 14: the camera-batch data-parallel steps (3DGS and 2DGS) in a
    one-rank NCCL group, dp_render, the ellipse path rendered both ways and
    encoded into videos, the metrics app on the card, the viewer's round
    trip and segmentation_2d without cv2, on phase 12's 10-view scene at
    full width."""
    import torch
    from PIL import Image

    from scorp_tpu_torch.apps import metrics, segmentation_2d
    from scorp_tpu_torch.config import ModelParams
    from scorp_tpu_torch.core.plyio import GaussianData, load_gaussian_ply
    from scorp_tpu_torch.ops import perceptual
    from scorp_tpu_torch.ops.losses import psnr, ssim
    from scorp_tpu_torch.parallel import dp_render, stack_cameras
    from scorp_tpu_torch.pipeline.render_paths import generate_ellipse_path, save_img_u8
    from scorp_tpu_torch.render import default_raster_config, render
    from scorp_tpu_torch.render2d import render2d
    from scorp_tpu_torch.scene import Scene
    from scorp_tpu_torch.train import from_gaussian_data

    t_phase = time.perf_counter()
    scene_dir = os.path.join(WORK, "scorp_scene")
    g3 = load_gaussian_ply(os.path.join(WORK, "scorp_model", "point_cloud", "iteration_7000",
                                        "point_cloud.ply"))
    g2 = GaussianData(xyz=g3.xyz, f_dc=g3.f_dc, f_rest=g3.f_rest, opacity=g3.opacity,
                      scaling=np.ascontiguousarray(g3.scaling[:, :2]), rotation=g3.rotation)
    state3, state2 = (from_gaussian_data(g, device=device) for g in (g3, g2))
    cfg = default_raster_config(state3.capacity)
    dataset = ModelParams(source_path=scene_dir, model_path=os.path.join(WORK, "dp_model"),
                          eval=True, split_yml_name="split.yml").finalize()
    scene = Scene(dataset, shuffle=False, load_gaussians=False)
    train, test = scene.get_train_cameras(), scene.get_test_cameras()
    cams = [c.to_torch(device) for c in train[:DP_BATCH]]
    gts = torch.stack([torch.as_tensor(c.gt().image, device=device) for c in train[:DP_BATCH]])
    bg = torch.zeros(3, device=device)
    launches, checks, out = {}, [], {}

    # 1-2. the data-parallel training steps
    out["3dgs"] = phase_dp_step("3dgs", args, device, state3, cams, gts, bg, 7001, launches,
                                checks)
    out["2dgs"] = phase_dp_step("2dgs", args, device, state2, cams, gts, bg, 8000, launches,
                                checks)
    torch.cuda.empty_cache()

    # 3. camera-parallel eval of the test views, bit-equal to render()
    batch = stack_cameras([c.to_torch(device) for c in test])
    kw = dict(sh_degree=3, cfg=cfg, width=args.width, height=args.height)
    torch.cuda.synchronize()
    reset_launches()
    frames = dp_render(state3.params, state3.alive, batch, bg, **kw)
    torch.cuda.synchronize()
    launches["dp_render"] = kernel_launches()
    n = len(test)
    check(launches["dp_render"] == launches_of(preprocess=n, expand=n, sort=n, composite=n),
          f"dp_render: one fused preprocess, K1, sort and K2 per camera ({n})")
    reset_launches()
    for i, c in enumerate(test):
        ref = render(c.to_torch(device), state3, bg, cfg=cfg)
        check(all(torch.equal(a[i], ref[k]) for a, k in zip(
            frames, ("render", "render_alpha", "render_depth"))),
              f"dp_render frame {i} (color, alpha, depth) bit-equal to render()'s")
    dpr_ms = cuda_ms(lambda: dp_render(state3.params, state3.alive, batch, bg, **kw), 5) / n
    render_ms = cuda_ms(lambda: render(test[0].to_torch(device), state3, bg, cfg=cfg), 5)
    checks.append(kernel_launches())
    print(f"  dp_render: {dpr_ms:.3f} ms per frame, render(): {render_ms:.3f} ms (CUDA-event "
          "medians of 5)")
    out["dp_render_ms"], out["render_ms"] = dpr_ms, render_ms

    # 4. the ellipse path through render() and render2d, saved as PNGs
    path = generate_ellipse_path(train, n_frames=ORBIT_FRAMES)
    for tag, fn, st, kernel in (("orbit_3dgs", render, state3, "composite"),
                                ("orbit_2dgs", render2d, state2, "surfel_composite")):
        frame_dir = os.path.join(WORK, tag)
        os.makedirs(frame_dir)
        torch.cuda.synchronize()
        reset_launches()
        alphas = []
        for i, mc in enumerate(path):
            o = fn(mc.to_torch(device), st, bg, cfg=cfg)
            check(bool(torch.isfinite(o["render"]).all()), f"{tag} frame {i}: finite")
            alphas.append(float(o["render_alpha"].mean()))
            save_img_u8(o["render"].cpu().numpy(), os.path.join(frame_dir, f"{i:03d}.png"))
        launches[tag] = kernel_launches()
        pre = ORBIT_FRAMES if kernel == "composite" else 0  # the 3DGS path's preprocess
        check(launches[tag] == launches_of(preprocess=pre, expand=ORBIT_FRAMES,
                                           sort=ORBIT_FRAMES, **{kernel: ORBIT_FRAMES}),
              f"{tag}: one K1, sort and "
              f"{'K4' if kernel != 'composite' else 'fused preprocess and K2'} per frame")
        check(min(alphas) > 0, f"{tag}: every frame covers the scene (mean alpha "
              f"{min(alphas):.4f} .. {max(alphas):.4f})")
        with Image.open(os.path.join(frame_dir, "000.png")) as im:
            check(im.size == (args.width, args.height) and im.mode == "RGB",
                  f"{tag}: PNGs written ({im.size[0]}x{im.size[1]})")

    # 4b. each orbit's PNGs encoded into a video on the card and on the CPU
    out["video"] = {tag: check_video(os.path.join(WORK, tag), tag, args.width, args.height,
                                     device) for tag in ("orbit_3dgs", "orbit_2dgs")}

    # 5. the metrics app on the card against the CPU
    pred, gt = os.path.join(METRICS, "pred"), os.path.join(METRICS, "gt")
    reset_launches()
    with proxy_lpips_only():
        t0 = time.perf_counter()
        res = metrics.evaluate_dirs(pred, gt, use_alpha=True, device=device)
        metrics_s = time.perf_counter() - t0
        res_cpu = metrics.evaluate_dirs(pred, gt, use_alpha=True, device="cpu")
    check(res["lpips_backend"] == res_cpu["lpips_backend"] == "lpips_proxy"
          and res["n_images"] == 2, f"metrics on the card: {json.dumps(res)}")
    for k, tol in (("psnr", 1e-5), ("ssim", 1e-5), ("lpips_proxy", 1e-4)):
        check(abs(res[k] - res_cpu[k]) <= tol * abs(res_cpu[k]),
              f"{k} on the card {res[k]:.8g} vs the CPU {res_cpu[k]:.8g}: within {tol:g} "
              "relative")
    rng = np.random.default_rng(args.seed)
    weights = {}
    for i, (cout, cin) in enumerate(perceptual._VGG_CHANNELS):
        weights[f"conv{i}_w"] = rng.normal(0, 0.2 / np.sqrt(cin * 9),
                                           (cout, cin, 3, 3)).astype(np.float32)
        weights[f"conv{i}_b"] = rng.uniform(0, 0.1, cout).astype(np.float32)
    for j, c in enumerate(perceptual._LPIPS_TAP_CHANNELS):
        weights[f"lin{j}"] = rng.uniform(0, 1, c).astype(np.float32)
    wpath = os.path.join(WORK, "lpips_random.npz")
    np.savez(wpath, **weights)
    crop = os.path.join(WORK, "crop")
    for sub, src in (("pred", pred), ("gt", gt)):
        os.makedirs(os.path.join(crop, sub))
        for name in os.listdir(src):
            with Image.open(os.path.join(src, name)) as im:
                x, y = im.size[0] // 2 - 128, im.size[1] // 2 - 128
                im.crop((x, y, x + 256, y + 256)).save(os.path.join(crop, sub, name))
    lp_card = metrics.evaluate_dirs(os.path.join(crop, "pred"), os.path.join(crop, "gt"),
                                    lpips_weights=wpath, device=device)
    lp_cpu = metrics.evaluate_dirs(os.path.join(crop, "pred"), os.path.join(crop, "gt"),
                                   lpips_weights=wpath, device="cpu")
    check(lp_card["lpips_backend"] == "lpips" and lp_card["lpips"] > 0
          and abs(lp_card["lpips"] - lp_cpu["lpips"]) <= 1e-4 * lp_cpu["lpips"],
          f"LPIPS (random weights of the true shapes) on a 256x256 crop: card "
          f"{lp_card['lpips']:.8g} vs CPU {lp_cpu['lpips']:.8g}, within 1e-4 relative")
    name = sorted(os.listdir(pred))[0]
    a = torch.as_tensor(metrics._load(os.path.join(pred, name))[0], device=device)
    b = torch.as_tensor(metrics._load(os.path.join(gt, name))[0], device=device)
    w_dev = perceptual.lpips_weights_to(weights, device)
    ms = {"psnr_ssim": cuda_ms(lambda: (psnr(a, b), ssim(a, b)), 5),
          "lpips_proxy": cuda_ms(lambda: perceptual.lpips_proxy(a, b), 5),
          "lpips": cuda_ms(lambda: perceptual.lpips(a, b, w_dev), 3)}
    check(float(perceptual.lpips(a, b, w_dev)) > 0, "LPIPS at full width on the card is > 0")
    check(kernel_launches() == launches_of(), "the metrics launch no kernel")
    print(f"  metrics per {args.width}x{args.height} image on the card, ms (CUDA-event "
          f"medians): {json.dumps({k: round(v, 4) for k, v in ms.items()})}; evaluate_dirs "
          f"{metrics_s:.3f} s for 2 images")
    out["metrics_ms"] = ms

    # 6. the viewer
    out["viewer_ms"] = viewer_round_trip(state3, test[0], cfg, bg, device, launches)
    print(f"  viewer round trip (request -> {args.width}x{args.height} frame + verify): "
          f"{out['viewer_ms']:.3f} ms")

    # 7. segmentation_2d --mask_dir on a copy of phase 12's scene, without cv2
    seg_scene = os.path.join(WORK, "seg2d_scene")
    seg_masks = os.path.join(WORK, "seg2d_masks")
    for sub in ("images", "sparse"):
        shutil.copytree(os.path.join(scene_dir, sub), os.path.join(seg_scene, sub))
    shutil.copytree(os.path.join(scene_dir, "masked_image_rgba", "obj"),
                    os.path.join(seg_masks, "obj"))
    import yaml

    with open(os.path.join(seg_scene, "description.yml"), "w") as f:
        yaml.safe_dump({"prompts": "obj", "ext": "png", "detect_conf": 0.3}, f)
    saved_cv2 = sys.modules.get("cv2", "absent")
    sys.modules["cv2"] = None  # an import of cv2 raises ImportError inside the app
    reset_launches()
    try:
        t0 = time.perf_counter()
        segmentation_2d.main(["-s", seg_scene, "--mask_dir", seg_masks])
        seg_s = time.perf_counter() - t0
    finally:
        if saved_cv2 == "absent":
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved_cv2
    check(kernel_launches() == launches_of(), "segmentation_2d launches no kernel")
    names = sorted(os.listdir(os.path.join(seg_masks, "obj")))
    for sub in ("obj", "masked"):
        written = sorted(os.listdir(os.path.join(seg_scene, "masked_image_rgba", sub)))
        check(written == names, f"segmentation_2d wrote masked_image_rgba/{sub}/ for "
              f"{len(names)} views")
    for name in names:
        with Image.open(os.path.join(seg_masks, "obj", name)) as im:
            mask = np.asarray(im)[..., 3] > 0
        want = ellipse_open_close(mask)
        with Image.open(os.path.join(seg_scene, "masked_image_rgba", "obj", name)) as im:
            rgba = np.asarray(im)
        with Image.open(os.path.join(seg_scene, "images", name)) as im:
            rgb = np.asarray(im.convert("RGB"))
        check(np.array_equal(rgba[..., 3] > 0, want) and np.array_equal(rgba[..., :3], rgb)
              and set(np.unique(rgba[..., 3])) <= {0, 255},
              f"segmentation_2d {name}: alpha = open-then-close of the mask "
              f"({int(want.sum())} px, {int((want != mask).sum())} changed), RGB = the image")
    print(f"  segmentation_2d: {seg_s:.3f} s for {len(names)} views")
    out["seg2d_s"] = seg_s

    wall = time.perf_counter() - t_phase
    print(f"  phase wall {wall:.2f} s")
    out["wall_s"] = wall
    main_path = {k: sum(v[k] for v in launches.values()) for k in kernel_launches()}
    out["launches_by_stage"] = launches
    out["check_launches"] = {k: sum(c[k] for c in checks) for k in kernel_launches()}
    return main_path, out


LONG_2DGS_ITERS = 1000  # phase 15's 2DGS run: densify rounds at 600-1000
LONG_PROFILED_STEPS = 20  # train_step calls timed and traced at the pilot's final state
# the JAX densification run's test PSNR at 3,000 (BASELINE.md:113, run 1,
# --grad_threshold 1e-4) less a margin for the split samples and rounding
# that differ between the packages
LONG_PSNR_3K_DB = 23.79 - 0.5


# phase 15's statistic check: each gaussian's mean screen gradient through
# K1-K3 against the plain versions on the card, relative to its own above a
# floor of the largest (K3 sums with atomics, in another order than the plain
# version's index_add_), and the candidate sets at the run's threshold
LONG_STAT_RTOL = 1e-3
LONG_STAT_FLOOR = 1e-3
LONG_STAT_THRESHOLD = 1e-4
LONG_CAND_COUNT_RTOL = 0.005
LONG_CAND_JACCARD = 0.99


def accumulated_statistic(state, adam, views, gts, iteration: int, cfg, device):
    """The densification statistic summed over `views`, one `train_step`
    each from the unchanged `state` (its statistics at zero; the updated
    parameters are dropped) -> (accum, denom, cfg, steps): what
    accumulate_stats would hold after one pass over the views. A view that
    drops keys is stepped again with the regrown capacity."""
    import torch

    from scorp_tpu_torch.render import regrow_config
    from scorp_tpu_torch.train import OptParams, train_step

    opt = OptParams(densify_grad_threshold=LONG_STAT_THRESHOLD)
    bg = torch.zeros(3, device=device)
    accum = torch.zeros(state.capacity, device=device)
    denom = torch.zeros_like(accum)
    steps = 0
    for cam, gt in zip(views, gts):
        zeros = torch.zeros((1,) + gt.shape[1:], device=device)
        while True:
            new, _, m = train_step(state, adam, cam.to_torch(device), gt, zeros, zeros,
                                   iteration, bg, opt=opt, sh_degree=3, cfg=cfg)
            steps += 1
            dropped = int(m.num_dropped_keys)
            if not dropped:
                break
            cfg = regrow_config(cfg, dropped)
        accum += new.xyz_grad_accum
        denom += new.denom
    return accum, denom, cfg, steps


def check_long_statistic(ply, views, iteration: int, cfg, device) -> dict:
    """Phase 15(c): the densification statistic of the pilot's saved state
    over every view of the scene, through K1, the sort, K2 and K3 and again
    through their plain versions on the card, held per gaussian and by the
    candidate set it selects."""
    import torch

    from scorp_tpu_torch.train import from_gaussian_data, init_adam

    state = from_gaussian_data(ply, device=device)
    adam = init_adam(state)
    gts = [torch.as_tensor(cam.gt().image, device=device) for cam in views]
    reset_launches()
    t0 = time.perf_counter()
    accum, denom, cfg, steps = accumulated_statistic(state, adam, views, gts, iteration, cfg,
                                                     device)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launched = kernel_launches()
    check(launched == launches_of(expand=steps, sort=steps, composite=steps, backward=steps),
          f"the statistic through the kernels: {steps} steps over {len(views)} views, one "
          f"K1, sort, K2 and K3 each: {launched}")
    t0 = time.perf_counter()
    with plain_kernels():
        accum_p, denom_p, _, steps_p = accumulated_statistic(state, adam, views, gts, iteration,
                                                             cfg, device)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(steps_p == len(views) and torch.equal(denom, denom_p),
          f"the plain pass stepped each view once ({steps_p}) and saw the same gaussians "
          f"({int((denom_p > 0).sum())} seen)")
    seen = denom_p > 0
    mean = torch.where(seen, accum / denom.clamp_min(1.0), 0.0)
    mean_p = torch.where(seen, accum_p / denom_p.clamp_min(1.0), 0.0)
    floor = LONG_STAT_FLOOR * float(mean_p.max())
    big = mean_p > floor
    gap = (mean - mean_p).abs()
    rel_max = float((gap[big] / mean_p[big]).max())
    small_max = float(gap[~big].max()) if bool((~big).any()) else 0.0
    check(rel_max <= LONG_STAT_RTOL and small_max <= LONG_STAT_RTOL * floor,
          f"each gaussian's mean screen gradient, kernels against plain: {rel_max:.3e} of its "
          f"own at most ({int(big.sum())} above {LONG_STAT_FLOOR:g} of the largest, "
          f"{float(mean_p.max()):.4e}); below it {small_max:.3e} (limit "
          f"{LONG_STAT_RTOL * floor:.3e})")
    hot, hot_p = mean >= LONG_STAT_THRESHOLD, mean_p >= LONG_STAT_THRESHOLD
    n, n_p = int(hot.sum()), int(hot_p.sum())
    jaccard = int((hot & hot_p).sum()) / max(int((hot | hot_p).sum()), 1)
    check(abs(n - n_p) <= LONG_CAND_COUNT_RTOL * n_p and jaccard >= LONG_CAND_JACCARD,
          f"candidates at {LONG_STAT_THRESHOLD:g}: {n} through the kernels, {n_p} plain "
          f"(within {LONG_CAND_COUNT_RTOL:.1%}), Jaccard {jaccard:.5f} >= {LONG_CAND_JACCARD}")
    out = {"views": len(views), "alive": int(state.num_alive()), "seen": int(seen.sum()),
           "mean_max": float(mean_p.max()), "rel_max": rel_max, "below_floor_max": small_max,
           "candidates": n, "candidates_plain": n_p, "jaccard": jaccard,
           "kernel_s": kernel_s, "plain_s": plain_s, "check_launches": launched}
    print(f"  statistic check (phase 15(c)): {json.dumps(out)}")
    return out


def check_long_run(log, state, adam, iters: int, label: str) -> None:
    """Phase 15's checks on a long run's log and final state: finite losses,
    parameters and moments; no densify candidate dropped; a training key
    drop only on an iteration followed by its raster regrow, and none at
    the end; no key dropped in the evaluations."""
    import torch

    losses = log["loss"]
    check(len(losses) == iters and all(np.isfinite(losses)),
          f"{label}: all {iters} losses finite")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values())
          and all(bool(torch.isfinite(v).all()) for v in (*adam.m.values(), *adam.v.values())),
          f"{label}: no NaN or inf in the final parameters and moments")
    check(all(r[4] == 0 for r in log["densify"]),
          f"{label}: no densify candidate dropped in {len(log['densify'])} rounds")
    drops = [i + 1 for i, d in enumerate(log["dropped_keys"]) if d]
    check(drops == [r[0] for r in log["raster_keys"]] and log["dropped_keys"][-1] == 0,
          f"{label}: training dropped keys only at iterations {drops}, each followed by "
          f"its raster regrow {log['raster_keys']}")
    check(len(log["eval_dropped_keys"]) > 0 and all(d == 0 for _, d in log["eval_dropped_keys"]),
          f"{label}: no key dropped in the evaluations {log['eval_dropped_keys']}")


def phase_long_training(args, device):
    """Phase 15: the long training runs on the densification run's scene at
    its own widths (96 views at 800x600, 200k GT Gaussians, 8k-point init):
    (a) the dataset built on the card, (b) `runs.densify_scale_run.main
    --pilot --grad_threshold 1e-4` (3,000 iterations, 25 densify rounds,
    the opacity reset at 3,000), the saved PLY re-rendered and 20 steps
    profiled at the final state, (c) the densification statistic of the
    saved PLY over all 96 views through K1-K3 against their plain versions
    on the card (`check_long_statistic`), (d) `apps.train_2dgs` for
    LONG_2DGS_ITERS iterations at its defaults. Launches of each stage are
    held against the phase's own tally."""
    import torch

    from scorp_tpu_torch.apps import train_2dgs
    from scorp_tpu_torch.core.plyio import load_gaussian_ply
    from scorp_tpu_torch.ops.raster import RasterConfig
    from scorp_tpu_torch.render import render, tuned_raster_config
    from scorp_tpu_torch.runs import densify_scale_run
    from scorp_tpu_torch.runs.convergence_run import JAX_GT_MAX_KEYS
    from scorp_tpu_torch.runs.summary import final_ply
    from scorp_tpu_torch.train import OptParams, train_step

    root = os.path.join(WORK, "long")
    scene_dir = os.path.join(root, "scene")
    iters = densify_scale_run.PILOT_ITERS
    out, launches = {}, {}
    t_phase = time.perf_counter()

    # (a) the dataset, its ground truth rendered on the card
    reset_launches()
    info = densify_scale_run.build_dataset(scene_dir, device=device)
    launches["gt"] = kernel_launches()
    n_views, renders = info["views"], info["renders"]
    check(launches["gt"] == launches_of(preprocess=renders, expand=renders, sort=renders,
                                        composite=renders)
          and renders >= n_views, f"{n_views} GT views in {renders} renders, one fused "
          "preprocess, K1, sort and K2 each")
    check(all(d == 0 for d in info["dropped_final"]),
          f"every GT image rendered with no dropped key (views dropping keys at the JAX "
          f"scripts' {JAX_GT_MAX_KEYS} key slots: "
          f"{sum(d > 0 for d in info['dropped_at_jax_capacity'])})")
    g = densify_scale_run.make_textured_gaussians()
    gt_state = info.pop("state")
    check(int(gt_state.num_alive()) == g.n and all(
        torch.equal(gt_state.params[k][:g.n].cpu(), torch.from_numpy(getattr(g, k)))
        for k in gt_state.params), f"the card's {g.n} GT gaussians are bit-equal to the "
        "CPU's make_textured_gaussians")
    del gt_state, g
    out["build_s"] = info["seconds"]
    print(f"  dataset built in {info['seconds']:.2f} s ({n_views} views at 800x600; key "
          f"slots {info['max_keys']})")

    # (b) the 3DGS pilot through the run's entry point
    reset_launches()
    summary, (scene, state, adam, log) = densify_scale_run.main(
        [root, "--pilot", "--grad_threshold", "1e-4", "--device", str(device)])
    launches["pilot"] = kernel_launches()
    n_eval = len(scene.get_test_cameras()) + 5  # evaluate's test views and 5 train views
    check(launches["pilot"] == launches_of(preprocess=n_eval, expand=iters + n_eval,
                                           sort=iters + n_eval, composite=iters + n_eval,
                                           backward=iters),
          f"the pilot launched K1, the sort and K2 once per step and evaluation render "
          f"({iters} + {n_eval}), K3 once per step and the fused preprocess once per "
          f"evaluation render: {launches['pilot']}")
    check_long_run(log, state, adam, iters, "3DGS pilot")
    rounds = log["densify"]
    check([r[0] for r in rounds] == list(range(600, iters + 1, 100)),
          f"{len(rounds)} densify rounds, every 100 iterations from 600 to {iters}")
    check(len(log["capacity"]) >= 1 and len(log["raster_keys"]) >= 1,
          f"Gaussian capacity grew {log['capacity']} and the raster key capacity "
          f"{log['raster_keys']}")
    alive = state.alive
    check(float(torch.sigmoid(state.params["opacity"][alive]).max()) <= 0.01 + 1e-6,
          f"the opacity reset at {iters} ran (every alive opacity <= 0.01)")
    check(log["sh_degree"] == [(1000, 1), (2000, 2), (3000, 3)],
          f"the SH degree stepped to 3: {log['sh_degree']}")
    check(summary["nonfinite_rows"] == dict.fromkeys(summary["nonfinite_rows"], 0),
          f"the iteration-{iters} PLY has no non-finite row ({summary['final_alive']} rows)")
    (it, res), = log["eval"]
    test_l1, test_psnr = res["test"]
    check(it == iters and test_psnr >= LONG_PSNR_3K_DB,
          f"test PSNR at {iters}: {test_psnr:.4f} dB >= {LONG_PSNR_3K_DB:.2f} dB (JAX: 23.79)")

    # the saved PLY re-rendered on the test views reproduces the logged PSNR
    reset_launches()
    ply = load_gaussian_ply(final_ply(os.path.join(root, "model"), iters))
    bg = torch.zeros(3, device=device)
    psnrs, rerender_dropped = [], 0
    with torch.no_grad():
        for cam in scene.get_test_cameras():
            r = render(cam.to_torch(device), ply, bg)
            rerender_dropped += int(r["num_dropped_keys"])
            img = np.clip(r["render"].cpu().numpy(), 0.0, 1.0)
            gt = np.clip(cam.gt(release=True).image, 0.0, 1.0)
            psnrs.append(-10.0 * np.log10(max(float(((img - gt) ** 2).mean()), 1e-12)))
    n_test = len(psnrs)
    launches["rerender"] = kernel_launches()
    check(launches["rerender"] == launches_of(preprocess=n_test, expand=n_test, sort=n_test,
                                              composite=n_test),
          f"{n_test} re-renders, one fused preprocess, K1, sort and K2 each")
    check(rerender_dropped == 0 and abs(float(np.mean(psnrs)) - test_psnr) <= 0.01,
          f"the PLY re-rendered on the {n_test} test views: PSNR {np.mean(psnrs):.4f} dB, "
          f"within 0.01 dB of the logged {test_psnr:.4f}, no key dropped")

    # LONG_PROFILED_STEPS steps at the final state: wall and device busy
    cam = scene.get_train_cameras()[0]
    gt_img = torch.as_tensor(cam.gt().image, device=device)
    h, w = gt_img.shape[1:]
    zeros = torch.zeros(1, h, w, device=device)
    cfg = (RasterConfig(max_keys=log["raster_keys"][-1][1], stream_keys=log["raster_keys"][-1][2])
           if log["raster_keys"] else tuned_raster_config(state.capacity))
    opt = OptParams(densify_grad_threshold=1e-4)
    tcam = cam.to_torch(device)

    def step():
        return train_step(state, adam, tcam, gt_img, zeros, zeros, iters, bg, opt=opt,
                          sh_degree=3, cfg=cfg)

    reset_launches()
    step_ms = cuda_ms(step, LONG_PROFILED_STEPS)
    busy_ms, top = device_profile(step, LONG_PROFILED_STEPS)
    launches["profiled"] = kernel_launches()
    n_prof = 2 * (LONG_PROFILED_STEPS + 1)
    check(launches["profiled"] == launches_of(expand=n_prof, sort=n_prof, composite=n_prof,
                                              backward=n_prof),
          f"{n_prof} profiled steps, one K1, sort, K2 and K3 each")
    print(f"  3DGS pilot: wall {summary['wall_s']:.2f} s, {1e3 * summary['wall_s'] / iters:.3f} "
          f"ms per iteration, {summary['it_per_s']:.3f} it/s; peak device memory "
          f"{summary['peak_device_mib']:.1f} MiB; test L1 {test_l1:.5f}, PSNR {test_psnr:.4f}; "
          f"train PSNR {res['train'][1]:.4f}; final {summary['final_alive']}, peak "
          f"{summary['peak_alive']} alive")
    print(f"  densify rounds (iteration, alive before, candidates, alive after, dropped): "
          f"{json.dumps(rounds)}")
    if top:
        print(f"  at the final state ({int(state.num_alive())} alive, capacity {state.capacity}): "
              f"train_step {step_ms:.3f} ms (CUDA-event median of {LONG_PROFILED_STEPS}), "
              f"device busy {busy_ms:.3f} ms -> busy share {busy_ms / step_ms:.3f}")
    else:
        print("  device busy per step: not measured (the trace held no CUDA events)")
    out["pilot"] = {k: summary[k] for k in (
        "wall_s", "it_per_s", "final_alive", "peak_alive", "capacity_growths",
        "raster_regrows", "dropped_keys_train", "dropped_keys_eval", "peak_device_mib")}
    out["pilot"].update(test_psnr=test_psnr, train_psnr=res["train"][1],
                        ms_per_iter=1e3 * summary["wall_s"] / iters, step_ms=step_ms,
                        busy_ms=busy_ms if top else None, rerender_psnr=float(np.mean(psnrs)))

    # (c) the densification statistic of the saved state over every view,
    # through the kernels and through their plain versions (not a main-path
    # stage: its launches are the check's own)
    out["statistic"] = check_long_statistic(
        ply, scene.get_train_cameras() + scene.get_test_cameras(), iters, cfg, device)
    del scene, state, adam, log, ply
    torch.cuda.empty_cache()

    # (d) 2DGS at the app's defaults on the same scene
    iters2d = LONG_2DGS_ITERS
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene, state, adam, log = train_2dgs.main(
        ["-s", scene_dir, "-m", os.path.join(root, "model2d"), "--eval", "--split_yml_name",
         "split.yml", "--iterations", str(iters2d), "--test_iterations", str(iters2d),
         "--save_iterations", str(iters2d), "--quiet", "--device", str(device)])
    torch.cuda.synchronize()
    wall2d = time.perf_counter() - t0
    launches["2dgs"] = kernel_launches()
    check(launches["2dgs"] == launches_of(
        expand=iters2d + n_eval, sort=iters2d + n_eval, surfel_composite=n_eval,
        surfel_composite_train=iters2d, surfel_backward=iters2d),
          f"2DGS: K1 and the sort once per step and evaluation render ({iters2d} + {n_eval}), "
          f"K5 and K6 once per step, K4 once per evaluation render: {launches['2dgs']}")
    check_long_run(log, state, adam, iters2d, "2DGS")
    (_, res2d), = log["eval"]
    print(f"  2DGS: wall {wall2d:.2f} s, {1e3 * wall2d / iters2d:.3f} ms per iteration; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; test PSNR "
          f"{res2d['test'][1]:.4f}, train PSNR {res2d['train'][1]:.4f}; "
          f"{int(state.num_alive())} alive; capacity {log['capacity']}; raster regrows "
          f"{log['raster_keys']}")
    print(f"  2DGS densify rounds (iteration, alive before, candidates, alive after, "
          f"dropped): {json.dumps(log['densify'])}")
    out["2dgs"] = {"wall_s": wall2d, "ms_per_iter": 1e3 * wall2d / iters2d,
                   "test_psnr": res2d["test"][1], "densify": log["densify"],
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    del scene, state, adam, log
    for name in ("model", "model2d"):  # the scene stays for phase 16
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase wall {out['wall_s']:.2f} s")
    return launches, out


NAN_HUNT_ITERS = 700  # phase 16(a): the clean hunt, through the densify rounds at 600 and 700
NAN_PLANT_AFTER = 649  # phase 16(b): the fault is planted in the state step 649 returns
NAN_CLEAN_DUMP_AT = 640  # phase 16(c): the clean step whose inputs are dumped and replayed
NAN_FIRST_DENSIFY = 600  # the trainer's first densify round (after 500, every 100)


@contextlib.contextmanager
def step_clock(module):
    """Wrap `module.train_step` to record the host clock at the start of
    each step; yields the list. (last - first) / (len - 1) is a loop's time
    per iteration, everything between two steps included and its set-up
    excluded."""
    step, starts = module.train_step, []

    def timed(*a, **k):
        starts.append(time.perf_counter())
        return step(*a, **k)

    module.train_step = timed
    try:
        yield starts
    finally:
        module.train_step = step


def per_iteration_ms(starts: list) -> float:
    return 1e3 * (starts[-1] - starts[0]) / (len(starts) - 1)


def replay_lines(text: str) -> list[str]:
    """The near-degeneracy report of a nan_replay run's output: the lines
    before it re-runs the step."""
    lines = text.splitlines()
    return lines[:next(i for i, line in enumerate(lines) if line.startswith("re-running"))]


def phase_nan_hunt(args, device, scene_dir: str, pilot_ms: float):
    """Phase 16: `runs.nan_hunt` and `runs.nan_replay` on phase 15's scene:
    (a) `apps.train_3dgs` and then a clean hunt, each for NAN_HUNT_ITERS
    iterations at the app's defaults (the hunt's cost per iteration is the
    difference of the two loops'), (b) a hunt with a fault
    planted in the state that step NAN_PLANT_AFTER returns (the DC colour
    of every alive row set to 1e30: the render stays finite, the SSIM's
    second moments overflow, so the next step's loss is NaN), found,
    rewound to the ring's older snapshot, replayed and dumped, (c) the
    fault's dump replayed on the card and on the CPU, and the clean inputs
    of step NAN_CLEAN_DUMP_AT (dumped by the same wrapper) replayed as one
    step on both, the card's kernels held to the CPU's plain versions."""
    import io

    import torch

    from scorp_tpu_torch.apps import train_3dgs
    from scorp_tpu_torch.runs import nan_hunt, nan_replay

    root = os.path.join(WORK, "nan")
    out, launches = {}, {}
    t_phase = time.perf_counter()

    def outdir(name: str) -> str:
        d = os.path.join(root, name)
        os.makedirs(d)
        os.symlink(os.path.abspath(scene_dir), os.path.join(d, "scene"))
        return d

    def faults(d: str) -> list[str]:
        return sorted(f for f in os.listdir(d) if f.startswith("fault_"))

    # (a) the trainer alone, then a clean hunt, on the same scene and settings
    iters = NAN_HUNT_ITERS
    reset_launches()
    with step_clock(train_3dgs) as trainer_starts:
        train_3dgs.main(["-s", scene_dir, "-m", os.path.join(root, "trainer"), "--eval",
                         "--split_yml_name", "split.yml", "--iterations", str(iters), "--quiet",
                         "--test_iterations", str(iters + 1), "--device", str(device)])
    torch.cuda.synchronize()
    launches["trainer"] = kernel_launches()
    check(launches["trainer"] == launches_of(expand=iters, sort=iters, composite=iters,
                                             backward=iters),
          f"the trainer launched K1, the sort, K2 and K3 once per step: {launches['trainer']}")
    clean_dir = outdir("clean")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with step_clock(nan_hunt) as hunt_starts:
        res = nan_hunt.main([clean_dir, "--iters", str(iters), "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["clean"] = kernel_launches()
    check(res["fault"] is None and res["dump"] is None and not faults(clean_dir),
          f"the clean hunt found no fault in {iters} iterations and wrote no dump")
    check(len(res["losses"]) == iters and all(np.isfinite(res["losses"])),
          f"all {iters} losses finite")
    check(launches["clean"] == launches_of(expand=iters, sort=iters, composite=iters,
                                           backward=iters),
          f"the clean hunt launched K1, the sort, K2 and K3 once per step: {launches['clean']}")
    first = NAN_FIRST_DENSIFY
    check(res["alive"][first] != res["alive"][first - 1],
          f"the densify round at {first} ran: alive {res['alive'][first - 1]} -> "
          f"{res['alive'][first]}")
    hunt_ms, trainer_ms = per_iteration_ms(hunt_starts), per_iteration_ms(trainer_starts)
    out["clean"] = {"ms_per_iter": hunt_ms, "trainer_ms_per_iter": trainer_ms,
                    "wall_ms_per_iter": 1e3 * wall / iters, "pilot_ms_per_iter": pilot_ms,
                    "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                    "alive": [res["alive"][i - 1] for i in (1, first, first + 1, iters)]}
    print(f"  (a) {iters} iterations: the hunt {hunt_ms:.3f} ms per iteration, the trainer on "
          f"the same scene and settings {trainer_ms:.3f} (the hunt's read and "
          f"{nan_hunt.SNAP}-step checks: {hunt_ms - trainer_ms:+.3f} ms); the hunt through its "
          f"entry point {out['clean']['wall_ms_per_iter']:.3f}; phase 15's pilot "
          f"{pilot_ms:.3f} (--grad_threshold 1e-4, with evaluations); peak device memory "
          f"{out['clean']['peak_mib']:.1f} MiB; alive at 1, {first}, {first + 1}, {iters}: "
          f"{out['clean']['alive']}")

    # (b) a planted fault, found, rewound, replayed and dumped
    plant_dir = outdir("plant")
    clean_path = os.path.join(root, f"clean_iter{NAN_CLEAN_DUMP_AT}.npz")
    step = nan_hunt.train_step
    tally = {"steps": 0, "planted": 0}

    def planted(*a, **k):
        it = a[6]
        tally["steps"] += 1
        if it == NAN_CLEAN_DUMP_AT and not os.path.exists(clean_path):
            nan_hunt.dump_step_inputs(clean_path, a[0], a[1], a[2], a[7], it, k["sh_degree"],
                                      a[3])
        state, adam, metrics = step(*a, **k)
        if it == NAN_PLANT_AFTER:
            tally["planted"] += 1
            p = dict(state.params)
            p["f_dc"] = torch.where(state.alive[:, None, None], 1e30, p["f_dc"])
            state = state._replace(params=p)
        return state, adam, metrics

    nan_hunt.train_step = planted
    reset_launches()
    try:
        t0 = time.perf_counter()
        res = nan_hunt.main([plant_dir, "--iters", str(iters), "--device", str(device)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        nan_hunt.train_step = step
    launches["plant"] = kernel_launches()
    fault_it = NAN_PLANT_AFTER + 1
    snap = (fault_it // nan_hunt.SNAP - 1) * nan_hunt.SNAP  # the ring's older snapshot
    dump = os.path.join(plant_dir, f"fault_iter{fault_it}.npz")
    check(res["fault"] in (fault_it, -(-fault_it // nan_hunt.SNAP) * nan_hunt.SNAP),
          f"the planted fault found at {res['fault']} (bad={res['bad']})")
    check(res["snapshot"] == snap and res["dump"] == dump and faults(plant_dir) ==
          [os.path.basename(dump)] and tally["planted"] == 2,
          f"rewound to the snapshot at {res['snapshot']}, replayed (the fault planted again) "
          f"and dumped {res['dump']}")
    check(launches["plant"] == launches_of(expand=tally["steps"], sort=tally["steps"],
                                           composite=tally["steps"], backward=tally["steps"]),
          f"K1, the sort, K2 and K3 once per step of both passes ({tally['steps']}): "
          f"{launches['plant']}")
    z = np.load(dump)
    alive = z["alive"]
    check(all(np.isfinite(z[k]).all() for k in z.files) and (z["param.f_dc"][alive] == 1e30).all(),
          "the dump is finite and holds the planted colours of every alive row")
    rel = max(abs(res["replay_losses"][i] - res["losses"][i - 1]) / abs(res["losses"][i - 1])
              for i in range(snap + 1, fault_it))
    check(rel <= 1e-4, f"the replayed losses at {snap + 1}-{fault_it - 1} within 1e-4 relative "
          f"of the first pass's (largest {rel:.3g}; only K3's atomics differ)")
    out["plant"] = {"fault": res["fault"], "bad": res["bad"], "snapshot": res["snapshot"],
                    "dump": os.path.basename(dump), "steps": tally["steps"],
                    "replay_loss_rel": rel, "wall_s": wall}
    print(f"  (b) planted after step {NAN_PLANT_AFTER}: found at {res['fault']}, rewound to "
          f"{res['snapshot']}, {tally['steps']} steps in {wall:.2f} s; replayed losses within "
          f"{rel:.3g} relative of the first pass's; dumped {os.path.basename(dump)}")

    # (c) the dumps replayed on the card's kernels and on the CPU's plain versions
    verdicts = {}
    for dev in (str(device), "cpu"):
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            r = nan_replay.main([dump, "--device", dev])
        verdicts[dev] = (r, replay_lines(buf.getvalue()), time.perf_counter() - t0)
        if dev == str(device):
            launches["replay"] = kernel_launches()
        print("\n".join(f"    {dev}: {line}" for line in buf.getvalue().splitlines()
                        if "post-step" not in line))
    (rc, lc, tc), (rp, lp, tp) = verdicts[str(device)], verdicts["cpu"]
    check(rc["stage"] == rp["stage"] == "loss",
          f"the fault's step non-finite on both paths, first at the same stage, the loss: "
          f"card {rc['stage']}, CPU {rp['stage']}")
    check(launches["replay"] == launches_of(preprocess=1, expand=3, sort=3, composite=3,
                                            backward=1),
          f"the card's replay launched K1, the sort and K2 three times (the forward alone, the "
          f"step, the step under anomaly detection), K3 once (the anomaly pass stops in the "
          f"SSIM's backward) and the fused preprocess once (the forward alone, under no_grad): "
          f"{launches['replay']}")
    check(lc == lp and len(lc) >= 5, "both paths print the same near-degeneracy report")
    out["replay_fault"] = {"stage": rc["stage"], "card_s": tc, "cpu_s": tp}
    clean = []
    for dev in (str(device), "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            inputs = nan_replay.load(clean_path, dev)
            clean.append(nan_replay.replay(*inputs))
    rc, rp = clean
    check(rc["stage"] is None and rp["stage"] is None,
          f"the clean step at {NAN_CLEAN_DUMP_AT} finite on both paths")
    loss_rel = abs(rc["loss"] - rp["loss"]) / abs(rp["loss"])
    check(loss_rel <= 1e-5, f"the clean step's loss on the card {rc['loss']:.8f} within 1e-5 "
          f"relative of the CPU's {rp['loss']:.8f} ({loss_rel:.3g})")

    def columns(r):
        st, ad = r["state"], r["adam"]
        cols = {k: v.cpu() for k, v in st.params.items()}
        cols.update({f"adam_m.{k}": v.cpu() for k, v in ad.m.items()})
        cols.update({f"adam_v.{k}": v.cpu() for k, v in ad.v.items()})
        return cols

    worst = check_columns(columns(rc), columns(rp),
                          f"the clean step at {NAN_CLEAN_DUMP_AT}, card vs CPU")
    st, ad = inputs[:2]  # the CPU's copy of the clean inputs: a snapshot's tensors
    out["replay_clean"] = {"loss_rel": loss_rel, "worst_column": worst,
                           "card_s": rc["seconds"], "cpu_s": rp["seconds"],
                           "capacity": st.capacity, "alive": int(st.alive.sum()),
                           "snapshot_bytes": sum(t.numel() * t.element_size() for t in (
                               *st.params.values(), *st[1:], *ad.m.values(), *ad.v.values()))}
    print(f"  (c) replays: the fault's step {out['replay_fault']['card_s']:.2f} s on the card, "
          f"{out['replay_fault']['cpu_s']:.2f} s on the CPU; the clean step "
          f"{rc['seconds']:.3f} s on the card, {rp['seconds']:.2f} s on the CPU "
          f"({out['replay_clean']['alive']} alive, capacity {out['replay_clean']['capacity']}; "
          f"a snapshot then holds {out['replay_clean']['snapshot_bytes']} bytes)")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase wall {out['wall_s']:.2f} s")
    return launches, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=250_000)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1066)
    ap.add_argument("--mid_n", type=int, default=50_000)
    ap.add_argument("--mid_width", type=int, default=800)
    ap.add_argument("--mid_height", type=int, default=600)
    ap.add_argument("--train_iters", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to test",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import scorp_tpu_torch  # noqa: F401  (fails when run outside the repository)
    from scorp_tpu_torch.ops.raster import _build
    from scorp_tpu_torch.ops.raster.backward import REPLACES as K3_REPLACES
    from scorp_tpu_torch.ops.raster.backward import SOURCE as K3_SOURCE
    from scorp_tpu_torch.ops.raster.composite import REPLACES as K2_REPLACES
    from scorp_tpu_torch.ops.raster.composite import SOURCE as K2_SOURCE
    from scorp_tpu_torch.ops.raster.expand import REPLACES as K1_REPLACES
    from scorp_tpu_torch.ops.raster.expand import SOURCE as K1_SOURCE
    from scorp_tpu_torch.ops.raster.fused_preprocess import REPLACES as P_REPLACES
    from scorp_tpu_torch.ops.raster.fused_preprocess import SOURCE as P_SOURCE
    from scorp_tpu_torch.ops.raster.surfel_backward import REPLACES as K6_REPLACES
    from scorp_tpu_torch.ops.raster.surfel_backward import SOURCE as K6_SOURCE
    from scorp_tpu_torch.ops.raster.surfel_composite import REPLACES as K4_REPLACES
    from scorp_tpu_torch.ops.raster.surfel_composite import REPLACES_TRAIN as K5_REPLACES
    from scorp_tpu_torch.ops.raster.surfel_composite import SOURCE as SK_SOURCE

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print("[1] setup")
    card = gpu_line()
    print(f"  gpu: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"  built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name in _build.SIGNATURES:  # nvcc's report, kept beside each library
        text = _build.library_path(name).with_suffix(".log").read_text()
        lines = list(ptxas_lines(text))
        if name == "sort":  # CUB's kernels: their count and the worst spill
            spills = [int(m) for _, line in lines for m in re.findall(r"(\d+) bytes spill", line)]
            print(f"  sort: {sum('registers' in line for _, line in lines)} CUB kernels, "
                  f"largest spill {max(spills, default=0)} bytes")
            continue
        for kernel, line in lines:
            print(f"  {name}: {kernel}: {line}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    print(f"[2] full width: {args.n} gaussians, {args.width}x{args.height}, render_3dgs")
    scene_dir, model_dir, launches, _ = phase_full_width(args, device)
    keep_for_metrics(scene_dir, model_dir)

    print(f"[3] kernels vs plain versions at {args.mid_n} / {args.mid_width}x{args.mid_height}")
    k1_err, k2_err = phase_parity_mid(args, device)
    phase_small_reference(args, device)

    print("[4] full-width kernel checks and times")
    full = phase_full_kernels(args, device, scene_dir, model_dir)
    k1_err = max(k1_err, full["k1"]["err"])
    k2_err = max(k2_err, full["k2"]["err"])
    torch.cuda.empty_cache()

    print(f"[5] K3 vs its plain version at {args.mid_n} / {args.mid_width}x{args.mid_height}; "
          "rasterize backward GPU vs CPU")
    k3_err = phase_backward_parity(args, device)

    print(f"[6] training: {args.n} points, {args.width}x{args.height}, train_3dgs, "
          f"{args.train_iters} iterations")
    train_launches, train = phase_train_app(args, device, scene_dir)
    torch.cuda.empty_cache()

    print(f"[7] train_step at full width: {args.n} gaussians, {args.width}x{args.height}")
    step = phase_train_step(args, device)
    k3_err = max(k3_err, step["k3"]["err"])
    k2_err = max(k2_err, step["k2_err"])
    torch.cuda.empty_cache()

    print(f"[8] 2DGS eval at full width: {args.n} surfels, {args.width}x{args.height}, "
          "render_2dgs; K1 with its second ellipse and K4 vs their plain versions")
    launches2d, eval2d = phase_surfel_eval(args, device, scene_dir)
    k1_err = max(k1_err, eval2d["k1_err"])
    torch.cuda.empty_cache()

    print(f"[9] K5 and K6 vs their plain versions at {args.mid_n} / "
          f"{args.mid_width}x{args.mid_height}; rasterize_surfel backward GPU vs CPU")
    k5_err, k6_err = phase_surfel_parity(args, device)
    torch.cuda.empty_cache()

    print(f"[10] 2DGS training: {args.n} points, {args.width}x{args.height}, train_2dgs, "
          f"{args.train_iters} iterations; train_step_2d at full width")
    train2d_launches, train2d = phase_surfel_train_app(args, device, scene_dir)
    torch.cuda.empty_cache()
    step2d = phase_surfel_train_step(args, device)
    k5_err = max(k5_err, step2d["k5"]["err"])
    k6_err = tuple(max(a, b) for a, b in zip(k6_err, step2d["k6"]["err"]))
    shutil.rmtree(WORK, ignore_errors=True)
    torch.cuda.empty_cache()

    print("[11] host synchronisations of one render() and one train_step "
          "(torch.cuda.set_sync_debug_mode)")
    check(host_syncs(lambda: int(torch.ones(1, device=device).sum())) >= 1,
          "the count sees the synchronisation of one int() of a CUDA tensor")
    syncs = host_sync_counts(args, device)
    print(f"  host synchronisations: {json.dumps(syncs)} (each rasterization's one read of "
          "its expanded-key count included)")
    torch.cuda.empty_cache()

    print(f"[12] SCORP object path at full width: {args.n} gaussians, {SCORP_VIEWS} views at "
          f"{args.width}x{args.height}: segmentation_3dgs, view_selection, align, "
          "post_refine_gs, render_3dgs")
    scorp_launches, scorp = phase_scorp(args, device)
    print(f"  SCORP: {json.dumps(scorp)}")
    torch.cuda.empty_cache()

    print(f"[13] 2DGS object path and mesh at full width: {args.n} surfels, {SCORP_VIEWS} views "
          f"at {args.width}x{args.height}: segmentation_2dgs, view_selection, trellis_img2gs, "
          "truncate_opacity, align_2dgs, extract_mesh")
    scorp2d_launches, mesh_launches, scorp2d = phase_scorp2d(args, device)
    print(f"  SCORP 2DGS: {json.dumps(scorp2d)}")
    torch.cuda.empty_cache()

    print(f"[14] scale-out and the render consumers at full width: {args.n} gaussians, "
          f"{SCORP_VIEWS} views at {args.width}x{args.height}: dp_train_step and "
          f"dp_train_step_2d (B={DP_BATCH}, one-rank NCCL group), dp_render, the ellipse path "
          "and its videos, metrics, the viewer, segmentation_2d")
    dp_launches, dp = phase_dp(args, device)
    print(f"  scale-out: {json.dumps(dp)}")
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.rmtree(METRICS, ignore_errors=True)
    torch.cuda.empty_cache()

    print("[15] long training on the densification run's scene (96 views at 800x600, 200k GT "
          "gaussians, 8k-point init): the dataset on the card, the 3DGS pilot through "
          "runs.densify_scale_run (3,000 iterations, --grad_threshold 1e-4), 2DGS through "
          f"train_2dgs ({LONG_2DGS_ITERS} iterations)")
    long_launches, long_run = phase_long_training(args, device)
    print(f"  long training: {json.dumps(long_run)}")
    torch.cuda.empty_cache()

    print(f"[16] the NaN hunt and its replay on phase 15's scene: runs.nan_hunt clean "
          f"({NAN_HUNT_ITERS} iterations) and with a fault planted after step {NAN_PLANT_AFTER}; "
          "runs.nan_replay of the fault's and a clean step's dumps on the card and the CPU")
    nan_launches, nan = phase_nan_hunt(args, device, os.path.join(WORK, "long", "scene"),
                                       long_run["pilot"]["ms_per_iter"])
    print(f"  NaN hunt: {json.dumps(nan)}")
    shutil.rmtree(WORK, ignore_errors=True)

    def long(key):
        return {stage: n[key] for stage, n in long_launches.items()}

    def nan_stages(key):
        return {stage: n[key] for stage, n in nan_launches.items()}

    def timed(d):
        return {k: d[k] for k in ("ms", "ms_per_call", "plain_ms", "bound_ms", "bound_by")}

    kernels = [
        {"name": "P fused preprocess", "route": "cuda", "source": P_SOURCE,
         "replaces": P_REPLACES, "launches": launches["preprocess"],
         "launches_train_evals": train_launches["preprocess"],
         "max_abs_err": full["preprocess"]["err"], **timed(full["preprocess"]),
         "library_ms": None, "rows": full["preprocess"]["rows"],
         "launches_scorp": scorp_launches["preprocess"],
         "launches_scorp2d": scorp2d_launches["preprocess"],
         "launches_dp": dp_launches["preprocess"],
         "launches_dp_checks": dp["check_launches"]["preprocess"],
         "launches_long": long("preprocess"), "launches_nan": nan_stages("preprocess")},
        {"name": "K1 expand_keys", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": train_launches["expand"],
         "launches_eval": launches["expand"], "launches_2dgs": train2d_launches["expand"],
         "launches_2dgs_eval": launches2d["expand"],
         "max_abs_err": k1_err, "max_abs_diff": k1_err, **timed(full["k1"]),
         "library_ms": full["k1"]["library_ms"], "library_call": "torch.sort of the keys",
         "sort_launches": train_launches["sort"],
         "key_bits": full["k1"]["key_bits"], "key_bits_train_step": step["key_bits"],
         "end_bit": full["k1"]["end_bit"], "sort_ms": full["k1"]["sort_ms"],
         "sort_radix_ms": full["k1"]["sort_radix_ms"],
         "sort_int64_torch_ms": full["k1"]["sort_int64_torch_ms"],
         "bound_ms_int64_keys": full["k1"]["bound_ms_int64_keys"],
         "kept": full["k1"]["kept"], "kept_golden": full["k1"]["golden"],
         "launches_scorp": scorp_launches["expand"],
         "launches_scorp2d": scorp2d_launches["expand"], "launches_mesh": mesh_launches["expand"],
         "launches_dp": dp_launches["expand"], "sort_launches_dp": dp_launches["sort"],
         "launches_dp_checks": dp["check_launches"]["expand"],
         "launches_long": long("expand"), "launches_nan": nan_stages("expand"),
         "sort_launches_nan": nan_stages("sort")},
        {"name": "K2 composite", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": train_launches["composite"],
         "launches_eval": launches["composite"],
         "max_abs_err": k2_err, "max_abs_diff": k2_err, **timed(full["k2"]),
         "ms_train": step["k2_train_ms"], "library_ms": None,
         "slots": full["k2"]["slots"], "slots_train": step["k2_slots"],
         "launches_scorp": scorp_launches["composite"],
         "launches_scorp2d": scorp2d_launches["composite"],
         "launches_dp": dp_launches["composite"],
         "launches_dp_checks": dp["check_launches"]["composite"],
         "launches_long": long("composite"), "launches_nan": nan_stages("composite")},
        {"name": "K3 composite_backward", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": train_launches["backward"],
         "max_abs_err": k3_err, **timed(step["k3"]),
         "library_ms": None, "slots": step["k3"]["slots"], "atomics": step["k3"]["atomics"],
         "launches_scorp": scorp_launches["backward"],
         "launches_dp": dp_launches["backward"],
         "launches_dp_checks": dp["check_launches"]["backward"],
         "launches_long": long("backward"), "launches_nan": nan_stages("backward")},
        {"name": "K4 surfel_composite", "route": "cuda", "source": SK_SOURCE,
         "replaces": K4_REPLACES, "launches": launches2d["surfel_composite"],
         "launches_2dgs_train_evals": train2d_launches["surfel_composite"],
         "max_abs_err": eval2d["k4"]["err"], **timed(eval2d["k4"]), "library_ms": None,
         "launches_scorp2d": scorp2d_launches["surfel_composite"],
         "launches_mesh": mesh_launches["surfel_composite"],
         "launches_dp": dp_launches["surfel_composite"],
         "launches_dp_checks": dp["check_launches"]["surfel_composite"],
         "launches_long": long("surfel_composite")},
        {"name": "K5 surfel_composite_train", "route": "cuda", "source": SK_SOURCE,
         "replaces": K5_REPLACES, "launches": train2d_launches["surfel_composite_train"],
         "max_abs_err": k5_err, **timed(step2d["k5"]), "library_ms": None,
         "slots": step2d["slots"]["K5"],
         "launches_scorp2d": scorp2d_launches["surfel_composite_train"],
         "launches_dp": dp_launches["surfel_composite_train"],
         "launches_dp_checks": dp["check_launches"]["surfel_composite_train"],
         "launches_long": long("surfel_composite_train")},
        {"name": "K6 surfel_backward", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_REPLACES, "launches": train2d_launches["surfel_backward"],
         "max_abs_err": k6_err[0], "max_rel_err_per_column": k6_err[1],
         **timed(step2d["k6"]), "library_ms": None,
         "slots": step2d["slots"]["K6"],
         "launches_scorp2d": scorp2d_launches["surfel_backward"],
         "launches_dp": dp_launches["surfel_backward"],
         "launches_dp_checks": dp["check_launches"]["surfel_backward"],
         "launches_long": long("surfel_backward")},
    ]
    print(f"  training app: loss {train['loss_first']:.6f} -> {train['loss_last']:.6f}, "
          f"{train['wall_s']:.2f} s; train_step {step['step_ms']:.3f} ms")
    print(f"  2DGS training app: loss {train2d['loss_first']:.6f} -> "
          f"{train2d['loss_last']:.6f}, {train2d['wall_s']:.2f} s; train_step_2d "
          f"{step2d['step_ms']:.3f} ms; 2DGS frame {eval2d['frame_ms']:.3f} ms")
    print(f"  total {time.perf_counter() - t_start:.1f} s; frame {full['frame_ms']:.3f} ms")
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
