"""scorp_tpu_torch — the PyTorch/CUDA port of scorp_tpu for NVIDIA Hopper.

A second package beside `scorp_tpu` (the JAX/Pallas reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel of the reference
becomes a kernel written by hand in CUDA C++ for `sm_90a` (`csrc/`), built at
first use by `ops/raster/_build.py` and bound with ctypes. Each kernel keeps a
plain PyTorch version beside it: the wrapper runs that version only for CPU
tensors, and launches the kernel (or raises) for CUDA tensors.

Ported:
  core/      SH, quaternions, camera matrices, PLY codec, COLMAP parsing
  config.py  ModelParams / PipelineParams / OptimizationParams, cfg_args merge
  scene/     host cameras with lazy ground truth, dataset readers, Scene
  ops/raster the 3DGS and 2DGS surfel rasterizers and their kernels K1-K6
  ops/       losses, KNN, LPIPS and its proxy, image ops
  train/     the padded Gaussian store, Adam, the 3DGS and 2DGS training
             steps, densification, the SCORP refinement step
  parallel/  camera-batch data-parallel training and camera-parallel eval on
             torch.distributed (NCCL on the card, gloo on the CPU)
  pipeline/  SCORP: mask lifting (3DGS and surfel votes), view scoring, ICP,
             pose solvers, matchers; TSDF fusion and marching cubes; the
             perception adapters (offline backends); novel-view paths
  viewer/    the SIBR network viewer bridge
  render.py, render2d.py, assets.py, utils/ (progress, safe_state)
  apps/      render_3dgs, train_3dgs, render_2dgs, train_2dgs,
             segmentation_2d, segmentation_3dgs, segmentation_2dgs,
             view_selection, trellis_img2gs (precomputed proxies),
             truncate_opacity, align_3dgs_clpe_9dof, align_2dgs_clpe_9dof,
             post_refine_gs, extract_mesh, metrics

What waits for checkpoints the repository lacks raises, as in the JAX
package: the GroundingDINO/SAM2 and MASt3R backends and live TRELLIS.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU they raise rather than fall back to the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# f32-exact matmuls and convolutions, mirroring scorp_tpu's package-wide
# "highest" matmul precision: the reference is f32 CUDA torch, and TF32 keeps
# only ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
