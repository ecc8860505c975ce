"""The program's spans on torch.profiler's timeline.

`span(name)` opens a `torch.profiler.record_function` range while a
profiler records (the trainer's `--profile`, a traced benchmark run) and
returns one shared no-op context at all other times, so an untraced call
costs one test of the profiler's flag and dispatches nothing. A thread
that the profiler was not started on records nothing.

On a CUDA device each range also gets a footprint on the device's
timeline. CUPTI ties a kernel to the innermost range open on the thread
that launched it, so a range's footprint runs from the first to the last
kernel launched inside it and outside its children: a parent's device time
holds a child's only where the parent's own kernels come before and after
it (`raster.route`'s first device work is its `depth_order` child, and
`step.forward`'s last is `step.loss`). Autograd launches the backward's
kernels from its own thread, where only `raster.backward` is open, so
`step.backward` has almost no footprint: its device time is what lies
between `step.loss` and `step.update`.

The spans, one name per stage for 3DGS and 2DGS alike; a dot nests:

  render                       render.render, render2d.render2d: a frame
  raster.preprocess            preprocess / preprocess_surfel (+ surfel_table)
  raster.route                 routing: expansion inputs, K1, sort, tile ranges
  raster.route.depth_order     the stable depth argsort
  raster.route.expand          K1 (or its plain version)
  raster.route.sort            the keys-only sort
  raster.gather                the table's rows gathered by the stream's gid
                               (a 3DGS frame builds its table here)
  raster.composite             K2 / K4 / K5
  raster.backward              K3 / K6 and d_bg, from autograd's backward
  step.forward                 a training step's rasterize and loss
  step.loss                    L1 + SSIM and the depth, normal, distortion terms
  step.backward                torch.autograd.grad
  step.update                  densification statistics and Adam
  densify.round                a densification round's grow, prune, clone, split
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named `name` while a profiler records, else a no-op."""
    return record_function(name) if _recording() else _OFF
