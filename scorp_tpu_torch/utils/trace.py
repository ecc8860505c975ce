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
between `step.loss` and `step.update`. The ranges and CUPTI's device
records share the profiler's clock, so an idle stretch of the device lines
up with the range open on the host at that time.

The spans, one name per stage for 3DGS and 2DGS alike; a dot nests:

  render                       render.render, render2d.render2d: a frame
  render.surfel_maps           render2d's surfel_maps: the world normal, the
                               depth mix and depth_to_normal of a frame
  raster.preprocess            the fused preprocess P / the fused surfel
                               preprocess S (eval path; S also writes the
                               [N, 21] table and K1's two ellipses), or
                               preprocess / preprocess_surfel + surfel_table
                               (grad path)
  raster.surfel_cull           rasterize_surfel's grad path only:
                               surfel_cull_ellipses, K1's two screen
                               ellipses per surfel
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
  mesh.fuse                    pipeline/mesh.py TsdfVolume.integrate: one view's
                               TSDF update of the grid (kernel T on the card)
  mesh.triangulate             TsdfVolume.triangulate: the grid's mesh (kernel M
                               and its read of the totals on the card; the host
                               functions elsewhere)
  mesh.to_host                 TsdfVolume.triangulate on the card: the mesh's
                               copy to host memory

The `sync.*` family names each place where the host waits for the device
on the render, fusion and triangulation paths. A `sync.*` span is a leaf
named by its site, not by its parent: it nests inside whatever span is
open and encloses only the statement that makes the host wait. It opens
on every device, so a CPU run sees every site it passes; on the card the
host waits there, and the span's host time is the wait (its count, the
number of waits). Kernels launched inside it, if any, are tied to it.

  sync.bg_upload               render, render2d: the background's upload, a
                               pageable host-to-device copy that synchronises
                               the stream (the viewer's numpy background; a
                               background already on the device passes
                               through without a wait)
  sync.route_total             ops/raster/expand.py expand_inputs: the read of
                               the frame's key total that sizes K1's buffer;
                               it waits for the depth order, the rect gather
                               and the key scan
  sync.camera_inverse          ops/raster/surfel.py depth_to_normal:
                               torch.linalg.inv of the view matrix, whose
                               error check reads its info to the host (its
                               LU kernels are tied to this span)
  sync.mc_totals               ops/marching_cubes.py: the read of M's totals
                               after its count pass
  sync.mesh_copy               TsdfVolume.triangulate on the card: the wait
                               for the mesh's enqueued copies to host memory

Counters beside the spans (host ints, summed over calls):
`pipeline/mesh.py` `vertices` and `faces`, the meshes `triangulate` made;
each kernel wrapper's `.launches`.
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
