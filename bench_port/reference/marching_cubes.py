"""Plain marching cubes of a TSDF grid (plain PyTorch; nothing of the
program), in the order and arithmetic of
configs/mipnerf360-room-2dgs-mesh1024-export.json's `triangulate`:

- corner (x, y, z) of an NX x NY x NZ grid sits at flat index
  (x NY + y) NZ + z; it is observed where weight > 0 and inside where not
  tsdf > 0; a cell's corner k sits at (k & 1, (k >> 1) & 1, k >> 2) from
  its base, and its case has bit k set where corner k is inside; a cell is
  active where its 8 corners are observed and its case is neither 0 nor 255;
- edge e = 4 a + i joins the i-th corner of the cell without bit a to that
  corner with bit a; a crossed edge (its corners differ) of an active cell
  carries a vertex at t = clip(v0 / (v0 - v1), 0, 1) (0.5 where |v0 - v1| <
  1e-30) from its base corner, colour c0 (1 - t) + c1 t, in float64;
- the case table comes from the surface's trace on the cube's faces: on
  each face, walked counter-clockwise seen from outside, a crossing left
  from an inside corner starts a segment that ends at the next crossing
  entered from outside; the segments chain into loops, taken in the order
  a Python set of their first edges (filled face by face, axis-major, low
  side first) pops them, each from the edge popped; a loop of 3 is the
  triangle (l0, l2, l1),
  a longer one the fan (c, l[i + 1], l[i]) around its centroid c, the mean
  of its edge vertices (their sum taken edge 0 to 11, masked);
- vertices: edge vertices by ascending key ((gx NY + gy) NZ + gz) 3 + axis
  of the edge's base corner, then the centroids by cell (C order) and loop;
  faces by cell, then table order;
- world: (p + 0.5) voxel + origin per axis, then for a contracted grid
  q where |q| <= 1, else q / (s (2 - s)) with s = |q| clipped to [1e-9,
  2 - 1e-6], |q| = sqrt((x^2 + y^2) + z^2), times the radius plus the centre.

The grid is read a slab of cell planes at a time on its own device. The
control computes t in float32.
"""

from __future__ import annotations

import math

import torch

from .tsdf import _sqrt

# cells a slab holds: ~100 B of temporaries a cell
SLAB_CELLS = 1 << 24
MAX_TRIS, MAX_LOOPS = 8, 4


def _corner(k: int) -> tuple:
    return (k & 1, (k >> 1) & 1, (k >> 2) & 1)


def _edges() -> list:
    """[(corner a, corner b)] by edge id: axis-major, then a's index."""
    return [(c, c | (1 << a)) for a in range(3) for c in range(8) if not c >> a & 1]


def _faces() -> list:
    """Each face's four corners ordered counter-clockwise seen from outside:
    sorted by their angle about the face's centre, measured in the plane
    with the outward normal as the rotation's axis."""
    out = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3  # (u, v, a) is right-handed
        for side in (0, 1):
            ks = [k for k in range(8) if _corner(k)[a] == side]
            sign = 1.0 if side else -1.0
            ks.sort(key=lambda k: math.atan2(sign * (_corner(k)[v] - 0.5), _corner(k)[u] - 0.5))
            out.append(ks)
    return out


def case_tables() -> tuple:
    """(tri [256, MAX_TRIS, 3] int64, -1 past a case's triangles; loops
    [256, MAX_LOOPS, 12] bool, the edges of each loop longer than 3)."""
    edges = _edges()
    edge_of = {frozenset(p): e for e, p in enumerate(edges)}
    faces = _faces()
    tri = torch.full((256, MAX_TRIS, 3), -1, dtype=torch.int64)
    loops = torch.zeros((256, MAX_LOOPS, 12), dtype=torch.bool)
    for case in range(256):
        inside = [bool(case >> k & 1) for k in range(8)]
        nxt = {}
        for ring in faces:
            cuts = [(i, edge_of[frozenset((ring[i], ring[(i + 1) % 4]))], inside[ring[i]])
                    for i in range(4) if inside[ring[i]] != inside[ring[(i + 1) % 4]]]
            for i, e, leaving in cuts:
                if leaving:
                    ahead = sorted(((j - i) % 4, f) for j, f, lv in cuts if not lv)
                    nxt[e] = ahead[0][1]
        # the loops' order and each one's first edge: the order in which a
        # Python set of the segments' first edges, filled face by face,
        # pops them (the JAX package's table has this order)
        rest, found = set(nxt), []
        while rest:
            start = rest.pop()
            loop, e = [], start
            while True:
                loop.append(e)
                rest.discard(e)
                e = nxt[e]
                if e == start:
                    break
            found.append(loop)
        rows = []
        for li, loop in enumerate(found):
            if len(loop) == 3:
                rows.append((loop[0], loop[2], loop[1]))
                continue
            loops[case, li, loop] = True
            rows += [(12 + li, loop[(i + 1) % len(loop)], loop[i]) for i in range(len(loop))]
        if rows:
            tri[case, :len(rows)] = torch.tensor(rows)
    return tri, loops


def _edge_t(v0: torch.Tensor, v1: torch.Tensor, dtype) -> torch.Tensor:
    a, b = v0.to(dtype), v1.to(dtype)
    den = a - b
    tiny = den.abs() < 1e-30
    t = (a / torch.where(tiny, torch.ones_like(den), den)).clamp(0.0, 1.0)
    return torch.where(tiny, torch.full_like(t, 0.5), t).double()


def _active(tsdf, weight, shape, x0: int, x1: int):
    """(cells [A, 3] int64, corner values [A, 8] f32, cases [A]) of the
    active cells of cell planes x0..x1-1, in C order."""
    nx, ny, nz = shape
    plane = ny * nz
    t = tsdf[x0 * plane:(x1 + 1) * plane].view(x1 + 1 - x0, ny, nz)
    w = weight[x0 * plane:(x1 + 1) * plane].view(x1 + 1 - x0, ny, nz)
    p, cy, cz = x1 - x0, ny - 1, nz - 1
    obs = torch.ones((p, cy, cz), dtype=torch.bool, device=tsdf.device)
    case = torch.zeros((p, cy, cz), dtype=torch.int64, device=tsdf.device)
    for k in range(8):
        dx, dy, dz = _corner(k)
        obs &= w[dx:dx + p, dy:dy + cy, dz:dz + cz] > 0
        case |= (~(t[dx:dx + p, dy:dy + cy, dz:dz + cz] > 0)).long() << k
    cells = (obs & (case > 0) & (case < 255)).nonzero()
    vals = torch.stack([t[cells[:, 0] + dx, cells[:, 1] + dy, cells[:, 2] + dz]
                        for dx, dy, dz in map(_corner, range(8))], 1)
    cells[:, 0] += x0
    return cells, vals, case[cells[:, 0] - x0, cells[:, 1], cells[:, 2]]


def triangulate(tsdf: torch.Tensor, weight: torch.Tensor, colors: torch.Tensor, shape,
                origin, voxel: float, contract=None, t_dtype=torch.float64) -> dict:
    """The mesh of the grid (tsdf [N], weight [N], colors [N, 3], f32, flat
    over `shape`) on the grid's device: vertices [V, 3] and colours [V, 3]
    float64, faces [F, 3] int64, and what the work model counts: `observed`
    corners and `edge_corners` (the corners at the ends of a vertex's edge).
    `contract` is None or (radius, centre)."""
    dev = tsdf.device
    nx, ny, nz = (int(n) for n in shape)
    tri_table, loop_table = (a.to(dev) for a in case_tables())
    step = max(1, SLAB_CELLS // max(1, (ny - 1) * (nz - 1)))
    parts = [_active(tsdf, weight, (nx, ny, nz), x0, min(x0 + step, nx - 1))
             for x0 in range(0, nx - 1, step)]
    cells, vals, cases = (torch.cat(a) for a in zip(*parts)) if parts else (None,) * 3
    observed = int((weight > 0).sum())
    if cells is None or len(cells) == 0:
        z = torch.zeros((0, 3), dtype=torch.float64, device=dev)
        return dict(vertices=z, colors=z, faces=torch.zeros((0, 3), dtype=torch.int64,
                                                            device=dev),
                    observed=observed, edge_corners=0)
    edges = _edges()
    ea = torch.tensor([a for a, _ in edges], device=dev)
    eb = torch.tensor([b for _, b in edges], device=dev)
    axis = torch.arange(12, device=dev) // 4
    offs = torch.tensor([_corner(k) for k in range(8)], device=dev)
    inside = ~(vals > 0)
    crossed = inside[:, ea] != inside[:, eb]                          # [A, 12]
    base = cells[:, None, :] + offs[ea]                               # [A, 12, 3]
    keys = ((base[..., 0] * ny + base[..., 1]) * nz + base[..., 2]) * 3 + axis
    uniq = torch.unique(keys[crossed])                                # sorted
    nverts = len(uniq)

    # edge vertices, from the grid at each key's two corners
    gb = uniq // 3
    ax = uniq % 3
    step_of = torch.tensor([ny * nz, nz, 1], device=dev)
    gt = gb + step_of[ax]
    t = _edge_t(tsdf[gb], tsdf[gt], t_dtype)
    coords = torch.stack([gb // (ny * nz), (gb // nz) % ny, gb % nz], 1).double()
    pos = coords + torch.nn.functional.one_hot(ax, 3).double() * t[:, None]
    col = colors[gb].double() * (1 - t)[:, None] + colors[gt].double() * t[:, None]

    # centroids of the loops longer than 3
    lmask = loop_table[cases]                                         # [A, 4, 12]
    need = lmask.any(-1)
    a_c, l_c = need.nonzero(as_tuple=True)
    if len(a_c):
        cv = vals[a_c]
        te = _edge_t(cv[:, ea], cv[:, eb], t_dtype)                   # [C, 12]
        epos = (cells[a_c][:, None, :] + offs[ea]).double() \
            + torch.nn.functional.one_hot(axis, 3).double() * te[..., None]
        cc = colors[((cells[a_c][:, None, :] + offs) * torch.tensor([ny * nz, nz, 1],
                                                                     device=dev)).sum(-1)]
        ecol = cc[:, ea].double() * (1 - te)[..., None] + cc[:, eb].double() * te[..., None]
        m = lmask[a_c, l_c].double()                                  # [C, 12]
        cpos, ccol = m[:, 0, None] * epos[:, 0], m[:, 0, None] * ecol[:, 0]
        for e in range(1, 12):
            cpos = cpos + m[:, e, None] * epos[:, e]
            ccol = ccol + m[:, e, None] * ecol[:, e]
        n = m.sum(-1, keepdim=True)
        pos = torch.cat([pos, cpos / n])
        col = torch.cat([col, ccol / n])
    cent_id = torch.full(need.shape, -1, dtype=torch.int64, device=dev)
    cent_id[a_c, l_c] = nverts + torch.arange(len(a_c), device=dev)

    # faces
    tris = tri_table[cases]                                           # [A, 8, 3]
    valid = tris[..., 0] >= 0
    a_f = valid.nonzero(as_tuple=True)[0]
    local = tris[valid]                                               # [F, 3]
    edge_key = keys[a_f[:, None], local.clamp_max(11)]
    faces = torch.where(local >= 12, cent_id[a_f[:, None], (local - 12).clamp_min(0)],
                        torch.searchsorted(uniq, edge_key))

    q = (pos + 0.5) * float(voxel) + torch.tensor([float(o) for o in origin],
                                                   dtype=torch.float64, device=dev)
    if contract is not None:
        radius, centre = contract
        norm = _sqrt((q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2])[:, None]
        s = norm.clamp(1e-9, 2.0 - 1e-6)
        q = torch.where(norm <= 1.0, q, q / (s * (2.0 - s)))
        q = q * float(radius) + torch.tensor([float(c) for c in centre], dtype=torch.float64,
                                             device=dev)
    ends = torch.unique(torch.cat([gb, gt]))
    return dict(vertices=q, colors=col, faces=faces, observed=observed,
                edge_corners=int(ends.numel()))
