"""Marching cubes over a TSDF grid (level 0), port of
`scorp_tpu.pipeline.marching_cubes` (host-side numpy, as in the JAX
package; the port keeps its own copy).

Vertices lie on grid edges at the linear zero crossing and every active
cell is triangulated from a 256-entry case table. The table is derived at
import by tracing the isosurface's intersection with the cube boundary:

  * on each face, boundary crossings alternate exit/entry along the
    outward-ccw walk of the face's corners; each exit pairs with the next
    entry, giving directed in-face segments with the inside (negative)
    region to the left;
  * the ambiguous face (two diagonal inside corners) therefore resolves to
    "inside corners connected", a rule that depends only on the face's own
    signs, so the two cubes sharing a face agree and the mesh is watertight;
  * each crossed cube edge is entered by exactly one segment and left by
    exactly one, so the segments chain into closed directed loops;
  * 3-loops become one triangle; longer loops are fanned from a Steiner
    vertex at the loop centroid, strictly inside the cell, so every
    triangle edge is either a face chord (used once by each of the two
    face-adjacent cells) or a centroid spoke (used by two fan triangles of
    one loop): edge-manifold and watertight wherever the grid is observed.

Winding is ccw seen from the positive (free-space) side.
"""

from __future__ import annotations

import numpy as np

# corner k sits at offset ((k>>0)&1, (k>>1)&1, (k>>2)&1) from the cell base
CORNER_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], np.int64
)
# edge e = 4*axis + i joins EDGE_PAIRS[e] = (c, c | 1<<axis)
EDGE_PAIRS = [
    (c, c | (1 << axis))
    for axis in range(3)
    for c in range(8)
    if not (c >> axis) & 1
]
EDGE_AXIS = np.array([e // 4 for e in range(12)], np.int64)
EDGE_BASE = np.array([EDGE_PAIRS[e][0] for e in range(12)], np.int64)
_EDGE_OF_PAIR = {frozenset(p): e for e, p in enumerate(EDGE_PAIRS)}


def _face_cycles():
    """The 6 faces as corner cycles, ccw seen from OUTSIDE the cube."""
    faces = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (0, 1):
            cyc = [
                (side << axis) | (p << u) | (q << v)
                for p, q in ((0, 0), (1, 0), (1, 1), (0, 1))
            ]
            # right-hand winding of the (u, v) cycle points along u x v;
            # flip when that is not the outward normal of this face
            uxv_along_axis = 1 if (axis, u, v) in ((0, 1, 2), (2, 0, 1)) else -1
            outward = 1 if side == 1 else -1
            if uxv_along_axis != outward:
                cyc.reverse()
            faces.append(cyc)
    return faces


_FACES = _face_cycles()


MAX_LOOPS = 4  # a cube holds at most 4 disjoint isosurface loops
# cells a slab of `marching_cubes` holds: ~100 B of temporaries a cell
SLAB_CELLS = 1 << 22


def _case_loops(case: int) -> list[list[int]]:
    inside = [(case >> k) & 1 for k in range(8)]
    seg_from: dict[int, int] = {}  # from-edge -> to-edge
    for cyc in _FACES:
        marks = []  # (walk position, edge id, is_exit)
        for i in range(4):
            a, b = cyc[i], cyc[(i + 1) % 4]
            if inside[a] != inside[b]:
                marks.append((i, _EDGE_OF_PAIR[frozenset((a, b))], bool(inside[a])))
        # exits pair with the next entry along the ccw walk (cyclic)
        for pos, edge, is_exit in marks:
            if not is_exit:
                continue
            best = min(
                (((p - pos) % 4, e) for p, e, x in marks if not x),
                default=None,
            )
            assert best is not None
            seg_from[edge] = best[1]
    loops: list[list[int]] = []
    unused = set(seg_from)
    while unused:
        start = unused.pop()
        loop = [start]
        nxt = seg_from[start]
        while nxt != start:
            unused.discard(nxt)
            loop.append(nxt)
            nxt = seg_from[nxt]
        loops.append(loop)
    return loops


def _case_triangles(case: int) -> list[tuple[int, int, int]]:
    """Triangles as edge-id triples; id 12+l is loop l's centroid vertex.
    Loops wind with the inside region on their left; triangles are emitted
    REVERSED so normals face the positive (free-space) side."""
    tris: list[tuple[int, int, int]] = []
    for li, loop in enumerate(_case_loops(case)):
        if len(loop) == 3:
            tris.append((loop[0], loop[2], loop[1]))
        else:
            c = 12 + li
            for i in range(len(loop)):
                tris.append((c, loop[(i + 1) % len(loop)], loop[i]))
    return tris


def _build_tables():
    all_loops = [_case_loops(c) for c in range(256)]
    all_tris = [_case_triangles(c) for c in range(256)]
    assert max(len(ls) for ls in all_loops) <= MAX_LOOPS
    maxt = max(len(t) for t in all_tris)
    table = np.full((256, maxt, 3), -1, np.int64)
    loop_mask = np.zeros((256, MAX_LOOPS, 12), bool)  # centroid loops only
    for c in range(256):
        for i, t in enumerate(all_tris[c]):
            table[c, i] = t
        for li, loop in enumerate(all_loops[c]):
            if len(loop) > 3:
                loop_mask[c, li, loop] = True
    return table, loop_mask


TRI_TABLE, LOOP_MASK = _build_tables()


def _slab_cells(tsdf: np.ndarray, weight: np.ndarray, x0: int, x1: int):
    """The active cells of the cell planes x0..x1-1, from the corner planes
    x0..x1 (one plane of halo): (cell [A, 3] in grid coordinates, case [A],
    corner values [A, 8] in float64, inside [A, 8]), in C order."""
    observed = weight[x0:x1 + 1] > 0
    sdf = np.where(observed, tsdf[x0:x1 + 1], np.nan).astype(np.float64)
    r = np.array(sdf.shape)

    corner_vals = np.stack(
        [
            sdf[dx:r[0] - 1 + dx, dy:r[1] - 1 + dy, dz:r[2] - 1 + dz]
            for dx, dy, dz in CORNER_OFFSETS
        ],
        axis=-1,
    )  # [cx, cy, cz, 8]
    inside = ~(corner_vals > 0)  # NaN -> inside=True, masked by all_obs below
    all_obs = ~np.isnan(corner_vals).any(axis=-1)
    case = (inside.astype(np.int64) << np.arange(8)).sum(axis=-1)
    active = all_obs & (case > 0) & (case < 255)
    ci, cj, ck = np.nonzero(active)
    cell = np.stack([ci + x0, cj, ck], axis=-1)
    return cell, case[ci, cj, ck], corner_vals[ci, cj, ck], inside[ci, cj, ck]


def marching_cubes(tsdf: np.ndarray, weight: np.ndarray, origin, voxel_size,
                   colors: np.ndarray | None = None):
    """Level-0 marching cubes -> (vertices, faces, vert_colors).

    Same contract as `mesh.surface_nets`: grid values live at voxel centers
    ((i + 0.5) * voxel_size + origin), cells span 8 adjacent centers,
    weight==0 marks unobserved voxels (cells touching one are skipped).
    Triangles wind ccw seen from the positive (outside) region.

    The cells are found a slab of cell planes along the first axis at a time
    (as many planes as hold SLAB_CELLS cells), each from its corner planes
    and one plane of halo, so no array of the grid's size is built; every
    slab split gives the same mesh bit for bit. The mesh's order:
      * edge vertices in ascending key ((gx R1 + gy) R2 + gz) 3 + axis of
        their edge's base corner (gx, gy, gz) in an R0 x R1 x R2 grid;
        an edge has a vertex when it is crossed and an active cell holds it;
      * then one centroid vertex a loop longer than 3, in active-cell order
        (C order over cells), then loop order;
      * faces in active-cell order, then case-table order.
    """
    r = np.array(tsdf.shape)
    planes = max(1, SLAB_CELLS // max(1, int((r[1] - 1) * (r[2] - 1))))
    slabs = [_slab_cells(tsdf, weight, x0, min(x0 + planes, r[0] - 1))
             for x0 in range(0, r[0] - 1, planes)]
    if not slabs or sum(len(s[1]) for s in slabs) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64), np.zeros((0, 3))
    cell, cases, cvals, cin = (np.concatenate(a) for a in zip(*slabs))
    ci, cj, ck = cell.T

    # crossing position on every crossed edge of every active cell, in
    # grid (voxel-center-index) coordinates
    ea, eb = EDGE_BASE, np.array([b for _, b in EDGE_PAIRS], np.int64)
    v0 = cvals[:, ea]                               # [A, 12]
    v1 = cvals[:, eb]
    crossed = cin[:, ea] != cin[:, eb]              # [A, 12]
    denom = v0 - v1
    t = np.clip(v0 / np.where(np.abs(denom) < 1e-30, 1.0, denom), 0.0, 1.0)
    t = np.where(np.abs(denom) < 1e-30, 0.5, t)
    oa = CORNER_OFFSETS[ea].astype(np.float64)      # [12, 3]
    ob = CORNER_OFFSETS[eb].astype(np.float64)
    epos = cell[:, None, :] + oa + t[..., None] * (ob - oa)      # [A, 12, 3]

    if colors is not None:
        ccorner = colors[
            ci[:, None] + CORNER_OFFSETS[:, 0],
            cj[:, None] + CORNER_OFFSETS[:, 1],
            ck[:, None] + CORNER_OFFSETS[:, 2],
        ]                                           # [A, 8, 3]
        ecol = (
            ccorner[:, ea] * (1 - t[..., None]) + ccorner[:, eb] * t[..., None]
        )                                           # [A, 12, 3]
    else:
        ecol = np.zeros_like(epos)

    # shared edge vertices: dedupe by (base corner grid coords, axis)
    gxyz = cell[:, None, :] + CORNER_OFFSETS[ea]                 # [A, 12, 3]
    keys = ((gxyz[..., 0] * r[1] + gxyz[..., 1]) * r[2] + gxyz[..., 2]) * 3 \
        + EDGE_AXIS
    a_c, e_c = np.nonzero(crossed)
    uniq, first, inv = np.unique(
        keys[a_c, e_c], return_index=True, return_inverse=True
    )
    vid_edge = np.full((len(ci), 12), -1, np.int64)
    vid_edge[a_c, e_c] = inv
    vert_pos = epos[a_c[first], e_c[first]]
    vert_col = ecol[a_c[first], e_c[first]]

    # Steiner centroid vertices, one per >3-loop (see module docstring)
    lmask = LOOP_MASK[cases]                        # [A, 4, 12]
    need_c = lmask.any(axis=-1)                     # [A, 4]
    nloop = lmask.sum(axis=-1)
    cpos = (lmask[..., None] * epos[:, None, :, :]).sum(axis=2) \
        / np.maximum(nloop, 1)[..., None]
    ccol = (lmask[..., None] * ecol[:, None, :, :]).sum(axis=2) \
        / np.maximum(nloop, 1)[..., None]
    vid_cent = np.full((len(ci), MAX_LOOPS), -1, np.int64)
    ac, lc = np.nonzero(need_c)
    vid_cent[ac, lc] = len(uniq) + np.arange(len(ac))
    vert_pos = np.concatenate([vert_pos, cpos[ac, lc]])
    vert_col = np.concatenate([vert_col, ccol[ac, lc]])

    # resolve the per-cell triangle table against both vertex kinds
    tri = TRI_TABLE[cases]                          # [A, MAXT, 3]
    valid = tri[:, :, 0] >= 0
    a_idx, _ = np.nonzero(valid)
    tri = tri[valid]                                # [F, 3] local ids
    is_cent = tri >= 12
    faces = np.where(
        is_cent,
        vid_cent[a_idx[:, None], np.where(is_cent, tri - 12, 0)],
        vid_edge[a_idx[:, None], np.where(is_cent, 0, tri)],
    )
    assert (faces >= 0).all()

    vertices = (vert_pos + 0.5) * voxel_size + np.asarray(origin)
    return vertices, faces, vert_col
