"""Minimal PLY codec + the Gaussian-splat PLY schema (numpy only).

A copy of `scorp_tpu.core.plyio`, kept here so that the torch port imports
nothing of the JAX package; both write byte-identical files.

The on-disk Gaussian checkpoint format is a hard compatibility requirement
and matches the original 3DGS `GaussianModel.save_ply` byte-for-byte: binary
little-endian PLY, one `vertex` element with f4 properties

    x y z nx ny nz f_dc_0..2 f_rest_0..R opacity scale_0..S rot_0..3

where R = 3*((deg+1)^2 - 1) - 1 and S = 2 (2DGS surfels) or 3 (3DGS).
`f_rest` is stored channel-major: the [N, K-1, 3] coefficient tensor is
transposed to [N, 3, K-1] before flattening (all K-1 coeffs of channel R,
then G, then B).

No external `plyfile` dependency: the parser below handles binary LE and
ascii PLY with float/double/uchar/int properties, which covers every PLY the
pipeline reads (Gaussian checkpoints + COLMAP-converted `points3D.ply`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_PLY_DTYPES = {
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the first (vertex) element of a PLY file -> {prop: [N] array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        props: list[tuple[str, str]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                props = []
                elements.append((tokens[1], int(tokens[2]), props))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise ValueError(f"{path}: list properties unsupported")
                props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if not elements:
            raise ValueError(f"{path}: no elements")
        name, count, props = elements[0]
        if fmt == "binary_little_endian":
            dtype = np.dtype([(p, "<" + d) for p, d in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "binary_big_endian":
            dtype = np.dtype([(p, ">" + d) for p, d in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "ascii":
            dtype = np.dtype([(p, d) for p, d in props])
            raw = np.loadtxt(f, dtype=np.float64, max_rows=count).reshape(count, len(props))
            data = np.empty(count, dtype=dtype)
            for i, (p, _) in enumerate(props):
                data[p] = raw[:, i]
        else:
            raise ValueError(f"{path}: unknown PLY format {fmt}")
        return {p: np.ascontiguousarray(data[p]) for p, _ in props}


def write_ply(path: str, columns: list[tuple[str, np.ndarray]]) -> None:
    """Write a binary little-endian PLY with one vertex element of f4 props."""
    n = len(columns[0][1])
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    dtype = []
    for name, col in columns:
        assert len(col) == n, f"column {name} length mismatch"
        header.append(f"property float {name}")
        dtype.append((name, "<f4"))
    header.append("end_header")
    rec = np.empty(n, dtype=np.dtype(dtype))
    for name, col in columns:
        rec[name] = col.astype(np.float32)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


@dataclass
class GaussianData:
    """Host-side (numpy) Gaussian parameters in raw (pre-activation) form.

    Shapes: xyz [N,3]; f_dc [N,1,3]; f_rest [N,K-1,3]; opacity [N,1] (logit);
    scaling [N,3] or [N,2] (log); rotation [N,4] (unnormalized wxyz quat).
    """

    xyz: np.ndarray
    f_dc: np.ndarray
    f_rest: np.ndarray
    opacity: np.ndarray
    scaling: np.ndarray
    rotation: np.ndarray

    @property
    def n(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round((self.f_rest.shape[1] + 1) ** 0.5)) - 1

    def concat(self, other: "GaussianData") -> "GaussianData":
        return GaussianData(
            xyz=np.concatenate([self.xyz, other.xyz], 0),
            f_dc=np.concatenate([self.f_dc, other.f_dc], 0),
            f_rest=np.concatenate([self.f_rest, other.f_rest], 0),
            opacity=np.concatenate([self.opacity, other.opacity], 0),
            scaling=np.concatenate([self.scaling, other.scaling], 0),
            rotation=np.concatenate([self.rotation, other.rotation], 0),
        )

    def select(self, mask_or_idx: np.ndarray) -> "GaussianData":
        return GaussianData(
            xyz=self.xyz[mask_or_idx],
            f_dc=self.f_dc[mask_or_idx],
            f_rest=self.f_rest[mask_or_idx],
            opacity=self.opacity[mask_or_idx],
            scaling=self.scaling[mask_or_idx],
            rotation=self.rotation[mask_or_idx],
        )


def save_gaussian_ply(path: str, g: GaussianData) -> None:
    """Write a Gaussian checkpoint in the reference PLY schema."""
    n = g.n
    xyz = g.xyz.astype(np.float32)
    normals = np.zeros_like(xyz)
    # channel-major flatten: [N,K-1,3] -> [N,3,K-1] -> [N,3*(K-1)]
    f_dc = np.transpose(g.f_dc, (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(g.f_rest, (0, 2, 1)).reshape(n, -1)
    cols: list[tuple[str, np.ndarray]] = []
    for i, name in enumerate(["x", "y", "z"]):
        cols.append((name, xyz[:, i]))
    for i, name in enumerate(["nx", "ny", "nz"]):
        cols.append((name, normals[:, i]))
    for i in range(f_dc.shape[1]):
        cols.append((f"f_dc_{i}", f_dc[:, i]))
    for i in range(f_rest.shape[1]):
        cols.append((f"f_rest_{i}", f_rest[:, i]))
    cols.append(("opacity", g.opacity[:, 0]))
    for i in range(g.scaling.shape[1]):
        cols.append((f"scale_{i}", g.scaling[:, i]))
    for i in range(g.rotation.shape[1]):
        cols.append((f"rot_{i}", g.rotation[:, i]))
    write_ply(path, cols)


def load_gaussian_ply(path: str, max_sh_degree: int | None = None) -> GaussianData:
    """Read a Gaussian checkpoint; pads/truncates f_rest to max_sh_degree if given."""
    props = read_ply(path)
    n = len(props["x"])
    xyz = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(props["opacity"], np.float32)[:, None]
    f_dc = np.stack([props[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    f_dc = f_dc[:, None, :]  # [N,1,3]: one DC band, three channels

    rest_names = sorted(
        (k for k in props if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    n_rest = len(rest_names)
    if max_sh_degree is not None:
        want = 3 * ((max_sh_degree + 1) ** 2 - 1)
    else:
        want = n_rest
    flat = np.zeros((n, want), np.float32)
    for i, name in enumerate(rest_names[: min(n_rest, want)]):
        flat[:, i] = props[name]
    # disk layout is channel-major -> back to [N, K-1, 3]
    f_rest = flat.reshape(n, 3, want // 3).transpose(0, 2, 1).astype(np.float32)

    scale_names = sorted(
        (k for k in props if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    scaling = np.stack([props[k] for k in scale_names], axis=1).astype(np.float32)
    rot_names = sorted(
        (k for k in props if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    rotation = np.stack([props[k] for k in rot_names], axis=1).astype(np.float32)
    return GaussianData(xyz, f_dc, f_rest, opacity, scaling, rotation)


def save_point_cloud_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
                         normals: np.ndarray | None = None) -> None:
    """Plain xyz(+rgb uchar) PLY, used for `input.ply` like the reference."""
    n = points.shape[0]
    if normals is None:
        normals = np.zeros_like(points)
    header = [
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
    ]
    dtype = [(k, "<f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header.append("end_header")
    rec = np.empty(n, dtype=np.dtype(dtype))
    for i, k in enumerate(("x", "y", "z")):
        rec[k] = points[:, i].astype(np.float32)
    for i, k in enumerate(("nx", "ny", "nz")):
        rec[k] = normals[:, i].astype(np.float32)
    if colors is not None:
        c = colors
        if c.dtype != np.uint8:
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
        for i, k in enumerate(("red", "green", "blue")):
            rec[k] = c[:, i]
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def load_point_cloud_ply(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read xyz / rgb / normals from a plain point-cloud PLY."""
    props = read_ply(path)
    pts = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(np.float64)
    n = pts.shape[0]
    if "red" in props:
        colors = np.stack([props["red"], props["green"], props["blue"]], axis=1)
        if colors.dtype == np.uint8:
            colors = colors.astype(np.float64) / 255.0
    else:
        colors = np.ones((n, 3), np.float64) * 0.5
    if "nx" in props:
        normals = np.stack([props["nx"], props["ny"], props["nz"]], axis=1).astype(np.float64)
    else:
        normals = np.zeros((n, 3), np.float64)
    return pts, colors, normals
