"""The synthetic capture every cell runs on: a textured room, its poses, its
ground-truth images and the Gaussian state, all made from seeds.

Nothing here imports the program. The room is drawn as
`scorp_tpu_torch/runs/densify_scale_run.py:make_textured_gaussians` draws
it (a closed room of thin textured walls with four sinusoid octaves and 24
checkered objects), in PyTorch on the device and at the configuration's
row count, with log-scales lowered by 1/2 ln(n / 200,000) so that the
coverage of a pixel stays that of the 200k-row room. The scene's shape
comes from the configuration's `scene_seed`, the same in every run; the
run's `--seed` moves only what a user's run would vary: the state's
perturbation, Adam's second moments, the order of the views and the
backgrounds.

The ground truth is ray-cast analytically against the same room (walls as
planes, objects as spheres, colours from the same texture), written as
JPEGs (the Mip-NeRF 360 format) with COLMAP text files, so that the
program's own scene reader loads it.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SH_C0 = 0.28209479177387814
ROOM = (2.6, 1.6, 2.6)          # half extents of the room in x, y, z
N_OBJECTS = 24
OBJECT_RADIUS = 0.25            # the clutter's blobs (sigma 0.16) as spheres
OCTAVES = ((2.0, 0.16), (8.0, 0.14), (24.0, 0.14), (60.0, 0.22))
BASE_ROWS = 200_000             # the row count whose pixel coverage is kept


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


class Texture:
    """The room's colour field: four sinusoid octaves on the walls, a
    24/unit checker on the objects (the same draws for the GT and the
    Gaussians)."""

    def __init__(self, scene_seed: int, device):
        g = _gen(scene_seed, device)
        f32 = dict(device=device, dtype=torch.float32)
        self.freqs = [torch.randn(3, 3, generator=g, **f32) * s for s, _ in OCTAVES]
        self.phases = [torch.rand(3, generator=g, **f32) * 2 * math.pi for _ in OCTAVES]
        self.centers = (torch.rand(N_OBJECTS, 3, generator=g, **f32) * 2.2 - 1.1) * \
            torch.tensor([1.0, 0.55, 1.0], **f32)
        self.obj_colors = torch.rand(N_OBJECTS, 3, generator=g, **f32) * 0.6 + 0.2

    def wall(self, p: torch.Tensor) -> torch.Tensor:
        col = torch.full_like(p, 0.5)
        for (_, amp), f, ph in zip(OCTAVES, self.freqs, self.phases):
            col = col + amp * torch.sin(p @ f.T + ph)
        return col.clamp(0.05, 0.95)

    def obj(self, p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        checker = torch.floor(p * 24.0).sum(dim=-1).remainder(2.0)
        return (self.obj_colors[idx] * (0.65 + 0.7 * checker[..., None])).clamp(0.05, 0.95)


def draw_rows(cfg: dict, device) -> dict:
    """The room's Gaussians at the configuration's row count: [n, ...]
    tensors xyz, rgb, log_scale (2 or 3 columns), opacity logit, rotation
    and the f_rest coefficients, drawn from `scene_seed`."""
    n = int(cfg["n_gaussians"])
    tex = Texture(cfg["scene_seed"], device)
    g = _gen(cfg["scene_seed"] + 1, device)
    f32 = dict(device=device, dtype=torch.float32)
    n_wall = (3 * n) // 4
    per_slab = -(-n_wall // 6)
    walls = []
    for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)):
        p = (torch.rand(per_slab, 3, generator=g, **f32) * 2 - 1) * torch.tensor(ROOM, **f32)
        p[:, axis] = sign * ROOM[axis] + 0.01 * torch.randn(per_slab, generator=g, **f32)
        walls.append(p)
    walls = torch.cat(walls)[:n_wall]
    idx = torch.randint(0, N_OBJECTS, (n - n_wall,), generator=g, device=device)
    clutter = tex.centers[idx] + 0.16 * torch.randn(n - n_wall, 3, generator=g, **f32)
    xyz = torch.cat([walls, clutter])
    rgb = torch.cat([tex.wall(walls), tex.obj(clutter, idx)])
    n_scale = int(cfg["scale_columns"])
    shrink = 0.5 * math.log(n / BASE_ROWS)
    log_scale = torch.cat([
        math.log(0.016) + 0.25 * torch.randn(n_wall, n_scale, generator=g, **f32),
        math.log(0.022) + 0.25 * torch.randn(n - n_wall, n_scale, generator=g, **f32),
    ]) - shrink
    k_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    return dict(
        xyz=xyz, rgb=rgb, log_scale=log_scale,
        opacity=3.2 + 0.4 * torch.randn(n, 1, generator=g, **f32),
        rotation=torch.randn(n, 4, generator=g, **f32),
        f_rest=0.003 * torch.randn(n, k_rest, 3, generator=g, **f32),
    )


def state_tensors(cfg: dict, seed: int, device) -> tuple[dict, dict, torch.Tensor, int]:
    """The state a run starts from, as plain tensors: (params, Adam's second
    moments, alive mask, capacity). Rows are padded to a multiple of 4,096
    as the trainer pads them; the padding is dead and zero. The run's seed
    perturbs every drawn row a little (positions by 1 mm, colours and
    opacities by a few percent) and draws Adam's second moments, U(1e-7,
    1e-5) on live rows; first moments start at zero, so one step's gradient
    is m' / (1 - beta1)."""
    rows = draw_rows(cfg, device)
    n = rows["xyz"].shape[0]
    cap = -(-n // 4096) * 4096
    g = _gen(seed, device)
    f32 = dict(device=device, dtype=torch.float32)

    def jitter(t, s):
        return t + s * torch.randn(t.shape, generator=g, **f32)

    params = {
        "xyz": jitter(rows["xyz"], 1e-3),
        "f_dc": ((jitter(rows["rgb"], 0.02) - 0.5) / SH_C0)[:, None, :],
        "f_rest": rows["f_rest"],
        "scaling": jitter(rows["log_scale"], 0.02),
        "rotation": rows["rotation"],
        "opacity": jitter(rows["opacity"], 0.1),
    }
    params = {k: torch.cat([v, v.new_zeros((cap - n,) + v.shape[1:])]).contiguous()
              for k, v in params.items()}
    alive = torch.arange(cap, device=device) < n
    v = {}
    for k, p in params.items():
        r = 1e-7 + torch.rand(p.shape, generator=g, **f32) * 9.9e-6
        v[k] = torch.where(alive.reshape((cap,) + (1,) * (p.ndim - 1)), r, 0.0)
    return params, v, alive, cap


def poses(cfg: dict) -> list[dict]:
    """The capture's inward-looking poses inside the room, in the order of
    the image names: COLMAP's camera-to-world rotation R and
    world-to-camera translation T, with the fields of view."""
    n = int(cfg["n_views"])
    rng = np.random.default_rng(cfg["scene_seed"] + 2)
    fovx = float(cfg["fovx"])
    fovy = 2 * math.atan(math.tan(fovx / 2) * cfg["height"] / cfg["width"])
    out = []
    for i in range(n):
        a = 2 * math.pi * i / n + rng.uniform(-0.01, 0.01)
        radius = 1.8 + 0.25 * math.sin(3 * a)
        c = np.array([radius * math.cos(a), 0.15 + 0.45 * math.sin(2 * a + 1),
                      radius * math.sin(a)])
        target = rng.uniform(-0.3, 0.3, 3) * np.array([1.0, 0.5, 1.0])
        fwd = target - c
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))  # COLMAP: y points down
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)            # camera-to-world rotation
        T = -R.T @ c
        out.append(dict(name=f"view_{i:03d}", R=R, T=T, center=c, fovx=fovx, fovy=fovy))
    return out


def ray_cast(pose: dict, cfg: dict, tex: Texture, device) -> torch.Tensor:
    """[H, W, 3] uint8 image of the room seen from `pose`: the nearest of the
    six wall planes and the object spheres along each pixel's ray, its
    colour from the texture."""
    w, h = int(cfg["width"]), int(cfg["height"])
    f64 = dict(device=device, dtype=torch.float64)
    fx = w / (2 * math.tan(pose["fovx"] / 2))
    fy = h / (2 * math.tan(pose["fovy"] / 2))
    ys, xs = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    d_cam = torch.stack([(xs + 0.5 - w / 2) / fx, (ys + 0.5 - h / 2) / fy,
                         torch.ones_like(xs)], dim=-1)
    R = torch.as_tensor(pose["R"], **f64)
    d = d_cam @ R.T
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.as_tensor(pose["center"], **f64)
    half = torch.as_tensor(ROOM, **f64)
    # the wall the ray leaves the box through
    t_wall = torch.where(d > 0, (half - o) / d, (-half - o) / d.clamp(max=-1e-12))
    t_wall = torch.where(d.abs() < 1e-12, torch.inf, t_wall).min(dim=-1).values
    t_best = t_wall
    hit_obj = torch.full(t_wall.shape, -1, dtype=torch.long, device=device)
    for j, c in enumerate(tex.centers.double()):
        oc = o - c
        b = (d * oc).sum(-1)
        disc = b * b - (oc * oc).sum() + OBJECT_RADIUS ** 2
        t = -b - torch.sqrt(disc.clamp(min=0))
        ok = (disc > 0) & (t > 1e-3) & (t < t_best)
        t_best = torch.where(ok, t, t_best)
        hit_obj = torch.where(ok, j, hit_obj)
    p = (o + t_best[..., None] * d).float()
    col = torch.where((hit_obj >= 0)[..., None], tex.obj(p, hit_obj.clamp(min=0)), tex.wall(p))
    return (col * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


def write_capture(root: str, cfg: dict, device, quality: int = 95) -> list[dict]:
    """The capture on disk, as the program's COLMAP reader takes it:
    images/<name>.jpg, sparse/{cameras,images,points3D}.txt and split.yml
    (every `test_every`-th view held out, Mip-NeRF 360's protocol).
    Returns the poses."""
    from PIL import Image

    ps = poses(cfg)
    tex = Texture(cfg["scene_seed"], device)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "sparse"), exist_ok=True)

    def save(item):
        name, img = item
        Image.fromarray(img).save(os.path.join(root, "images", name + ".jpg"), quality=quality)

    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = []
        for p in ps:
            img = ray_cast(p, cfg, tex, device).cpu().numpy()
            futures.append(pool.submit(save, (p["name"], img)))
        for f in futures:
            f.result()
    w, h = int(cfg["width"]), int(cfg["height"])
    fx = w / (2 * math.tan(ps[0]["fovx"] / 2))
    fy = h / (2 * math.tan(ps[0]["fovy"] / 2))
    with open(os.path.join(root, "sparse", "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {w} {h} {fx!r} {fy!r} {w / 2!r} {h / 2!r}\n")
    with open(os.path.join(root, "sparse", "images.txt"), "w") as f:
        for i, p in enumerate(ps):
            q = rotmat_to_qvec(p["R"].T)
            f.write(f"{i + 1} {' '.join(repr(float(x)) for x in q)} "
                    f"{' '.join(repr(float(x)) for x in p['T'])} 1 {p['name']}.jpg\n0.0 0.0 -1\n")
    rng = np.random.default_rng(cfg["scene_seed"] + 3)
    with open(os.path.join(root, "sparse", "points3D.txt"), "w") as f:
        for i, x in enumerate(rng.uniform(-1, 1, (1000, 3)) * np.array(ROOM)):
            f.write(f"{i + 1} {float(x[0])!r} {float(x[1])!r} {float(x[2])!r} 128 128 128 0.0\n")
    every = int(cfg["test_every"])
    with open(os.path.join(root, "split.yml"), "w") as f:
        f.write("train:\n" + "".join(f"  - {p['name']}\n" for i, p in enumerate(ps)
                                     if i % every))
        f.write("test:\n" + "".join(f"  - {p['name']}\n" for i, p in enumerate(ps)
                                    if i % every == 0))
    return ps


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) quaternion of a rotation matrix."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q
