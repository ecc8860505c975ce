"""Fixed-capacity Gaussian parameter store + Adam, port of
`scorp_tpu.train.state`.

Gaussians live in padded buffers of a capacity with an `alive` mask (dead
rows are zero and inert), so states compare row for row with the JAX
package's. The buffers are reallocated only when capacity grows
(`grow_capacity`, geometric), and clone/split/prune are masked scatters
into dead slots (`densify.py`).

The optimizer is torch.optim.Adam's update with eps=1e-15 and the
reference's per-group learning rates, with the reference's "surgery"
semantics: pruned rows keep nothing (their slots are reused with zeroed
moments), appended rows start with zero moments, and one global step
counter survives densification.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.camera import camera_from_numpy  # noqa: F401  (re-exported)
from ..core.plyio import GaussianData
from ..core.quat import quat_to_rotmat
from ..core.sh import rgb_to_sh, sh_to_rgb
from ..device import resolve_device
from ..ops.knn import knn_mean_dist2

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
STAT_KEYS = ("max_radii2d", "xyz_grad_accum", "denom")

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


class GaussianState(NamedTuple):
    """Padded Gaussian buffers (raw, pre-activation parameters). Rows with
    alive=False are inert."""

    params: dict[str, torch.Tensor]
    alive: torch.Tensor            # [C] bool
    max_radii2d: torch.Tensor      # [C] f32
    xyz_grad_accum: torch.Tensor   # [C] f32
    denom: torch.Tensor            # [C] f32

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round((self.params["f_rest"].shape[1] + 1) ** 0.5)) - 1

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


class AdamState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: int  # shared by every group (torch's per-tensor steps advance in lockstep)


def round_capacity(n: int, multiple: int = 4096) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def state_from_numpy(params: dict[str, np.ndarray], alive, device: str | torch.device = "cuda",
                     max_radii2d=None, xyz_grad_accum=None, denom=None) -> GaussianState:
    """Build a state from host arrays, e.g. the JAX package's
    `GaussianState` fields converted with np.asarray. Statistics buffers
    left out start at zero."""
    dev = resolve_device(device)
    missing = set(PARAM_KEYS) - set(params)
    if missing:
        raise KeyError(f"params lack {sorted(missing)}")
    tensors = {
        k: torch.as_tensor(np.array(params[k], np.float32), device=dev)
        for k in PARAM_KEYS
    }
    cap = tensors["xyz"].shape[0]

    def stat(a):
        if a is None:
            return torch.zeros(cap, device=dev)
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    return GaussianState(tensors, torch.as_tensor(np.array(alive, bool), device=dev),
                         stat(max_radii2d), stat(xyz_grad_accum), stat(denom))


def adam_from_numpy(m: dict[str, np.ndarray], v: dict[str, np.ndarray], step,
                    device: str | torch.device = "cuda") -> AdamState:
    """Adam moments from host arrays (e.g. the JAX package's AdamState)."""
    dev = resolve_device(device)

    def load(d):
        return {k: torch.as_tensor(np.array(d[k], np.float32), device=dev) for k in PARAM_KEYS}

    return AdamState(load(m), load(v), int(step))


def init_adam(state: GaussianState) -> AdamState:
    return AdamState(m={k: torch.zeros_like(v) for k, v in state.params.items()},
                     v={k: torch.zeros_like(v) for k, v in state.params.items()},
                     step=0)


def from_gaussian_data(g: GaussianData, capacity: int | None = None,
                       device: str | torch.device = "cuda") -> GaussianState:
    n = g.n
    cap = capacity or round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} gaussians")

    def pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    params = {k: pad(getattr(g, k).astype(np.float32)) for k in PARAM_KEYS}
    return state_from_numpy(params, pad(np.ones(n, bool)), device=device)


def to_gaussian_data(state: GaussianState) -> GaussianData:
    """Compact the padded buffers back to host-side numpy (alive rows only)."""
    idx = state.alive.nonzero()[:, 0]
    p = {k: v[idx].cpu().numpy() for k, v in state.params.items()}
    return GaussianData(
        xyz=p["xyz"], f_dc=p["f_dc"], f_rest=p["f_rest"],
        opacity=p["opacity"], scaling=p["scaling"], rotation=p["rotation"],
    )


def from_point_cloud(points: np.ndarray, colors: np.ndarray, max_sh_degree: int = 3,
                     capacity: int | None = None, surfel: bool = False,
                     device: str | torch.device = "cuda") -> GaussianState:
    """Initialize like the reference's `create_from_pcd`: SH DC from RGB,
    isotropic log-scales from sqrt of the 3-NN mean squared distance
    (`knn_mean_dist2`, run on `device`), identity rotations (random for
    surfels), opacity 0.1."""
    dev = resolve_device(device)
    n = points.shape[0]
    k = (max_sh_degree + 1) ** 2
    f_dc = rgb_to_sh(np.asarray(colors, np.float32)).reshape(n, 1, 3)
    f_rest = np.zeros((n, k - 1, 3), np.float32)

    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dist2 = knn_mean_dist2(pts).cpu().numpy()
    scale1d = np.log(np.sqrt(np.clip(dist2, 1e-7, None)))
    scaling = np.repeat(scale1d[:, None], 2 if surfel else 3, axis=1).astype(np.float32)

    if surfel:
        rotation = np.random.default_rng(0).random((n, 4)).astype(np.float32)
    else:
        rotation = np.zeros((n, 4), np.float32)
        rotation[:, 0] = 1.0
    opacity = np.full((n, 1), np.log(0.1 / 0.9), np.float32)  # inverse_sigmoid(0.1)

    g = GaussianData(
        xyz=np.asarray(points, np.float32), f_dc=f_dc, f_rest=f_rest,
        opacity=opacity, scaling=scaling, rotation=rotation,
    )
    return from_gaussian_data(g, capacity, device=dev)


def grow_capacity(state: GaussianState, adam: AdamState, new_capacity: int):
    """Capacity bump: every buffer (parameters, statistics, moments) is
    reallocated together; values are kept and the new rows are dead/zero."""
    if new_capacity <= state.capacity:
        raise ValueError(f"new capacity {new_capacity} <= {state.capacity}")
    pad_rows = new_capacity - state.capacity

    def pad(x):
        return torch.cat([x, x.new_zeros((pad_rows,) + x.shape[1:])], dim=0)

    new_state = GaussianState({k: pad(v) for k, v in state.params.items()},
                              *(pad(x) for x in state[1:]))
    new_adam = AdamState({k: pad(v) for k, v in adam.m.items()},
                         {k: pad(v) for k, v in adam.v.items()}, adam.step)
    return new_state, new_adam


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0) -> float:
    """Log-linear LR decay with optional sine-eased delay (the reference's
    get_expon_lr_func), on the host."""
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    return delay * log_lerp


def adam_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                adam: AdamState, lrs: dict[str, Any], frozen: tuple[str, ...] = ()):
    """One Adam step over the parameter dict with per-group learning rates:
    torch.optim.Adam(eps=1e-15)'s update, each operation rounded as in the
    JAX package's. `frozen` groups keep params and moments untouched.
    Returns new tensors; the inputs are not modified."""
    step = adam.step + 1
    # bias corrections in f32, as the JAX package computes them
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(step))
    new_params, new_m, new_v = {}, {}, {}
    for k in params:
        if k in frozen:
            new_params[k], new_m[k], new_v[k] = params[k], adam.m[k], adam.v[k]
            continue
        g = grads[k]
        m = ADAM_B1 * adam.m[k] + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * adam.v[k] + (1.0 - ADAM_B2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        new_params[k] = params[k] - lrs[k] * update
        new_m[k], new_v[k] = m, v
    return new_params, AdamState(new_m, new_v, step)


def get_normal(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-gaussian unit normal: the rotation column of the smallest scale
    axis (the third frame axis for surfels, which have 2 scale columns)."""
    R = quat_to_rotmat(params["rotation"])
    s = torch.exp(params["scaling"])
    if s.shape[1] == 2:
        n = R[:, :, 2]
    else:
        axis = torch.argmin(s, dim=-1)
        n = torch.take_along_dim(R, axis[:, None, None], dim=2)[:, :, 0]
    return n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-12)


def get_color(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """DC-band RGB of each gaussian (SH2RGB of f_dc)."""
    return rgb_to_sh_inv(params["f_dc"][:, 0, :])


def rgb_to_sh_inv(sh):
    """SH DC coefficients -> RGB (the inverse of `rgb_to_sh`)."""
    return sh_to_rgb(sh)
