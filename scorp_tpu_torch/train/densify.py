"""Densification (clone/split) + pruning over fixed-capacity buffers, port
of `scorp_tpu.train.densify`.

The reference's adaptive density control with its reallocation replaced by
masked scatters into dead slots:

  * clone: screen-grad >= threshold AND max scale <= percent_dense*extent
    -> a verbatim copy is appended;
  * split: screen-grad >= threshold AND max scale > percent_dense*extent
    -> n_split children at xyz + R·(noise·scale), child scale =
    scale/(0.8·n_split), the original removed;
  * prune: opacity < min_opacity, plus (with a size threshold) world size
    > 0.1·extent; the screen-radius prune is a no-op in the reference
    (max_radii2D is zeroed right before it) and stays behind
    `use_radii_prune`;
  * bookkeeping: the statistics buffers restart at zero, appended rows get
    zero moments and survivors keep theirs.

Free slots are taken in index order; candidates that find no free slot are
counted as dropped so the caller can grow capacity. The children's noise is
drawn from an explicit `torch.Generator`, or handed in as tensors (the
tests pass the JAX package's draws).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from ..core.quat import quat_to_rotmat
from .state import AdamState, GaussianState


def _inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def _screen_grads(state: GaussianState) -> torch.Tensor:
    grads = state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0)
    return torch.where(state.denom > 0, grads, torch.zeros_like(grads))


def densify_and_prune(
    state: GaussianState,
    adam: AdamState,
    rng: torch.Generator | Sequence[torch.Tensor],
    max_grad: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    max_screen_size: float = 0.0,
    use_size_threshold: bool = False,
    use_radii_prune: bool = False,
    n_split: int = 2,
):
    """Returns (state, adam, dropped) with `dropped` the [] int64 count of
    candidates that found no free slot. `rng` is a torch.Generator on the
    state's device, or `n_split` standard-normal [C, 3] tensors."""
    cap = state.capacity
    p = state.params
    alive = state.alive
    dev = alive.device

    s = torch.exp(p["scaling"])
    max_s = s.max(dim=1).values
    hot = alive & (_screen_grads(state) >= max_grad)
    clone_sel = hot & (max_s <= percent_dense * extent)
    split_sel = hot & (max_s > percent_dense * extent)

    def prune_of(opacity_logit, scaling_log):
        pr = torch.sigmoid(opacity_logit[:, 0]) < min_opacity
        if use_size_threshold:
            pr = pr | (torch.exp(scaling_log).max(dim=1).values > 0.1 * extent)
            if use_radii_prune:  # radii are zeroed before the prune (see module doc)
                pr = pr | (torch.zeros_like(state.max_radii2d) > max_screen_size)
        return pr

    pr_orig = prune_of(p["opacity"], p["scaling"])
    survivors = alive & ~split_sel & ~pr_orig

    if s.shape[1] == 2:  # surfel: the third axis has zero std
        std3 = torch.cat([s, s.new_zeros(cap, 1)], dim=1)
    else:
        std3 = s
    if isinstance(rng, torch.Generator):
        noise = [torch.randn(cap, 3, generator=rng, device=dev) for _ in range(n_split)]
    else:
        noise = list(rng)
        if len(noise) != n_split:
            raise ValueError(f"{len(noise)} noise tensors for n_split={n_split}")
    R = quat_to_rotmat(p["rotation"])
    child_scaling = torch.log(s / (0.8 * n_split))
    clone_keep = clone_sel & ~pr_orig
    child_keep = split_sel & ~prune_of(p["opacity"], child_scaling)

    # free slots first, in index order
    free = ~survivors
    slot_list = torch.argsort((~free).to(torch.int8), stable=True)
    n_free = free.sum()
    n_clone = clone_keep.sum()
    n_child = child_keep.sum()

    new_params = {k: v.clone() for k, v in p.items()}
    new_m = {k: v.clone() for k, v in adam.m.items()}
    new_v = {k: v.clone() for k, v in adam.v.items()}
    new_alive = survivors.clone()

    def scatter_group(sel, rank_offset, values):
        rank = torch.cumsum(sel.to(torch.int64), 0) - 1 + rank_offset
        ok = sel & (rank < n_free)
        target = slot_list[rank[ok]]
        for k in new_params:
            new_params[k][target] = values[k][ok]
            new_m[k][target] = 0.0
            new_v[k][target] = 0.0
        new_alive[target] = True
        return ok.sum()

    placed = scatter_group(clone_keep, 0, p)
    for j in range(n_split):
        eps = noise[j].to(std3.dtype) * std3
        child = dict(p)
        child["xyz"] = p["xyz"] + torch.einsum("nij,nj->ni", R, eps)
        child["scaling"] = child_scaling
        placed = placed + scatter_group(child_keep, n_clone + j * n_child, child)

    dropped = n_clone + n_split * n_child - placed
    zeros = torch.zeros(cap, device=dev)
    new_state = GaussianState(new_params, new_alive, zeros, zeros.clone(), zeros.clone())
    return new_state, AdamState(new_m, new_v, adam.step), dropped


def reset_opacity(state: GaussianState, adam: AdamState, num_frozen: int = 0):
    """opacity <- inverse_sigmoid(min(opacity, 0.01)) on alive rows past the
    first `num_frozen`; the opacity moments restart at zero."""
    op = torch.sigmoid(state.params["opacity"])
    new_logit = _inverse_sigmoid(torch.clamp_max(op, 0.01))
    row = torch.arange(state.capacity, device=op.device)[:, None]
    resettable = state.alive[:, None] & (row >= num_frozen)
    params = dict(state.params)
    params["opacity"] = torch.where(resettable, new_logit, params["opacity"])
    m, v = dict(adam.m), dict(adam.v)
    m["opacity"] = torch.zeros_like(m["opacity"])
    v["opacity"] = torch.zeros_like(v["opacity"])
    return state._replace(params=params), AdamState(m, v, adam.step)


def accumulate_stats(state: GaussianState, screen_grad_ndc: torch.Tensor,
                     radii: torch.Tensor) -> GaussianState:
    """Per-iteration densification statistics over visible gaussians:
    max_radii2D <- max(max_radii2D, radii), xyz_grad_accum += ||ndc screen
    grad||, denom += 1."""
    visible = radii > 0
    gnorm = torch.sqrt((screen_grad_ndc * screen_grad_ndc).sum(-1))
    return state._replace(
        max_radii2d=torch.where(visible, torch.maximum(state.max_radii2d, radii.float()),
                                state.max_radii2d),
        xyz_grad_accum=torch.where(visible, state.xyz_grad_accum + gnorm,
                                   state.xyz_grad_accum),
        denom=torch.where(visible, state.denom + 1.0, state.denom),
    )


class OpacityTracker:
    """The reference's `reset_tracking_opacity`: keeps a bank of the last 3
    opacity snapshots; rows whose tracked minimum stays above 0.7 are
    latched "always high" and reset to 0.99 instead of 0.01."""

    def __init__(self, capacity: int, max_bank_size: int = 3, device="cuda"):
        self.max_bank_size = max_bank_size
        self.bank = None
        self.always_high = torch.zeros(capacity, dtype=torch.bool, device=device)

    def _grow(self, capacity: int):
        """New rows join un-latched; their bank entries are 0, so the
        current bank epoch can never latch them."""
        pad = capacity - self.always_high.shape[0]
        if pad <= 0:
            return
        self.always_high = torch.cat([self.always_high, self.always_high.new_zeros(pad)])
        if self.bank is not None:
            self.bank = torch.cat([self.bank, self.bank.new_zeros(pad, self.bank.shape[1])])

    def reset(self, state: GaussianState, adam: AdamState):
        self._grow(state.params["opacity"].shape[0])
        op = torch.sigmoid(state.params["opacity"])  # [C, 1]
        self.bank = op if self.bank is None else torch.cat([self.bank, op], dim=1)
        one = torch.ones((), device=op.device)
        if self.bank.shape[1] == self.max_bank_size:
            track_min = self.bank.min(dim=1).values
            self.bank = op
            self.always_high = self.always_high | (track_min > 0.7)
            ratio = float(self.always_high.sum()) / self.always_high.shape[0]
            print(f"always high ratio: {ratio}")
            new_op = torch.where(self.always_high[:, None], 0.99 * one, op)
        else:
            new_op = torch.where(self.always_high[:, None], op, 0.01 * one)
        params = dict(state.params)
        params["opacity"] = torch.where(state.alive[:, None], _inverse_sigmoid(new_op),
                                        params["opacity"])
        m, v = dict(adam.m), dict(adam.v)
        m["opacity"] = torch.zeros_like(m["opacity"])
        v["opacity"] = torch.zeros_like(v["opacity"])
        return state._replace(params=params), AdamState(m, v, adam.step)


def count_densify_candidates(state: GaussianState, max_grad: float) -> torch.Tensor:
    """Upper bound on rows the next densify adds (clones + 2 children), to
    pre-grow capacity so no candidate is ever dropped."""
    hot = state.alive & (_screen_grads(state) >= max_grad)
    return 2 * hot.sum()
