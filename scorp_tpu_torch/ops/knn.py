"""K-nearest-neighbor mean squared distance, port of `scorp_tpu.ops.knn`.

The reference trainer's `distCUDA2` (initial Gaussian scale estimation):
for each point, the mean of the squared distances to its 3 nearest
neighbours. Exact blocked brute force, as the JAX package computes it: the
pairwise distance is |q|^2 + |p|^2 - 2 q.p, whose cross term is one plain
`torch.matmul` per block (a library product outside any kernel, as the JAX
package leaves it to XLA), and a running top-k merge over point blocks
bounds memory to one [q_block, p_block] block (64 MiB at the defaults).
Deterministic.
"""

from __future__ import annotations

import torch

Q_BLOCK = 1024     # queries per outer step
P_BLOCK = 16384    # points per inner step


def knn_mean_dist2(points, k: int = 3, *, q_block: int = Q_BLOCK,
                   p_block: int = P_BLOCK) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, per point.

    points: [N, 3] (numpy or a tensor; the result lies on the tensor's
    device, the CPU for numpy). Returns [N] f32."""
    points = torch.as_tensor(points, dtype=torch.float32)
    n = points.shape[0]
    if n <= k:
        # degenerate: every other point is a neighbour
        d2 = ((points[:, None] - points[None]) ** 2).sum(-1)
        d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool, device=points.device), float("inf"))
        return torch.topk(d2, min(k, n - 1), dim=1, largest=False).values.mean(dim=1)

    sq = (points * points).sum(-1)
    idx = torch.arange(n, device=points.device)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for q0 in range(0, n, q_block):
        q, q2, qi = points[q0:q0 + q_block], sq[q0:q0 + q_block], idx[q0:q0 + q_block]
        best = torch.full((q.shape[0], k), float("inf"), device=points.device)
        for p0 in range(0, n, p_block):
            p, p2, pi = points[p0:p0 + p_block], sq[p0:p0 + p_block], idx[p0:p0 + p_block]
            d2 = q2[:, None] + p2[None, :] - 2.0 * torch.matmul(q, p.T)
            d2 = d2.masked_fill(qi[:, None] == pi[None, :], float("inf"))
            merged = torch.cat([best, d2], dim=1)
            best = torch.topk(merged, k, dim=1, largest=False).values
        out[q0:q0 + q_block] = best.mean(dim=1)
    return out
