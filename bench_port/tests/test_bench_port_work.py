"""The work model's counts on a tiny hand-made frame: the pairs and keys
the reference blends, and the parts' operations and bytes from them."""

import pytest
import torch

from bench_port import harness
from bench_port.reference import raster3d

RATES = {"f32_flops_per_s": 1.0, "hbm_bytes_per_s": 1.0, "pcie_bytes_per_s": 1.0}


def frame_of(opacities: list[float], tiles: list[tuple[int, int]]):
    """Flat Gaussians (conic 0: alpha = opacity at every pixel of the rect)
    at depths 1, 2, ... on a 32x16 image of two tiles; rect in tiles x."""
    n = len(opacities)
    table = torch.zeros(n, 10)
    table[:, 0], table[:, 1] = 8.0, 8.0
    table[:, 5:8] = 0.5
    table[:, 8] = torch.arange(1, n + 1, dtype=torch.float32)
    table[:, 9] = torch.tensor(opacities)
    rect = torch.tensor([[x0, 0, x1, 1] for x0, x1 in tiles])
    bins = raster3d.bin_tiles(table[:, 8], rect, torch.ones(n, dtype=torch.bool), 32, 16)
    return raster3d.forward(table, bins, torch.zeros(3), 32, 16)


def test_pairs_and_keys_by_hand():
    # A in tile 0, B in both: tile 0 blends A then B (T 0.5, 0.25), tile 1 B
    f = frame_of([0.5, 0.5], [(0, 1), (0, 2)])
    assert (f.pairs, f.keys) == (2 * 256 + 256, 3)
    assert torch.allclose(f.alpha[0, :, :16], torch.tensor(0.75))
    assert torch.allclose(f.alpha[0, :, 16:], torch.tensor(0.5))


def test_the_crossing_pair_is_walked_not_blended():
    # five at 0.95: T 0.05, 2.5e-3, 1.25e-4, then 6.25e-6 < 1e-4 ends the
    # pixel at the fourth, which is walked; the fifth is not
    f = frame_of([0.95] * 5, [(0, 1)] * 5)
    assert (f.pairs, f.keys) == (4 * 256, 5)
    assert torch.allclose(f.alpha[0, :, :16], torch.tensor(1 - 0.05 ** 3), atol=1e-6)


def test_below_threshold_is_neither_walked_nor_a_key():
    f = frame_of([0.5, 1.0 / 256.0], [(0, 1), (1, 2)])
    assert (f.pairs, f.keys) == (256, 1)


@pytest.mark.parametrize("part,flops,nbytes", [
    ("composite_fwd", 24 * 768, 40 * 3 + 8 * 2 + 4 * 7 * 512),
    ("composite_bwd", 45 * 768, 44 * 3 + 8 * 2 + 28 * 512 + 40 * 2),
    ("routing", 0, 16 * 2 + 3 * 56),
    ("adam", 12 * 2 * 59, 28 * 2 * 59),
    ("host_copy", 0, 12 * 512),
])
def test_part_costs(part, flops, nbytes):
    shape = dict(rows=2, param_floats=59, sh_coeffs=16, pixels=512, tiles=2, keys=3,
                 pairs=768, train=True)
    c = harness.work_part(part).cost(shape)
    assert (c["flops"], c["bytes"]) == (flops, nbytes)
    assert harness.least_seconds([part], shape, RATES)[part] == max(flops, nbytes)
