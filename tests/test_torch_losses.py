"""Port parity, losses: scorp_tpu_torch.ops.losses against scorp_tpu.ops.losses
on the same numpy inputs, values at 1e-6 and SSIM's gradient against
jax.grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.ops import losses as jl
from scorp_tpu_torch.ops import losses as tl

torch.set_num_threads(1)


def _images(seed, shape=(3, 40, 52)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    # a flat region and a blurred copy: SSIM's small-variance regime
    a[:, :12, :12] = 0.5
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


CASES = {
    "l1_loss": lambda a, b: (a, b),
    "l2_loss": lambda a, b: (a, b),
    "mse": lambda a, b: (a, b),
    "psnr": lambda a, b: (a, b),
    "ssim": lambda a, b: (a, b),
    "isotropic_loss": lambda a, b: (np.exp(a.reshape(-1, 3)),),
    "depth_normalize": lambda a, b: (a[:1] * 5.0 + 0.3,),
    "smooth_loss": lambda a, b: (a[:1], b),
    "pearson_depth_loss": lambda a, b: (a, b),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    args = CASES[name](*_images(3))
    ref = np.asarray(getattr(jl, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tl, name)(*(torch.from_numpy(x) for x in args)).numpy()
    assert got.shape == ref.shape
    # f32 sums in another order: 1e-6, relative to the value's size
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_ssim_gradient_matches_jax():
    a, b = _images(5)
    ref = np.asarray(jax.grad(lambda x: 1.0 - jl.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad(1.0 - tl.ssim(x, torch.from_numpy(b)), x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)


def test_ssim_of_identical_images_is_one():
    a, _ = _images(7)
    assert float(tl.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)
