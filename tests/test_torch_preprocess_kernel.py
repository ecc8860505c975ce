"""The fused preprocess kernel (`csrc/preprocess.cu`, its wrapper
`ops/raster/fused_preprocess.py:preprocess_kernel`).

On the CPU: the wrapper runs the plain version for CPU tensors and counts
no launch, `rasterize` calls the wrapper unless an input requires grad, and
`check_inputs` rejects what the kernel does not take. On the card (marked
`cuda`, skipped elsewhere): the kernel against `preprocess_plain` on the
same CUDA tensors, bit for bit in every field, and `rasterize`'s launch
counts. On a GPU machine:

    python -m pytest tests/test_torch_preprocess_kernel.py -q
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from scorp_tpu_torch.core.camera import look_at_camera, make_camera
from scorp_tpu_torch.ops import raster
from scorp_tpu_torch.ops.raster import common
from scorp_tpu_torch.ops.raster.fused_preprocess import check_inputs, preprocess_kernel

W, H = 96, 72


def _scene(n, seed, device, bands=16):
    """Random rows around the origin, plus rows the camera below sees from
    behind (view z <= 0.2), rows that clip at the image border, a zero
    quaternion and opacities under 1/255."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, 3))
    k = n // 8
    xyz[:k, 2] = rng.uniform(-5.0, -3.25, k)              # behind or at the near cull
    xyz[k:2 * k, :2] = rng.uniform(-3.0, 3.0, (k, 2))     # past the image's edges
    scales = np.exp(rng.normal(np.log(0.06), 0.6, (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats[2 * k] = 0.0
    opa = rng.uniform(0.05, 0.99, n)
    opa[2 * k + 1:2 * k + 4] = [1e-3, 1.0 / 255.0, 1e-13]
    shs = rng.normal(0, 0.5, (n, bands, 3))
    f32 = dict(dtype=torch.float32, device=device)
    return [torch.as_tensor(a, **f32) for a in (xyz, scales, quats, opa, shs)]


def _camera(device):
    return look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H, device=device)


@pytest.fixture
def cpu_scene():
    return _scene(64, 3, "cpu"), _camera("cpu")


@pytest.fixture
def counters():
    """Restores the kernel's launch counter after a test."""
    saved = preprocess_kernel.launches
    yield preprocess_kernel
    preprocess_kernel.launches = saved


def _same(a, b):
    """Preprocessed fields equal bit for bit (NaN where NaN)."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype == torch.float32:
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
        assert torch.equal(x, y), f"{name}: {int((x != y).sum())} rows differ"


def _extra(case, n, device, bands=16):
    """The keyword arguments a case adds to an SH-3 call with scales and
    quats (`scales`/`quats` set to None where a covariance replaces them)."""
    gen = torch.Generator().manual_seed(n)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(device)

    return {
        "sh3": {},
        "sh0": {"sh_degree": 0},
        "sh1_of_16_bands": {"sh_degree": 1},
        "sh2": {"sh_degree": 2},
        "scale_modifier": {"scale_modifier": 1.7},
        "alive": {"alive": rand(n) < 0.7},
        "colors_precomp": {"colors_precomp": rand(n, 3)},
        "cov3d_precomp": {"cov3d_precomp": rand(n, 6) * 1e-3, "scales": None, "quats": None},
        "screen_deltas": {"screen_deltas": (rand(n, 2) - 0.5) * 0.05},
    }[case]


CPU_CASES = ["sh3", "sh0", "sh1_of_16_bands", "sh2", "scale_modifier", "alive",
             "colors_precomp", "cov3d_precomp", "screen_deltas", "sh4"]


@pytest.mark.parametrize("case", CPU_CASES)
def test_cpu_tensors_take_the_plain_version(cpu_scene, counters, case):
    """For CPU tensors the wrapper is the plain version (SH degree 4
    included, which the kernel does not take), and launches nothing."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    kw = dict(shs=shs, sh_degree=3, scales=scales, quats=quats)
    if case == "sh4":
        kw.update(shs=torch.rand(len(xyz), 25, 3), sh_degree=4)
    else:
        kw.update(_extra(case, len(xyz), "cpu"))
    before = counters.launches
    with torch.no_grad():
        got = preprocess_kernel(xyz, opa, cam, **kw)
    _same(got, common.preprocess_plain(xyz, opa, cam, **kw))
    assert counters.launches == before


PATH_CASES = {
    # case: (input that requires grad, grad mode, takes the kernel's wrapper)
    "eval": (None, True, True),
    "no_grad_mode": (None, False, True),
    "grad_input_under_no_grad": ("means3d", False, True),
    "grad_means3d": ("means3d", True, False),
    "grad_opacities": ("opacities", True, False),
    "grad_shs": ("shs", True, False),
    "grad_scales": ("scales", True, False),
    "grad_screen_deltas": ("screen_deltas", True, False),
    "grad_colors_precomp": ("colors_precomp", True, False),
}


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_rasterize_takes_the_kernel_unless_autograd_records(cpu_scene, monkeypatch, case):
    """`rasterize` calls `preprocess_kernel` where nothing needs grad and
    `preprocess_plain` otherwise; the grad path's gradients reach the leaf."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    n = len(xyz)
    grad_input, grad_mode, takes_kernel = PATH_CASES[case]
    args = dict(means3d=xyz, opacities=opa, shs=shs, sh_degree=3, scales=scales, quats=quats,
                screen_deltas=torch.zeros(n, 2))
    if grad_input == "colors_precomp":
        args.update(colors_precomp=torch.rand(n, 3), shs=None)
    if grad_input is not None:
        args[grad_input] = args[grad_input].clone().requires_grad_(True)
    calls = []

    def wrapper(*a, **kw):
        calls.append(1)
        return preprocess_kernel(*a, **kw)

    monkeypatch.setattr(raster, "preprocess_kernel", wrapper)
    with torch.set_grad_enabled(grad_mode):
        out = raster.rasterize(cam=cam, bg=torch.tensor([0.1, 0.2, 0.3]),
                               cfg=raster.RasterConfig(max_keys=1 << 12), **args)
    assert len(calls) == (1 if takes_kernel else 0)
    if grad_mode and grad_input is not None:
        (out.color.sum() + out.alpha.sum()).backward()
        assert args[grad_input].grad is not None
        assert torch.isfinite(args[grad_input].grad).all()


def test_rasterize_grad_path_is_the_plain_version(cpu_scene):
    """The gradients of `rasterize` equal those of the same call with the
    plain version put in the wrapper's place."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    bg = torch.tensor([0.1, 0.2, 0.3])

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (xyz, scales, quats, opa, shs)]
        out = raster.rasterize(leaves[0], leaves[3], cam, bg, shs=leaves[4], sh_degree=3,
                               scales=leaves[1], quats=leaves[2],
                               cfg=raster.RasterConfig(max_keys=1 << 12))
        (out.color.square().sum() + out.alpha.sum() + out.depth_accum.sum()).backward()
        return [t.grad for t in leaves]

    got = grads()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(raster, "preprocess_kernel", common.preprocess_plain)
        ref = grads()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _kernel_args(cpu_scene):
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    return dict(means3d=xyz, opacities=opa, cam=cam, shs=shs, sh_degree=3,
                colors_precomp=None, scales=scales, quats=quats, cov3d_precomp=None,
                screen_deltas=torch.zeros(len(xyz), 2),
                alive=torch.ones(len(xyz), dtype=torch.bool))


REJECTED = {
    # case: (change to valid CPU arguments, exception, its message)
    "float64_means3d": (lambda a: a.update(means3d=a["means3d"].double()), TypeError,
                        "means3d has dtype"),
    "scales_of_two_columns": (lambda a: a.update(scales=a["scales"][:, :2].contiguous()),
                              ValueError, "scales has shape"),
    "non_contiguous_quats": (lambda a: a.update(quats=a["quats"].t().contiguous().t()),
                             ValueError, "quats must be contiguous"),
    "non_contiguous_shs": (lambda a: a.update(shs=a["shs"].transpose(1, 2).contiguous()
                                              .transpose(1, 2)), ValueError,
                           "shs must be contiguous"),
    "too_few_bands": (lambda a: a.update(shs=a["shs"][:, :9].contiguous()), ValueError,
                      "cannot evaluate degree 3"),
    "sh_degree_4": (lambda a: a.update(sh_degree=4), ValueError, "SH degree of 0-3"),
    "int_alive": (lambda a: a.update(alive=a["alive"].int()), TypeError, "alive has dtype"),
    "short_opacities": (lambda a: a.update(opacities=a["opacities"][:-1]), RuntimeError,
                        "shape"),
    "float64_screen_deltas": (lambda a: a.update(screen_deltas=a["screen_deltas"].double()),
                              TypeError, "screen_deltas has dtype"),
    "non_contiguous_screen_deltas": (
        lambda a: a.update(screen_deltas=a["screen_deltas"].t().contiguous().t()), ValueError,
        "screen_deltas must be contiguous"),
    "float64_camera": (lambda a: a.update(cam=dataclasses.replace(
        a["cam"], campos=a["cam"].campos.double())), TypeError, "campos has dtype"),
    "non_contiguous_viewmatrix": (lambda a: a.update(cam=dataclasses.replace(
        a["cam"], viewmatrix=a["cam"].viewmatrix.t().contiguous().t())), ValueError,
        "viewmatrix must be contiguous"),
    "no_quats": (lambda a: a.update(quats=None), ValueError, "needs scales and quats"),
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_check_inputs_rejects_what_the_kernel_does_not_take(cpu_scene, case):
    args = _kernel_args(cpu_scene)
    check_inputs(**args)
    change, exc, message = REJECTED[case]
    change(args)
    with pytest.raises(exc, match=message):
        check_inputs(**args)


def test_wrapper_rejects_other_devices(cpu_scene, counters):
    args = _kernel_args(cpu_scene)
    args["means3d"] = args["means3d"].to("meta")
    before = counters.launches
    with pytest.raises(ValueError, match="supports cpu and cuda tensors, not meta"):
        preprocess_kernel(**args)
    assert counters.launches == before


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _singular_rows(device):
    """An axis-aligned 64x64 camera with focal length 64 (tan(fov/2) = 0.5)
    and rows on its axis at z = 1 whose covariance M Σ Mᵀ is -0.3 I exactly:
    after the 0.3 px dilation the 2D covariance is 0, det == 0. Beside them,
    rows with an ordinary covariance."""
    fov = 2.0 * math.atan(0.5)
    cam = make_camera(np.eye(3), np.zeros(3), fov, fov, 64, 64, device=device)
    assert float(cam.tanfovx) == 0.5 and float(cam.tanfovy) == 0.5
    n = 256
    rng = np.random.default_rng(11)
    xyz = np.concatenate([np.array([[0.0, 0.0, 1.0]] * 4), rng.uniform(-0.4, 0.4, (n - 4, 3))
                          + [0.0, 0.0, 2.0]])
    f32 = dict(dtype=torch.float32, device=device)
    cov = torch.as_tensor(rng.uniform(0.0, 1e-3, (n, 6)), **f32)
    cov[:, [1, 2, 4]] *= 0.1
    neg = -torch.tensor(0.3, dtype=torch.float32) / 4096.0
    cov[:4] = torch.tensor([neg, 0.0, 0.0, neg, 0.0, 0.0], **f32)
    return cam, torch.as_tensor(xyz, **f32), cov


CARD_CASES = {
    # case: (sh_degree, SH bands stored, what else the call gives)
    "sh0": (0, 1, {}),
    "sh1_of_16_bands": (1, 16, {}),
    "sh2_of_9_bands": (2, 9, {}),
    "sh3": (3, 16, {}),
    "sh3_scale_modifier": (3, 16, {"scale_modifier": 1.7}),
    "sh3_alive": (3, 16, {"alive": True}),
    "colors_precomp": (3, 16, {"colors_precomp": True}),
    "cov3d_precomp": (3, 16, {"cov3d_precomp": True}),
    "singular_cov2d": (3, 16, {"singular": True}),
    "screen_deltas": (3, 16, {"screen_deltas": True}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_bit_for_bit(dev, counters, case):
    """Every field equal bit for bit: no field needs the 2-ulp room an
    intrinsic could ask for, since the kernel calls the functions PyTorch's
    ops call (sqrtf, ceilf, logf, rsqrtf, IEEE division) in the plain
    version's order, without contracted multiply-adds.

    Exact equality of conic and color rests on more than that: on the
    order in which PyTorch's CUDA sum adds the four squares of the
    quaternion's norm and the three of the view direction's, an ATen
    detail that the kernel copies as measured under PyTorch 2.11 (the
    source's header). Under another PyTorch version a failure of those two
    fields alone, by an ulp or two, means that order changed, not that the
    kernel is wrong: the kernel's sums then follow the new order."""
    deg, bands, extra = CARD_CASES[case]
    n = 4099  # 32 full blocks and a partial one
    xyz, scales, quats, opa, shs = _scene(n, 7 + deg, dev, bands=bands)
    cam = _camera(dev)
    kw = dict(shs=shs, sh_degree=deg, scales=scales, quats=quats,
              scale_modifier=extra.get("scale_modifier", 1.0))
    if extra.get("alive"):
        kw["alive"] = torch.as_tensor(np.random.default_rng(5).uniform(size=n) < 0.7,
                                      device=dev)
    if extra.get("colors_precomp"):
        kw["colors_precomp"] = torch.rand(n, 3, device=dev)
    if extra.get("screen_deltas"):
        kw["screen_deltas"] = (torch.rand(n, 2, device=dev) - 0.5) * 0.05
    if extra.get("cov3d_precomp") or extra.get("singular"):
        if extra.get("singular"):
            cam, xyz, cov = _singular_rows(dev)
            n = len(xyz)
            opa, kw["shs"] = opa[:n], shs[:n]
        else:
            cov = common.compute_cov3d(scales, quats, 1.0)
        kw.update(cov3d_precomp=cov, scales=None, quats=None)
    ref = common.preprocess_plain(xyz, opa, cam, **kw)
    before = counters.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = preprocess_kernel(xyz, opa, cam, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert counters.launches == before + 1
    _same(got, ref)
    if extra.get("colors_precomp"):
        assert got.color is kw["colors_precomp"]
    if extra.get("singular"):
        assert not got.valid[:4].any() and (got.radii[:4] == 0).all()
        assert got.valid[4:].any()
    else:
        assert got.valid.any() and not got.valid.all()
        behind = (got.depth <= 0.2)
        assert behind.any() and not got.valid[behind].any()
        clipped = got.valid & ((got.rect[:, 0] == 0) | (got.rect[:, 2] == (W + 15) // 16))
        assert clipped.any()


@pytest.mark.cuda
def test_rasterize_launches_the_kernel_on_the_eval_path_only(dev, counters, monkeypatch):
    xyz, scales, quats, opa, shs = _scene(3000, 21, dev)
    cam = _camera(dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    cfg = raster.RasterConfig(max_keys=1 << 16)

    def render():
        return raster.rasterize(xyz, opa, cam, bg, shs=shs, sh_degree=3, scales=scales,
                                quats=quats, cfg=cfg)

    before = counters.launches
    with torch.no_grad():
        got = render()
    assert counters.launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(raster, "preprocess_kernel", common.preprocess_plain)
        with torch.no_grad():
            ref = render()
    assert counters.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    xyz.requires_grad_(True)
    render().color.sum().backward()
    assert counters.launches == before + 1
    assert xyz.grad is not None
