"""The fused surfel preprocess kernel (`csrc/surfel_preprocess.cu`, its
wrapper `ops/raster/fused_surfel_preprocess.py:preprocess_surfel_kernel`).

On the CPU: the wrapper returns what the plain stages `preprocess_surfel`,
`surfel_table` and `surfel_cull_ellipses` return and counts no launch,
`rasterize_surfel` calls the wrapper unless an input requires grad and the
plain stages otherwise, and `check_inputs` rejects what the kernel does not
take. On the card (marked `cuda`, skipped elsewhere): the kernel against
the plain stages on the same CUDA tensors, bit for bit in every field, K1's
keys from its ellipses, the union cull's float64 brute force through it,
and `rasterize_surfel`'s launch counts. On a GPU machine:

    python -m pytest tests/test_torch_surfel_preprocess_kernel.py -q
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from scorp_tpu_torch.core.camera import look_at_camera
from scorp_tpu_torch.ops import raster
from scorp_tpu_torch.ops.raster import surfel
from scorp_tpu_torch.ops.raster.fused_surfel_preprocess import (
    check_inputs,
    preprocess_surfel_kernel,
    zrow_order,
)

W, H = 96, 72
EDGE_ON = 8  # rows seen exactly edge-on, at x = 0 with their normal along x


def _scene(n, seed, device, bands=16):
    """Random surfels around the origin (scales [n, 2]), plus rows the
    camera below sees from behind (view z <= 0.2), rows that clip at the
    image border, rows seen edge-on (in the plane x = 0 that holds the
    camera, their normal along x), a zero quaternion and opacities under
    1/255."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, 3))
    k = n // 8
    xyz[:k, 2] = rng.uniform(-5.0, -3.25, k)              # behind or at the near cull
    xyz[k:2 * k, :2] = rng.uniform(-3.0, 3.0, (k, 2))     # past the image's edges
    scales = np.exp(rng.normal(np.log(0.08), 0.6, (n, 2)))
    quats = rng.normal(size=(n, 4))
    quats[2 * k] = 0.0
    edge = slice(2 * k + 4, 2 * k + 4 + EDGE_ON)
    xyz[edge, 0] = 0.0
    quats[edge] = [math.cos(math.pi / 4), 0.0, math.sin(math.pi / 4), 0.0]  # z -> x
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
    saved = preprocess_surfel_kernel.launches
    yield preprocess_surfel_kernel
    preprocess_surfel_kernel.launches = saved


def _ulps(x, y):
    """The largest distance in float32 steps between two float tensors (NaN
    against NaN is 0; NaN against a number the largest int)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(x) - ordered(y)).abs()
    both_nan = torch.isnan(x) & torch.isnan(y)
    return int(torch.where(both_nan, 0, d).max()) if d.numel() else 0


def _same(got, ref):
    """SurfelFrame fields equal bit for bit (NaN where NaN); the message
    names every field that differs, its rows and its largest distance in
    float32 steps."""
    bad = []
    for name in ref._fields:
        x, y = getattr(got, name), getattr(ref, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype == torch.float32:
            xi, yi = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
            rows = (xi != yi).reshape(len(x), -1).any(dim=1)
            if rows.any():
                cols = (xi != yi).reshape(len(x), -1).any(dim=0).nonzero().flatten().tolist()
                bad.append(f"{name}: {int(rows.sum())} rows differ (columns {cols}), "
                           f"{_ulps(x, y)} ulps at most")
        elif not torch.equal(x, y):
            bad.append(f"{name}: {int((x != y).reshape(len(x), -1).any(dim=1).sum())} rows "
                       f"differ")
    assert not bad, "; ".join(bad)


def _plain(xyz, opa, cam, **kw):
    """The plain stages, each called as `rasterize_surfel`'s grad path calls
    them."""
    prep = surfel.preprocess_surfel(xyz, opa, cam, **kw)
    ell, circ = surfel.surfel_cull_ellipses(prep)
    return surfel.SurfelFrame(prep.xy, prep.depth, prep.rect, prep.valid, prep.radii,
                              surfel.surfel_table(prep), ell, circ)


def _extra(case, n, device):
    """The keyword arguments a case adds to an SH-3 call with scales and
    quats."""
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
        "screen_deltas": {"screen_deltas": (rand(n, 2) - 0.5) * 0.05},
    }[case]


CPU_CASES = ["sh3", "sh0", "sh1_of_16_bands", "sh2", "scale_modifier", "alive",
             "colors_precomp", "screen_deltas", "sh4"]


@pytest.mark.parametrize("case", CPU_CASES)
def test_cpu_tensors_take_the_plain_stages(cpu_scene, counters, case):
    """For CPU tensors the wrapper returns what the three plain stages
    return (SH degree 4 included, which the kernel does not take), and
    launches nothing."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    kw = dict(shs=shs, sh_degree=3, scales=scales, quats=quats)
    if case == "sh4":
        kw.update(shs=torch.rand(len(xyz), 25, 3), sh_degree=4)
    else:
        kw.update(_extra(case, len(xyz), "cpu"))
    before = counters.launches
    with torch.no_grad():
        got = preprocess_surfel_kernel(xyz, opa, cam, **kw)
        ref = _plain(xyz, opa, cam, **kw)
    _same(got, ref)
    assert torch.equal(got.xy, got.table[:, 12:14])
    assert counters.launches == before


def test_scene_holds_the_edge_cases(cpu_scene):
    """The scene the tests share reaches each branch: rows behind the near
    plane and under 1/255 are not valid, rows past the border are clipped,
    the zero quaternion is a valid identity frame, the edge-on rows see
    their normal at a right angle (|cos| of ray and normal ~0), and some
    conics are force-kept (threshold 1e30)."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    k = len(xyz) // 8
    with torch.no_grad():
        got = preprocess_surfel_kernel(xyz, opa, cam, shs=shs, sh_degree=3, scales=scales,
                                       quats=quats)
    behind = got.depth <= 0.2
    assert behind.any() and not got.valid[behind].any()
    assert not got.valid[2 * k + 1] and not got.valid[2 * k + 3]  # opacities 1e-3, 1e-13
    clipped = got.valid & ((got.rect[:, 0] == 0) | (got.rect[:, 2] == (W + 15) // 16))
    assert clipped.any()
    assert got.valid[2 * k] and torch.isfinite(got.table[2 * k]).all()
    edge = slice(2 * k + 4, 2 * k + 4 + EDGE_ON)
    view = torch.nn.functional.normalize(xyz[edge] - cam.campos, dim=1)
    normal_world = got.table[edge, 17:20] @ cam.viewmatrix[:3, :3].T
    assert float((view * normal_world).sum(dim=1).abs().max()) < 1e-3
    force_kept = got.ell[:, 5] > 1e29
    assert force_kept.any()


PATH_CASES = {
    # case: (input that requires grad, grad mode, takes the kernel's wrapper)
    "eval": (None, True, True),
    "no_grad_mode": (None, False, True),
    "grad_input_under_no_grad": ("means3d", False, True),
    "grad_means3d": ("means3d", True, False),
    "grad_opacities": ("opacities", True, False),
    "grad_shs": ("shs", True, False),
    "grad_scales": ("scales", True, False),
    "grad_quats": ("quats", True, False),
    "grad_screen_deltas": ("screen_deltas", True, False),
    "grad_colors_precomp": ("colors_precomp", True, False),
}


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_rasterize_surfel_takes_the_kernel_unless_autograd_records(cpu_scene, monkeypatch,
                                                                    case):
    """`rasterize_surfel` calls `preprocess_surfel_kernel` where nothing
    needs grad, and the plain stages, which autograd records, otherwise;
    the grad path's gradients reach the leaf."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    n = len(xyz)
    grad_input, grad_mode, takes_kernel = PATH_CASES[case]
    args = dict(means3d=xyz, opacities=opa, shs=shs, sh_degree=3, scales=scales, quats=quats,
                screen_deltas=torch.zeros(n, 2))
    if grad_input == "colors_precomp":
        args.update(colors_precomp=torch.rand(n, 3), shs=None)
    if grad_input is not None:
        args[grad_input] = args[grad_input].clone().requires_grad_(True)
    calls = {"kernel": 0, "plain": 0, "cull": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(raster, "preprocess_surfel_kernel",
                        counted("kernel", preprocess_surfel_kernel))
    monkeypatch.setattr(raster, "preprocess_surfel", counted("plain", surfel.preprocess_surfel))
    monkeypatch.setattr(raster, "surfel_cull_ellipses",
                        counted("cull", surfel.surfel_cull_ellipses))
    with torch.set_grad_enabled(grad_mode):
        out = raster.rasterize_surfel(cam=cam, bg=torch.tensor([0.1, 0.2, 0.3]),
                                      cfg=raster.RasterConfig(max_keys=1 << 12), **args)
    want = 1 if takes_kernel else 0
    assert calls == {"kernel": want, "plain": 1 - want, "cull": 1 - want}
    if grad_mode and grad_input is not None:
        (out.color.sum() + out.alpha.sum() + out.normal.sum()).backward()
        assert args[grad_input].grad is not None
        assert torch.isfinite(args[grad_input].grad).all()


def test_eval_path_equals_the_grad_paths_stages(cpu_scene):
    """The eval path through the wrapper renders what the same call renders
    with the plain stages in the wrapper's place, bit for bit."""
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    bg = torch.tensor([0.1, 0.2, 0.3])
    kw = dict(shs=shs, sh_degree=3, scales=scales, quats=quats,
              cfg=raster.RasterConfig(max_keys=1 << 12))
    got = raster.rasterize_surfel(xyz, opa, cam, bg, **kw)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(raster, "preprocess_surfel_kernel", _plain)
        ref = raster.rasterize_surfel(xyz, opa, cam, bg, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert float(got.alpha.mean()) > 0.01


def _kernel_args(cpu_scene):
    (xyz, scales, quats, opa, shs), cam = cpu_scene
    return dict(means3d=xyz, opacities=opa, cam=cam, shs=shs, sh_degree=3,
                colors_precomp=None, scales=scales, quats=quats,
                screen_deltas=torch.zeros(len(xyz), 2),
                alive=torch.ones(len(xyz), dtype=torch.bool))


REJECTED = {
    # case: (change to valid CPU arguments, exception, its message)
    "float64_means3d": (lambda a: a.update(means3d=a["means3d"].double()), TypeError,
                        "means3d has dtype"),
    "scales_of_three_columns": (lambda a: a.update(scales=torch.cat(
        [a["scales"], a["scales"][:, :1]], dim=1)), ValueError, "scales has shape"),
    "non_contiguous_scales": (lambda a: a.update(scales=a["scales"].t().contiguous().t()),
                              ValueError, "scales must be contiguous"),
    "non_contiguous_quats": (lambda a: a.update(quats=a["quats"].t().contiguous().t()),
                             ValueError, "quats must be contiguous"),
    "non_contiguous_shs": (lambda a: a.update(shs=a["shs"].transpose(1, 2).contiguous()
                                              .transpose(1, 2)), ValueError,
                           "shs must be contiguous"),
    "too_few_bands": (lambda a: a.update(shs=a["shs"][:, :9].contiguous()), ValueError,
                      "cannot evaluate degree 3"),
    "sh_degree_4": (lambda a: a.update(sh_degree=4), ValueError, "SH degree of 0-3"),
    "float64_colors_precomp": (lambda a: a.update(colors_precomp=torch.rand(
        len(a["means3d"]), 3, dtype=torch.float64)), TypeError, "colors_precomp has dtype"),
    "colors_precomp_of_four_columns": (lambda a: a.update(colors_precomp=torch.rand(
        len(a["means3d"]), 4)), ValueError, "colors_precomp has shape"),
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
    "no_scales": (lambda a: a.update(scales=None), ValueError, "needs scales and quats"),
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_check_inputs_rejects_what_the_kernel_does_not_take(cpu_scene, case):
    args = _kernel_args(cpu_scene)
    check_inputs(**args)
    change, exc, message = REJECTED[case]
    change(args)
    with pytest.raises(exc, match=message):
        check_inputs(**args)


def test_check_inputs_takes_colours_beside_unread_shs(cpu_scene):
    """With colours given, the SH coefficients are not read, so not checked."""
    args = _kernel_args(cpu_scene)
    args.update(colors_precomp=torch.rand(len(args["means3d"]), 3), shs=None, sh_degree=7)
    check_inputs(**args)


def test_wrapper_rejects_other_devices(cpu_scene, counters):
    args = _kernel_args(cpu_scene)
    args["means3d"] = args["means3d"].to("meta")
    before = counters.launches
    with pytest.raises(ValueError, match="supports cpu and cuda tensors, not meta"):
        preprocess_surfel_kernel(**args)
    assert counters.launches == before


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


CARD_CASES = {
    # case: (sh_degree, SH bands stored, what else the call gives)
    "sh0": (0, 1, {}),
    "sh1_of_16_bands": (1, 16, {}),
    "sh2_of_9_bands": (2, 9, {}),
    "sh3": (3, 16, {}),
    "sh3_scale_modifier": (3, 16, {"scale_modifier": 1.7}),
    "sh3_alive": (3, 16, {"alive": True}),
    "sh3_opacities_n1": (3, 16, {"opacities_n1": True}),
    "colors_precomp": (3, 16, {"colors_precomp": True}),
    "screen_deltas": (3, 16, {"screen_deltas": True}),
    # room's row count, where cuBLAS's sgemv splits zrow's terms otherwise
    "sh3_1503232_rows": (3, 16, {"n": 1503232}),
    # a 3DGS state's first two scale columns: strided, copied by the wrapper
    "sh3_strided_scales": (3, 16, {"strided_scales": True}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_bit_for_bit(dev, counters, case):
    """Every field equal bit for bit, `rect`, `radii` and `valid` on every
    row: the kernel calls the functions PyTorch's ops call (sqrtf, ceilf,
    logf, log2f, rsqrtf, IEEE division) in the plain stages' order, and
    repeats with explicit multiply-adds the ones that cuBLAS (M, zrow, the
    view normal) and PyTorch's cross product kernel contract.

    Exact equality of the table's adjugate, zrow and normal columns, and of
    everything made from M, rests on those orders, measured on an H100
    under PyTorch 2.11 and its cuBLAS (the source's header; zrow's by
    `zrow_order` at the call's row count, found before the checked call,
    since it reads its probe back once). Under another version a failure of
    those fields alone, by an ulp or a few, means the order changed, not
    that the kernel is wrong."""
    deg, bands, extra = CARD_CASES[case]
    n = extra.get("n", 4099)  # 4099: 32 full blocks and a partial one
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
    if extra.get("opacities_n1"):
        opa = opa[:, None].contiguous()
    if extra.get("strided_scales"):
        kw["scales"] = torch.cat([scales, scales[:, :1]], dim=1)[:, :2]
        assert not kw["scales"].is_contiguous()
    ref = _plain(xyz, opa, cam, **kw)
    assert zrow_order(n, dev) == zrow_order(n, dev) in (0, 1)
    before = counters.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = preprocess_surfel_kernel(xyz, opa, cam, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert counters.launches == before + 1
    _same(got, ref)
    assert got.valid.any() and not got.valid.all()
    behind = got.depth <= 0.2
    assert behind.any() and not got.valid[behind].any()
    assert (got.ell[:, 5] > 1e29).any() and (got.ell[:, 5] < 1e29).any()


@pytest.mark.cuda
def test_k1_keeps_the_same_keys_from_the_kernels_ellipses(dev):
    """K1 (the CUDA kernel) culls the same keys, and the routing is the
    same, from the kernel's ellipses as from the plain stages'."""
    from scorp_tpu_torch.ops.raster.expand import expand_inputs, expand_keys

    n = 20000
    xyz, scales, quats, opa, shs = _scene(n, 17, dev)
    cam = _camera(dev)
    kw = dict(shs=shs, sh_degree=3, scales=scales, quats=quats)
    got = preprocess_surfel_kernel(xyz, opa, cam, **kw)
    ref = _plain(xyz, opa, cam, **kw)
    k_cap = 1 << 20
    keys = []
    for p in (got, ref):
        x = expand_inputs(p, W, H, k_cap, True, p.ell, p.circ)
        keys.append(torch.sort(expand_keys(x)[0]).values)
    assert torch.equal(keys[0], keys[1])
    cfg = raster.RasterConfig(max_keys=k_cap)
    r0 = raster.route_stream(got, W, H, cfg, geo=got.ell, geo2=got.circ)
    r1 = raster.route_stream(ref, W, H, cfg, geo=ref.ell, geo2=ref.circ)
    for a, b in zip(r0, r1):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_union_cull_drops_no_contributing_key(dev):
    """tests/test_torch_surfel.py's cull check through the kernel: on large
    rotated anisotropic surfels, every key that K1 culls with the kernel's
    two ellipses has alpha < 1/255 at every pixel of its tile, by the
    compositor's alpha formula in float64 on the plain stages' M."""
    from scorp_tpu_torch.ops.raster.common import grid_dims
    from scorp_tpu_torch.ops.raster.expand import expand_inputs, expand_keys

    rng = np.random.default_rng(7)
    n, w, h = 160, 320, 240
    cam = look_at_camera([0, 0, -3], [0, 0, 0], [0, 1, 0], 0.9, 0.8, w, h, device=dev)
    xyz = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    scales = np.stack([rng.uniform(0.02, 0.8, n), rng.uniform(0.005, 0.1, n)],
                      axis=1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=1, keepdims=True)
    opa = rng.uniform(0.05, 0.99, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (xyz, opa, colors, scales, quats)]
    kw = dict(colors_precomp=args[2], scales=args[3], quats=args[4])
    frame = preprocess_surfel_kernel(args[0], args[1], cam, **kw)
    prep = surfel.preprocess_surfel(args[0], args[1], cam, **kw)
    k_cap = 1 << 15
    x0 = expand_inputs(frame, w, h, k_cap, cull=False)
    x1 = expand_inputs(frame, w, h, k_cap, cull=True, geo=frame.ell, geo2=frame.circ)
    assert int(x0.total) <= k_cap
    keys0, kept0 = expand_keys(x0)
    keys1, kept1 = expand_keys(x1)
    sentinel = x0.num_tiles << x0.bits_g
    culled = ((keys0 != sentinel) & (keys1 == sentinel)).cpu().numpy()
    assert int(kept1) < int(kept0)
    idx = np.nonzero(culled)[0]
    assert idx.size > 0

    keys0 = keys0.cpu().numpy().astype(np.int64)
    tile = keys0[idx] >> x0.bits_g
    gi = x0.order.cpu().numpy()[keys0[idx] & ((1 << x0.bits_g) - 1)]
    tiles_x = grid_dims(w, h)[0]
    M = prep.M.cpu().numpy().astype(np.float64)
    xy = frame.xy.cpu().numpy().astype(np.float64)
    bad, worst = 0, 0.0
    for k in range(idx.size):
        g = gi[k]
        tx, ty = tile[k] % tiles_x, tile[k] // tiles_x
        PX, PY = np.meshgrid(np.arange(tx * 16, tx * 16 + 16, dtype=np.float64),
                             np.arange(ty * 16, ty * 16 + 16, dtype=np.float64))
        r1, r2, r3 = M[g]
        s = np.cross(r1[None, None] - PX[..., None] * r3[None, None],
                     r2[None, None] - PY[..., None] * r3[None, None])
        sz = np.where(np.abs(s[..., 2]) > 1e-9, s[..., 2], 1e-9)
        u = np.clip(s[..., 0] / sz, -1e3, 1e3)
        v = np.clip(s[..., 1] / sz, -1e3, 1e3)
        rho2d = surfel.FILTER_INV_SQUARE * ((xy[g, 0] - PX) ** 2 + (xy[g, 1] - PY) ** 2)
        a = float(np.max(float(opa[g]) * np.exp(-0.5 * np.minimum(u * u + v * v, rho2d))))
        worst = max(worst, a)
        bad += a >= surfel.ALPHA_MIN
    assert bad == 0, (bad, worst)


@pytest.mark.cuda
def test_rasterize_surfel_launches_the_kernel_on_the_eval_path_only(dev, counters):
    """One launch per eval render, and the eval render's outputs equal the
    plain stages' in the kernel's place; none in a grad-path render."""
    xyz, scales, quats, opa, shs = _scene(3000, 21, dev)
    cam = _camera(dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    cfg = raster.RasterConfig(max_keys=1 << 16)

    def render():
        return raster.rasterize_surfel(xyz, opa, cam, bg, shs=shs, sh_degree=3, scales=scales,
                                       quats=quats, cfg=cfg)

    before = counters.launches
    with torch.no_grad():
        got = render()
    assert counters.launches == before + 1
    with pytest.MonkeyPatch.context() as m:
        m.setattr(raster, "preprocess_surfel_kernel", _plain)
        with torch.no_grad():
            ref = render()
    assert counters.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    xyz.requires_grad_(True)
    render().color.sum().backward()
    assert counters.launches == before + 1
    assert xyz.grad is not None
