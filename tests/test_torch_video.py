"""Port parity, video export: scorp_tpu_torch.pipeline.render_paths.create_videos
(pipeline/video.py, an intra-only MPEG-4 Part 2 `mp4v` encoder in an `.mp4`,
no cv2) against the JAX package's create_videos (cv2's VideoWriter, `mp4v`),
both decoded here by cv2's FFmpeg reader.

Every case writes the same PNGs (frames drawn from a numpy seed, saved with
the port's `save_img_u8`) and encodes them with both packages on the CPU.
The port's file must decode to JAX's frame count, size and fps, be at least
as close to the PNGs by mean absolute error and by PSNR, and decode to
within a small tolerance of `video.reconstruct`, the port's own model of the
decoder: FFmpeg's integer IDCT rounds differently from the float64 one by
about one level per sample, and its YUV -> BGR conversion truncates in
fixed point (its output sits ~1 level darker), so each decoded frame is held
to max |diff| <= 6 and mean |diff| <= 1.5 (u8 levels; measured: max 5,
mean <= 1.22). That holds at even heights, where cv2 repeats each chroma
row; at an odd height (the orbit test's 133 rows) it interpolates them and
the frames are compared by their luma."""

import ast
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from scorp_tpu.pipeline import render_paths as jpaths
from scorp_tpu_torch.pipeline import render_paths as tpaths
from scorp_tpu_torch.pipeline import video

REC_MAX, REC_MEAN = 6, 1.5


def smooth_with_edges(h: int, w: int, rng) -> np.ndarray:
    """[3, H, W] in [0, 1]: three sinusoidal colour ramps with a dozen
    flat rectangles of random colour on top (hard edges)."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (k + 1) * xx + 3 * yy + rng.uniform(0, 6))
                    for k in range(3)])
    for _ in range(12):
        x0, y0 = rng.integers(0, w - w // 8), rng.integers(0, h - h // 8)
        dy, dx = rng.integers(h // 16, h // 3), rng.integers(w // 16, w // 3)
        img[:, y0:y0 + dy, x0:x0 + dx] = rng.uniform(0, 1, (3, 1, 1))
    return img


CASES = {  # name: (frames, height, width, fps, smooth, least PSNR of `reconstruct`)
    "random_32x32": (5, 32, 32, 5, False, 13.0),
    "random_50x38": (4, 38, 50, 30, False, 13.0),
    "smooth_1600x1066": (1, 1066, 1600, 30, True, 36.0),
    "single_frame": (1, 60, 80, 5, True, 24.0),
}


def decode(path: str):
    """cv2's frames (RGB), frame count, width, height and fps of a file."""
    cap = cv2.VideoCapture(path)
    props = [cap.get(p) for p in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FRAME_WIDTH,
                                  cv2.CAP_PROP_FRAME_HEIGHT, cv2.CAP_PROP_FPS)]
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])
    cap.release()
    return frames, props


def closeness(src, got):
    """(mean absolute error, PSNR) of decoded frames against the sources."""
    d = [s.astype(np.float64) - g for s, g in zip(src, got)]
    mse = np.mean([(e * e).mean() for e in d])
    return np.mean([np.abs(e).mean() for e in d]), 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module", params=list(CASES))
def encoded(request, tmp_path_factory):
    n, h, w, fps, smooth, least_psnr = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    rng = np.random.default_rng(len(request.param))
    for i in range(n):
        img = smooth_with_edges(h, w, rng) if smooth else rng.uniform(size=(3, h, w))
        tpaths.save_img_u8(img, str(root / f"{i:03d}.png"))
    sources = [tpaths.read_png(str(root / f"{i:03d}.png")) for i in range(n)]
    port = tpaths.create_videos(str(root), str(root / "port.mp4"), fps=fps, device="cpu")
    ref = jpaths.create_videos(str(root), str(root / "jax.mp4"), fps=fps)
    return dict(sources=sources, port=port, ref=ref, n=n, h=h, w=w, fps=fps,
                least_psnr=least_psnr)


def test_decodes_like_jax_and_at_least_as_close(encoded):
    got, props = decode(encoded["port"])
    ref, ref_props = decode(encoded["ref"])
    n, w, h, fps = encoded["n"], encoded["w"], encoded["h"], encoded["fps"]
    assert props == ref_props == [n, w, h, fps]
    assert len(got) == len(ref) == n
    mae, psnr = closeness(encoded["sources"], got)
    ref_mae, ref_psnr = closeness(encoded["sources"], ref)
    print(f"port MAE {mae:.4f} PSNR {psnr:.4f} dB, JAX MAE {ref_mae:.4f} PSNR {ref_psnr:.4f} dB")
    assert mae <= ref_mae and psnr >= ref_psnr


def test_decoded_frames_match_the_reconstruction(encoded):
    got, _ = decode(encoded["port"])
    for i, (src, dec) in enumerate(zip(encoded["sources"], got)):
        levels = video.intra_levels(torch.from_numpy(src))
        rec = video.reconstruct(levels, encoded["w"], encoded["h"]).numpy().astype(np.int64)
        diff = np.abs(rec - dec)
        assert diff.max() <= REC_MAX and diff.mean() <= REC_MEAN, (i, diff.max(), diff.mean())


def test_container_parses_back(encoded):
    info = video.read_mp4(encoded["port"])
    assert len(info.sample_sizes) == encoded["n"]
    assert sum(info.sample_sizes) == info.mdat_payload
    assert (info.width, info.height, info.vop_rate) == (encoded["w"], encoded["h"], encoded["fps"])
    assert info.object_type == 0x20 and info.timescale == encoded["fps"]
    assert info.sample_deltas == [(encoded["n"], 1)]
    with open(encoded["port"], "rb") as f:
        data = f.read()
    at = info.chunk_offsets[0]
    for size in info.sample_sizes:  # every sample is one VOP, coded I
        assert data[at:at + 4] == struct.pack(">I", video.START_VOP) and data[at + 4] >> 6 == 0
        at += size
    ref = video.read_mp4(encoded["ref"])  # the VOL reader also reads FFmpeg's
    assert (ref.width, ref.height, ref.vop_rate) == (encoded["w"], encoded["h"], encoded["fps"])
    assert len(ref.sample_sizes) == encoded["n"]


def test_reconstruction_is_close_to_the_sources(encoded):
    """The PSNR of `reconstruct` against the PNGs (measured at VOP_QUANT 3:
    13.22 and 13.13 dB on uniform colour noise, whose chroma 4:2:0 mostly
    drops, 36.04 dB on the 1600x1066 frame, 24.36 dB on the 80x60 one)."""
    recs = [video.reconstruct(video.intra_levels(torch.from_numpy(s)), encoded["w"],
                              encoded["h"]).numpy() for s in encoded["sources"]]
    _, psnr = closeness(encoded["sources"], recs)
    print(f"reconstruction PSNR {psnr:.4f} dB")
    assert psnr >= encoded["least_psnr"]


def test_no_frames_and_no_gpu_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="No frames"):
        tpaths.create_videos(str(tmp_path), str(tmp_path / "none.mp4"), device="cpu")
    tpaths.save_img_u8(np.zeros((3, 16, 16)), str(tmp_path / "000.png"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpaths.create_videos(str(tmp_path), str(tmp_path / "out.mp4"))
    assert not os.path.exists(tmp_path / "out.mp4")


def test_pack_bits_equals_a_bit_by_bit_writer():
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 33, 5000)
    codes = np.array([int(rng.integers(0, 1 << int(n))) for n in lengths])
    got = video.pack_bits(torch.as_tensor(codes), torch.as_tensor(lengths))
    bits = "".join(format(int(c), f"0{int(n)}b") for c, n in zip(codes, lengths))
    bits += "0" + "1" * (-(len(bits) + 1) % 8)  # next_start_code's stuffing
    assert got == int(bits, 2).to_bytes(len(bits) // 8, "big")


def test_transform_scan_and_tables():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (50, 8, 8))
    m = video.DCT
    np.testing.assert_allclose(video.fdct(torch.as_tensor(x)).numpy(), m @ x @ m.T,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(video.idct(video.fdct(torch.as_tensor(x))).numpy(), x,
                               rtol=0, atol=1e-9)
    assert video.ZIGZAG[:16].tolist() == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5]
    assert video.ZIGZAG[-6:].tolist() == [61, 54, 47, 55, 62, 63]
    assert sorted(video.ZIGZAG.tolist()) == list(range(64))
    # ISO/IEC 14496-2 Table 7-1 at quantisers 1, 4, 5, 8, 9, 24, 25, 31
    table = {1: (8, 8), 4: (8, 8), 5: (10, 9), 8: (16, 10), 9: (17, 11), 24: (32, 18),
             25: (34, 19), 31: (46, 25)}
    assert {q: video.dc_scalers(q) for q in table} == table
    # prefix-free MCBPC and CBPY codes
    for table in (video.MCBPC_I, video.CBPY):
        words = [format(c, f"0{n}b") for c, n in table]
        assert not [a for a in words for b in words if a != b and b.startswith(a)]


def test_saturated_checkerboard_levels_stay_in_escape_range(tmp_path):
    """Alternating 0/255 pixels give the largest AC coefficients: every level
    fits escape 3's 12 bits, and cv2 decodes the frame to the reconstruction."""
    board = ((np.indices((48, 64)).sum(0) % 2) * 255).astype(np.uint8)
    img = np.stack([board, 255 - board, board], axis=-1)
    levels = video.intra_levels(torch.from_numpy(img))
    assert int(levels.abs().max()) <= 2047
    video.write_video(str(tmp_path / "c.mp4"), [torch.from_numpy(img)], 30)
    (dec,), _ = decode(str(tmp_path / "c.mp4"))
    rec = video.reconstruct(levels, 64, 48).numpy().astype(np.int64)
    assert np.abs(rec - dec).max() <= REC_MAX


def test_video_modules_import_torch_numpy_and_the_standard_library_only():
    import sys

    for mod in (video, tpaths):
        imported = set()
        for node in ast.walk(ast.parse(open(mod.__file__).read())):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                imported.add(node.module.split(".")[0])
        third_party = imported - set(sys.stdlib_module_names)
        assert third_party <= ({"numpy", "torch"} if mod is video else {"numpy", "torch", "PIL"}), (
            mod.__name__, third_party)


def test_orbit_renders_reconstruct_above_the_card_limit(tmp_path):
    """chip_smoke.py phase 14's content at 200x133: its room scene (n/64
    gaussians, scales x8 to keep the full scene's optical depth) rendered
    along two orbit views by the port's `render` and `render2d`, saved by
    `save_img_u8` and encoded by `create_videos` on the CPU. cv2 decodes each
    video to the reconstruction's tolerance, and the reconstruction's PSNR
    against the PNGs (measured 37.9-38.6 dB for 3DGS, 34.1-35.4 dB for 2DGS)
    meets the card's limit, VIDEO_PSNR_MIN.

    At an odd height cv2 converts the decoded planes to BGR through
    swscale's scaling path, which interpolates chroma vertically, where at
    an even height (the other cases, the card's 1066) it repeats each
    chroma row as `reconstruct` does: at 133 rows the frames are held to the
    tolerance by their luma, 0.299 R + 0.587 G + 0.114 B, in which the
    chroma cancels (measured: max 3.0, mean 0.67)."""
    import chip_smoke
    from scorp_tpu_torch.core.camera import make_camera
    from scorp_tpu_torch.core.plyio import GaussianData
    from scorp_tpu_torch.render import render
    from scorp_tpu_torch.render2d import render2d
    from scorp_tpu_torch.train import from_gaussian_data

    w, h = 200, 133
    xyz, shs, scales, quats, opacity, _, _ = chip_smoke.bench_scene_draw(250_000 // 64, 0)
    logit = np.log(opacity / (1 - opacity))[:, None].astype(np.float32)
    g = GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:], opacity=logit,
                     scaling=np.log(scales * 8), rotation=quats)
    g2 = GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:], opacity=logit,
                      scaling=np.ascontiguousarray(g.scaling[:, :2]), rotation=quats)
    for tag, fn, state in (("3dgs", render, from_gaussian_data(g, device="cpu")),
                           ("2dgs", render2d, from_gaussian_data(g2, device="cpu"))):
        frames = tmp_path / tag
        frames.mkdir()
        for i, angle in enumerate((0.3, 2.0)):
            r, t = chip_smoke.orbit_pose(angle)
            cam = make_camera(r, t, chip_smoke.FOVX, chip_smoke.FOVY, w, h, device="cpu")
            tpaths.save_img_u8(fn(cam, state, torch.zeros(3))["render"].numpy(),
                               str(frames / f"{i:03d}.png"))
        path = tpaths.create_videos(str(frames), str(tmp_path / f"{tag}.mp4"),
                                    fps=chip_smoke.VIDEO_FPS, device="cpu")
        got, props = decode(path)
        assert props == [2, w, h, chip_smoke.VIDEO_FPS]
        sources = [tpaths.read_png(str(frames / f"{i:03d}.png")) for i in range(2)]
        recs = [video.reconstruct(video.intra_levels(torch.from_numpy(s)), w, h).numpy()
                for s in sources]
        for rec, dec in zip(recs, got):
            diff = np.abs((rec.astype(np.float64) - dec) @ np.array([0.299, 0.587, 0.114]))
            assert diff.max() <= REC_MAX and diff.mean() <= REC_MEAN, (tag, diff.max())
        for src, rec in zip(sources, recs):
            _, psnr = closeness([src], [rec])
            print(f"{tag}: reconstruction PSNR {psnr:.4f} dB")
            assert psnr >= chip_smoke.VIDEO_PSNR_MIN, (tag, psnr)
