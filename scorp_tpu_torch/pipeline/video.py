"""Video export without cv2: an intra-only MPEG-4 Part 2 Simple Profile
encoder (ISO/IEC 14496-2, the `mp4v` fourcc that the JAX package's
`create_videos` asks of cv2's VideoWriter) in an ISO-BMFF `.mp4`.

Every frame is one I-VOP. The stages run on the frame's device:

  1. `ycbcr420`: RGB u8 -> Y'CbCr, BT.601 limited range (16-235 / 16-240,
     the range an MPEG-4 decoder assumes), in 16.16 fixed point; chroma
     4:2:0 by a 2x2 mean; the image first padded by edge replication to
     whole 16x16 macroblocks (the VOL carries the true width and height);
  2. `fdct`: the 8x8 forward DCT in float64 as separable sums in a fixed
     tap order (no matmul), so every device gives the same levels and the
     file is byte-equal across devices;
  3. `intra_levels`: H.263 quantisation (quant_type 0) at `VOP_QUANT`: the
     DC divided by the standard's dc_scaler, each AC level the one whose
     reconstruction (2 Q |L| + (Q - 1 | 1)) lies nearest;
  4. `vop_codes`: the DC predictor's gradient rule |F_A - F_B| < |F_B - F_C|
     over the left, upper-left and upper blocks (1024 outside the VOP), the
     zigzag scan into (last, run, level) events with the DC differential as
     the first (intra_dc_vlc_thr 7), each event written as escape type 3 (30
     bits), and per macroblock MCBPC, ac_pred_flag 0 and CBPY;
  5. `pack_bits`: a prefix sum of the code lengths, then a scatter of each
     code's bytes.

Only the escape form of the intra TCOEF table is used, so the two short VLC
tables (MCBPC and CBPY) are the only ones that must be exact. The container
(`ftyp`, `mdat`, `moov`) is written on the host. `reconstruct` gives the
decoder's picture from the levels (dequantise, inverse DCT, Y'CbCr -> RGB),
for checks where no decoder is installed, and `read_mp4` parses a file back.
"""

from __future__ import annotations

import struct
from typing import Iterable, NamedTuple

import numpy as np
import torch

VOP_QUANT = 3  # vop_quant of every frame: the coarsest at which tests/test_torch_video.py passes
QADD = (VOP_QUANT - 1) | 1  # the H.263 intra dequantiser's offset: |F| = 2 Q |L| + QADD
PROFILE_LEVEL = 0x01  # Simple Profile, level 1, as FFmpeg's mp4v writes it
MOVIE_TIMESCALE = 1000  # mvhd ticks per second
START_VOP = 0x000001B6

# MCBPC of an I-VOP macroblock of type 3 (intra, no dquant) by CBPC (Cb, Cr),
# and CBPY of an intra macroblock by its four luma bits (block 0 the MSB):
# (code, length)
MCBPC_I = ((1, 1), (1, 3), (2, 3), (3, 3))
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
ESCAPE3 = 0b0000011_11  # the TCOEF escape (7 bits), then "11": escape type 3
EVENT_BITS = 30  # escape 9 + last 1 + run 6 + marker 1 + level 12 + marker 1


def _zigzag() -> np.ndarray:
    """Natural index (v * 8 + u) of each zigzag scan position."""
    cells = sorted(((v, u) for v in range(8) for u in range(8)),
                   key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([v * 8 + u for v, u in cells])


def _dct_matrix() -> np.ndarray:
    """M[k, x] = c(k)/2 cos((2x + 1) k pi / 16), c(0) = 1/sqrt(2): F = M f M^T."""
    k, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    m = 0.5 * np.cos((2 * x + 1) * k * np.pi / 16)
    m[0] *= np.sqrt(0.5)
    return m


ZIGZAG = _zigzag()
DCT = _dct_matrix()

# BT.601 limited range in 16.16 fixed point: Y = 16 + 219/255 (0.299 R + 0.587
# G + 0.114 B), Cb/Cr = 128 + 224/255 (B - Y)/1.772 and (R - Y)/1.402
_Y16 = (16829, 33039, 6416)
_CB16 = (-9714, -19070, 28784)
_CR16 = (28784, -24103, -4681)


def dc_scalers(q: int) -> tuple[int, int]:
    """(luma, chroma) dc_scaler of ISO/IEC 14496-2 Table 7-1 at quantiser q."""
    if q <= 4:
        return 8, 8
    luma = 2 * q if q <= 8 else q + 8 if q <= 24 else 2 * q - 16
    chroma = (q + 13) // 2 if q <= 24 else q - 6
    return luma, chroma


def time_increment_bits(fps: int) -> int:
    """Bits of vop_time_increment at vop_time_increment_resolution fps."""
    return max(1, (fps - 1).bit_length())


# --- the device stages ---------------------------------------------------------


def _pad_index(n: int, to: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(to, device=device), max=n - 1)


def ycbcr420(rgb: torch.Tensor):
    """[H, W, 3] uint8 -> (Y [H16, W16], Cb, Cr [H16/2, W16/2]) int32 planes
    of the image padded by edge replication to whole macroblocks."""
    h, w = rgb.shape[:2]
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    px = rgb.index_select(0, _pad_index(h, h16, rgb.device))
    px = px.index_select(1, _pad_index(w, w16, rgb.device)).to(torch.int32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]

    def mix(c):
        return r * c[0] + g * c[1] + b * c[2]

    y = (mix(_Y16) + ((16 << 16) + (1 << 15))) >> 16

    def sub(c):  # 2x2 sum of the unrounded values, then one rounding
        s = mix(c).reshape(h16 // 2, 2, w16 // 2, 2)
        s = s[:, 0, :, 0] + s[:, 0, :, 1] + s[:, 1, :, 0] + s[:, 1, :, 1]
        return (s + ((128 << 18) + (1 << 17))) >> 18

    return y, sub(_CB16), sub(_CR16)


def _macroblocks(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Planes -> [n_mb, 6, 8, 8] in raster macroblock order: luma blocks 0-3
    (top-left, top-right, bottom-left, bottom-right), then Cb, Cr."""
    my, mx = y.shape[0] // 16, y.shape[1] // 16
    luma = y.reshape(my, 2, 8, mx, 2, 8).permute(0, 3, 1, 4, 2, 5).reshape(my * mx, 4, 8, 8)
    chroma = [c.reshape(my, 8, mx, 8).permute(0, 2, 1, 3).reshape(my * mx, 1, 8, 8)
              for c in (cb, cr)]
    return torch.cat([luma, *chroma], dim=1)


def _planes(blocks: torch.Tensor, my: int, mx: int):
    """Inverse of `_macroblocks`."""
    y = blocks[:, :4].reshape(my, mx, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5)
    cb, cr = (blocks[:, i].reshape(my, mx, 8, 8).permute(0, 2, 1, 3).reshape(my * 8, mx * 8)
              for i in (4, 5))
    return y.reshape(my * 16, mx * 16), cb, cr


def _taps(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum_t x[..., t] m[k, t], summed in t order."""
    acc = x[..., 0:1] * m[:, 0]
    for t in range(1, 8):
        acc = acc + x[..., t:t + 1] * m[:, t]
    return acc


def fdct(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] float64 pixels (row y, column x) -> DCT coefficients
    (row v, column u), rows first."""
    m = torch.as_tensor(DCT, device=blocks.device)
    return _taps(_taps(blocks, m).transpose(-1, -2), m).transpose(-1, -2)


def idct(coefs: torch.Tensor) -> torch.Tensor:
    m = torch.as_tensor(DCT.T.copy(), device=coefs.device)
    return _taps(_taps(coefs, m).transpose(-1, -2), m).transpose(-1, -2)


def intra_levels(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] uint8 -> [n_mb, 6, 64] int32 quantised levels in natural
    order (index v * 8 + u); index 0 holds the quantised DC itself."""
    f = fdct(_macroblocks(*ycbcr420(rgb)).to(torch.float64)).reshape(-1, 6, 64)
    q = VOP_QUANT
    ys, cs = dc_scalers(q)
    scale = torch.tensor([ys] * 4 + [cs] * 2, dtype=torch.float64, device=rgb.device)
    dc = torch.floor(f[:, :, 0] / scale + 0.5)
    dc = torch.minimum(torch.clamp_min(dc, 0.0), torch.floor(2047.0 / scale))
    a = f[:, :, 1:].abs()
    # the nearest reconstruction 2 q L + QADD with L >= 1, or 0
    lv = torch.clamp(torch.floor((a - QADD) / (2 * q) + 0.5), 1.0, float((2047 - QADD) // (2 * q)))
    lv = torch.where((a - (2 * q * lv + QADD)).abs() < a, lv, 0.0)
    ac = torch.where(f[:, :, 1:] < 0, -lv, lv)
    return torch.cat([dc[:, :, None], ac], dim=2).to(torch.int32)


def _predicted_dc(dc: torch.Tensor, scale: int) -> torch.Tensor:
    """[R, C] quantised DCs of one component's block grid -> the predicted
    quantised DC of each: F = dc x scale, 1024 outside the VOP, the upper
    block's if |F_A - F_B| < |F_B - F_C| else the left one's."""
    f = torch.nn.functional.pad(dc * scale, (1, 0, 1, 0), value=1024)
    a, b, c = f[1:, :-1], f[:-1, :-1], f[:-1, 1:]
    pred = torch.where((a - b).abs() < (b - c).abs(), c, a)
    return torch.div(pred + scale // 2, scale, rounding_mode="floor")


def dc_differentials(levels: torch.Tensor, mb_cols: int) -> torch.Tensor:
    """[n_mb, 6] quantised DC minus its predicted value."""
    n = levels.shape[0]
    my, mx = n // mb_cols, mb_cols
    dc = levels[:, :, 0]
    ys, cs = dc_scalers(VOP_QUANT)
    grid = dc[:, :4].reshape(my, mx, 2, 2).permute(0, 2, 1, 3).reshape(2 * my, 2 * mx)
    py = _predicted_dc(grid, ys).reshape(my, 2, mx, 2).permute(0, 2, 1, 3).reshape(n, 4)
    pc = [_predicted_dc(dc[:, i].reshape(my, mx), cs).reshape(n, 1) for i in (4, 5)]
    return dc - torch.cat([py, *pc], dim=1)


def vop_header(index: int, fps: int) -> list[tuple[int, int]]:
    """(value, bits) fields of frame `index`'s I-VOP header."""
    seconds = index // fps - (index - 1) // fps if index else 0
    fields = [(START_VOP, 32), (0, 2)]  # vop_coding_type I
    fields += [(1, 1)] * seconds + [(0, 1)]  # modulo_time_base
    fields += [(1, 1), (index % fps, time_increment_bits(fps)), (1, 1)]  # markers around the increment
    fields += [(1, 1), (7, 3), (VOP_QUANT, 5)]  # vop_coded, intra_dc_vlc_thr 7, vop_quant
    return fields


def vop_codes(levels: torch.Tensor, mb_cols: int, index: int, fps: int):
    """The I-VOP of `levels` as (codes, lengths) int64 tensors on their
    device, in bitstream order: the VOP header's fields, per macroblock its
    header (MCBPC, ac_pred_flag 0, CBPY) and its blocks' events, then the
    next_start_code stuffing."""
    dev = levels.device
    n_mb = levels.shape[0]
    coded = levels.clone()
    coded[:, :, 0] = dc_differentials(levels, mb_cols)
    z = coded.reshape(n_mb * 6, 64)[:, torch.as_tensor(ZIGZAG, device=dev)]
    blk, pos = torch.nonzero(z, as_tuple=True)  # row-major: block, then scan order
    lev = z[blk, pos].to(torch.int64)
    same = torch.zeros_like(blk, dtype=torch.bool)
    same[1:] = blk[1:] == blk[:-1]
    prev = torch.full_like(pos, -1)
    prev[1:] = pos[:-1]
    run = pos - torch.where(same, prev, -1) - 1
    last = torch.ones_like(same)
    last[:-1] = ~same[1:]
    ev = ((ESCAPE3 << 21) | (last.to(torch.int64) << 20) | (run << 14) | (1 << 13)
          | ((lev & 0xFFF) << 1) | 1)

    cbp = (z != 0).any(dim=1).reshape(n_mb, 6).to(torch.int64)
    cbpy = cbp[:, 0] * 8 + cbp[:, 1] * 4 + cbp[:, 2] * 2 + cbp[:, 3]
    cbpc = cbp[:, 4] * 2 + cbp[:, 5]
    mcbpc_t = torch.tensor(MCBPC_I, dtype=torch.int64, device=dev)
    cbpy_t = torch.tensor(CBPY, dtype=torch.int64, device=dev)
    mc, ml = mcbpc_t[cbpc, 0], mcbpc_t[cbpc, 1]
    yc, yl = cbpy_t[cbpy, 0], cbpy_t[cbpy, 1]
    hdr, hdr_len = (mc << (1 + yl)) | yc, ml + 1 + yl

    mb = torch.div(blk, 6, rounding_mode="floor")
    per_mb = torch.bincount(mb, minlength=n_mb)
    before = torch.cumsum(per_mb, 0) - per_mb  # events of earlier macroblocks
    n_items = n_mb + blk.numel()
    codes = torch.empty(n_items, dtype=torch.int64, device=dev)
    lengths = torch.empty_like(codes)
    at_hdr = torch.arange(n_mb, device=dev) + before
    at_ev = torch.arange(blk.numel(), device=dev) + mb + 1
    codes[at_hdr], lengths[at_hdr] = hdr, hdr_len
    codes[at_ev], lengths[at_ev] = ev, EVENT_BITS

    head = torch.tensor(vop_header(index, fps), dtype=torch.int64, device=dev)
    return torch.cat([head[:, 0], codes]), torch.cat([head[:, 1], lengths])


def pack_bits(codes: torch.Tensor, lengths: torch.Tensor) -> bytes:
    """MSB-first concatenation of codes[i]'s low lengths[i] bits (each <= 32),
    followed by next_start_code's stuffing (a 0, then 1s to the byte)."""
    total = int(lengths.sum())
    stuff = 8 - total % 8
    dev = codes.device
    codes = torch.cat([codes, torch.tensor([(1 << (stuff - 1)) - 1], device=dev)])
    lengths = torch.cat([lengths, torch.tensor([stuff], device=dev)])
    off = torch.cumsum(lengths, 0) - lengths
    n_bytes = (total + stuff) // 8
    word = codes << (40 - lengths - (off & 7))  # the code's bits within 5 bytes
    base = off >> 3
    out = torch.zeros(n_bytes + 5, dtype=torch.int32, device=dev)
    for k in range(5):  # no two codes share a bit, so adding is OR-ing
        out.index_add_(0, base + k, ((word >> (32 - 8 * k)) & 0xFF).to(torch.int32))
    return out[:n_bytes].to(torch.uint8).cpu().numpy().tobytes()


def encode_frame(rgb: torch.Tensor, index: int, fps: int) -> bytes:
    """One [H, W, 3] uint8 frame on its device -> its I-VOP's bytes."""
    return pack_bits(*vop_codes(intra_levels(rgb), -(-rgb.shape[1] // 16), index, fps))


def reconstruct(levels: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The decoder's picture of `intra_levels`' output: H.263 dequantisation
    (DC x dc_scaler, AC sign(L) (2 q |L| + QADD)), the inverse DCT
    rounded and clipped to 0..255, chroma repeated over 2x2 pixels and
    BT.601 limited range back to RGB -> [height, width, 3] uint8."""
    lv = levels.to(torch.float64)
    q = VOP_QUANT
    ys, cs = dc_scalers(q)
    scale = torch.tensor([ys] * 4 + [cs] * 2, dtype=torch.float64, device=levels.device)
    ac = lv[:, :, 1:]
    ac = torch.where(ac == 0, 0.0, torch.sign(ac) * (2 * q * ac.abs() + QADD))
    coefs = torch.cat([lv[:, :, :1] * scale[:, None], ac], dim=2).reshape(-1, 6, 8, 8)
    px = torch.clamp(torch.floor(idct(coefs) + 0.5), 0.0, 255.0)
    mx = -(-width // 16)
    y, cb, cr = _planes(px, levels.shape[0] // mx, mx)
    cb = cb.repeat_interleave(2, 0).repeat_interleave(2, 1) - 128.0
    cr = cr.repeat_interleave(2, 0).repeat_interleave(2, 1) - 128.0
    y = (y - 16.0) * (255.0 / 219.0)
    k = 255.0 / 224.0
    rgb = torch.stack([y + (k * 1.402) * cr,
                       y - (k * 1.772 * 0.114 / 0.587) * cb - (k * 1.402 * 0.299 / 0.587) * cr,
                       y + (k * 1.772) * cb], dim=-1)
    return torch.clamp(torch.floor(rgb + 0.5), 0.0, 255.0)[:height, :width].to(torch.uint8)


# --- headers and the container -------------------------------------------------


class _Bits:
    """MSB-first bit writer for the stream headers."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, value: int, n: int):
        self.value, self.n = (self.value << n) | value, self.n + n

    def next_start_code(self):
        self.put(0, 1)
        self.put((1 << (-self.n % 8)) - 1, -self.n % 8)

    def bytes(self) -> bytes:
        return self.value.to_bytes(self.n // 8, "big")


def stream_headers(width: int, height: int, fps: int) -> bytes:
    """The visual object sequence, visual object and video object layer
    headers (the esds DecoderSpecificInfo): a rectangular, progressive
    Simple Profile layer at fps ticks per second, one VOP per tick."""
    b = _Bits()
    b.put(0x000001B0, 32)
    b.put(PROFILE_LEVEL, 8)
    b.put(0x000001B5, 32)
    b.put(0, 1)  # is_visual_object_identifier
    b.put(1, 4)  # visual_object_type: video
    b.put(0, 1)  # video_signal_type
    b.next_start_code()
    b.put(0x00000100, 32)  # video_object_start_code
    b.put(0x00000120, 32)  # video_object_layer_start_code
    b.put(0, 1)  # random_accessible_vol
    b.put(1, 8)  # video_object_type_indication: Simple Object
    b.put(0, 1)  # is_object_layer_identifier
    b.put(1, 4)  # aspect_ratio_info: square pixels
    b.put(1, 1)  # vol_control_parameters
    b.put(1, 2)  # chroma_format 4:2:0
    b.put(1, 1)  # low_delay
    b.put(0, 1)  # vbv_parameters
    b.put(0, 2)  # video_object_layer_shape: rectangular
    b.put(1, 1)
    b.put(fps, 16)  # vop_time_increment_resolution
    b.put(1, 1)
    b.put(1, 1)  # fixed_vop_rate
    b.put(1, time_increment_bits(fps))  # fixed_vop_time_increment
    for v, n in ((1, 1), (width, 13), (1, 1), (height, 13), (1, 1)):
        b.put(v, n)
    b.put(0, 1)  # interlaced
    b.put(1, 1)  # obmc_disable
    b.put(0, 1)  # sprite_enable
    b.put(0, 1)  # not_8_bit
    b.put(0, 1)  # quant_type: H.263
    b.put(1, 1)  # complexity_estimation_disable
    b.put(1, 1)  # resync_marker_disable
    b.put(0, 1)  # data_partitioned
    b.put(0, 1)  # scalability
    b.next_start_code()
    return b.bytes()


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(sizes: list[int], chunk_offset: int, width: int, height: int, fps: int,
          headers: bytes) -> bytes:
    n = len(sizes)
    duration = round(n * MOVIE_TIMESCALE / fps)
    rate = sum(sizes) * 8 * fps // n
    esds = _full_box(b"esds", 0, 0, _descriptor(0x03, struct.pack(">HB", 1, 0) + _descriptor(
        0x04, bytes([0x20, 0x11]) + min(max(sizes), 0xFFFFFF).to_bytes(3, "big")
        + struct.pack(">II", min(max(sizes) * 8 * fps, 0xFFFFFFFF), min(rate, 0xFFFFFFFF))
        + _descriptor(0x05, headers)) + _descriptor(0x06, b"\x02")))
    entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
                 struct.pack(">Hh", 0x18, -1), esds)
    stbl = _box(
        b"stbl",
        _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
        _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
        _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
        _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
        # one chunk, right after ftyp and the mdat header: stco always holds it
        _full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset)),
    )
    minf = _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full_box(b"url ", 0, 1))), stbl)
    mdia = _box(b"mdia", _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n, 0x55C4, 0)),
                _full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0"), minf)
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">5I", 0, 0, 1, 0, duration), bytes(16),
                     _MATRIX, struct.pack(">II", width << 16, height << 16))
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">4IIH", 0, 0, MOVIE_TIMESCALE, duration,
                                                0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                     struct.pack(">I", 2))
    return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))


def write_video(path: str, frames: Iterable[torch.Tensor], fps: int) -> int:
    """Encode [H, W, 3] uint8 frames (each on the device that encodes it)
    into an `.mp4` at `path`, one I-VOP per frame at 1/fps; returns the
    number of frames. Every frame must have the first one's size."""
    if fps != int(fps) or not 0 < fps < 1 << 16:
        raise ValueError(f"fps must be an integer in 1..65535, got {fps}")
    fps = int(fps)
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    sizes, shape = [], None
    with open(path, "wb") as f:
        f.write(ftyp + bytes(16))  # room for a 64-bit mdat header
        for i, rgb in enumerate(frames):
            if shape is None:
                shape = tuple(rgb.shape)
            elif tuple(rgb.shape) != shape:
                raise ValueError(f"frame {i} is {tuple(rgb.shape)}, the first is {shape}")
            sample = encode_frame(rgb, i, fps)
            f.write(sample)
            sizes.append(len(sample))
        if shape is None:
            raise ValueError("no frames to encode")
        payload = sum(sizes)
        height, width = shape[:2]
        f.write(_moov(sizes, len(ftyp) + 16, width, height, fps,
                      stream_headers(width, height, fps)))
        f.seek(len(ftyp))
        if payload + 8 < 1 << 32:  # a free box, then a 32-bit mdat header
            f.write(struct.pack(">I4sI4s", 8, b"free", payload + 8, b"mdat"))
        else:
            f.write(struct.pack(">I4sQ", 1, b"mdat", payload + 16))
    return len(sizes)


# --- reading a file back ------------------------------------------------------


class Mp4Info(NamedTuple):
    sample_sizes: list[int]
    chunk_offsets: list[int]
    mdat_payload: int     # bytes of mdat's payload
    timescale: int        # the track's (mdhd)
    sample_deltas: list[tuple[int, int]]  # stts (count, delta)
    object_type: int      # esds objectTypeIndication
    width: int            # the VOL's
    height: int
    vop_rate: int         # the VOL's vop_time_increment_resolution


def _boxes(data: bytes, start: int = 0, end: int | None = None):
    end = len(data) if end is None else end
    while start + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, start)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, start + 8)[0], 16
        elif size == 0:
            size = end - start
        yield kind, start + head, start + size
        start += size


def _descriptor_body(data: bytes, at: int):
    tag, n, at = data[at], 0, at + 1
    while True:
        byte, at = data[at], at + 1
        n = (n << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return tag, at, at + n


def _vol_fields(headers: bytes) -> tuple[int, int, int]:
    """(width, height, vop_time_increment_resolution) of the VOL in
    `headers` (a rectangular layer without vbv parameters)."""
    at = next(i for i in range(len(headers) - 3)
              if headers[i:i + 3] == b"\0\0\1" and 0x20 <= headers[i + 3] <= 0x2F) + 4
    bits = int.from_bytes(headers[at:], "big")
    left = 8 * (len(headers) - at)

    def get(n):
        nonlocal left
        left -= n
        return (bits >> left) & ((1 << n) - 1)

    get(9)  # random_accessible_vol, video_object_type_indication
    if get(1):  # is_object_layer_identifier
        get(7)
    if get(4) == 15:  # aspect_ratio_info
        raise ValueError("VOL with an extended pixel aspect ratio")
    if get(1):  # vol_control_parameters
        get(3)
        if get(1):
            raise ValueError("VOL with vbv parameters")
    if get(2) != 0:
        raise ValueError("VOL shape is not rectangular")
    get(1)
    rate = get(16)
    get(1)
    if get(1):  # fixed_vop_rate
        get(time_increment_bits(rate))
    get(1)
    width = get(13)
    get(1)
    return width, get(13), rate


def read_mp4(path: str) -> Mp4Info:
    """Parse the first video track of an `.mp4` back (the boxes `write_video`
    writes; other boxes are skipped)."""
    with open(path, "rb") as f:
        data = f.read()
    found = {}

    def walk(start, end):
        for kind, a, b in _boxes(data, start, end):
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl") and kind not in found:
                walk(a, b)
            found.setdefault(kind, (a, b))

    walk(0, len(data))
    a, b = found[b"mdat"]
    mdat = b - a

    def table(kind, fmt, skip=8):
        a, b = found[kind]
        n = struct.unpack_from(">I", data, a + skip - 4)[0]
        return [struct.unpack_from(fmt, data, a + skip + i * struct.calcsize(fmt))
                for i in range(n)]

    same, count = struct.unpack_from(">II", data, found[b"stsz"][0] + 4)
    sizes = [same] * count if same else [s for (s,) in table(b"stsz", ">I", 12)]
    offsets = [o for (o,) in table(b"stco", ">I")]
    timescale = struct.unpack_from(">I", data, found[b"mdhd"][0] + 12)[0]
    a, b = found[b"stsd"]
    kind, ea, eb = next(_boxes(data, a + 8, b))
    esds = next((x, y) for k, x, y in _boxes(data, ea + 78, eb) if k == b"esds")
    _, at, _ = _descriptor_body(data, esds[0] + 4)  # ES_Descriptor
    if data[at + 2]:
        raise ValueError("ES_Descriptor with optional fields")
    _, at, _ = _descriptor_body(data, at + 3)  # DecoderConfigDescriptor
    object_type = data[at]
    _, at, end = _descriptor_body(data, at + 13)  # DecoderSpecificInfo
    width, height, rate = _vol_fields(bytes(data[at:end]))
    return Mp4Info(sizes, offsets, mdat, timescale, [tuple(e) for e in table(b"stts", ">II")],
                   object_type, width, height, rate)
