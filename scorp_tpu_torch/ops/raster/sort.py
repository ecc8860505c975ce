"""Keys-only radix sort of K1's packed keys over the bits they use.

The CUDA source is `csrc/sort.cu`: CUB's `DeviceRadixSort::SortKeys` over
bits [0, end_bit) of 32- or 64-bit keys. It is not a port of a TPU kernel:
the JAX package sorts its packed int32 keys with one single-operand
`lax.sort` outside any Pallas kernel (`scorp_tpu/ops/raster/common.py`
`_tile_sort`), so a library sort takes its place here. `torch.sort` would
sort (key, int64 index) pairs over every bit of the key; this sort moves
the keys alone, over `end_bit` bits (31 at 1600x1066 with 250k gaussians).
`sort_keys_plain` (`torch.sort(keys).values`) is the plain version, run for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check_tensor, load

SOURCE = "scorp_tpu_torch/csrc/sort.cu"


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys).values


@functools.lru_cache(maxsize=None)
def _temp_bytes(device_index: int, n: int, wide: bool, end_bit: int) -> int:
    """The scratch bytes CUB asks for (a host-side query; launches nothing)."""
    nbytes = ctypes.c_size_t(0)
    with torch.cuda.device(device_index):
        err = load("sort").scorp_sort_keys_temp_bytes(n, int(wide), end_bit,
                                                     ctypes.addressof(nbytes))
    if err != 0:
        raise RuntimeError(f"sort scratch query failed: cudaError {err}")
    return nbytes.value


def sort_keys(keys: torch.Tensor, end_bit: int) -> torch.Tensor:
    """Ascending sort of non-negative int32 or int64 keys below 2**end_bit
    (K1's keys: its sentinel is the largest). Launches the CUDA sort for a
    CUDA tensor (and raises if that fails); runs `sort_keys_plain` for a CPU
    tensor."""
    dev = keys.device
    if dev.type == "cpu":
        return sort_keys_plain(keys)
    if dev.type != "cuda":
        raise ValueError(f"sort_keys supports cpu and cuda tensors, not {dev}")
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"keys have dtype {keys.dtype}, expected int32 or int64")
    n = keys.numel()
    check_tensor(keys, "keys", keys.dtype, (n,), dev)
    wide = keys.dtype == torch.int64
    # the sign bit never takes part: keys are non-negative
    if not 0 < end_bit < (64 if wide else 32):
        raise ValueError(f"end_bit {end_bit} out of range for {keys.dtype} keys")
    if not 0 < n < 1 << 31:
        raise ValueError(f"bad number of keys: {n}")

    lib = load("sort")
    nbytes = _temp_bytes(dev.index, n, wide, end_bit)
    out = torch.empty_like(keys)
    temp = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_sort_keys(keys.data_ptr(), out.data_ptr(), temp.data_ptr(), nbytes, n,
                                  int(wide), end_bit, stream)
    if err != 0:
        raise RuntimeError(f"sort launch failed: cudaError {err}")
    sort_keys.launches += 1
    return out


sort_keys.launches = 0
