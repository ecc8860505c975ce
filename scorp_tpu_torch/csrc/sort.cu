// Keys-only radix sort of K1's packed tile keys, over the bits they use.
//
// Not a port of a TPU kernel: the JAX package sorts its packed keys with
// one single-operand lax.sort, outside any Pallas kernel
// (scorp_tpu/ops/raster/common.py:_tile_sort). This is CUB's
// DeviceRadixSort::SortKeys from the CUDA toolkit's headers, the library
// torch.sort itself runs; torch.sort would sort (key, int64 index) pairs
// over all bits of the key. Plain PyTorch version:
// scorp_tpu_torch/ops/raster/sort.py:sort_keys_plain.
//
// The keys are non-negative and below 2^end_bit (K1's sentinel is the
// largest), so an unsigned sort of bits [0, end_bit) orders them as signed
// integers. At the main path's shapes end_bit is 31: 4 passes of 8 bits,
// each reading and writing 4 B per key.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <typename Key>
cudaError_t sort_keys(void* temp, size_t& temp_bytes, const void* keys, void* out, int n,
                      int end_bit, cudaStream_t stream) {
  return cub::DeviceRadixSort::SortKeys(temp, temp_bytes, (const Key*)keys, (Key*)out, n, 0,
                                        end_bit, stream);
}

cudaError_t dispatch(int wide, void* temp, size_t& temp_bytes, const void* keys, void* out,
                     int n, int end_bit, cudaStream_t stream) {
  return wide ? sort_keys<unsigned long long>(temp, temp_bytes, keys, out, n, end_bit, stream)
              : sort_keys<unsigned int>(temp, temp_bytes, keys, out, n, end_bit, stream);
}

}  // namespace

// The scratch bytes the sort of n keys needs, written to *(size_t*)bytes.
// Launches nothing.
extern "C" int scorp_sort_keys_temp_bytes(int n, int wide, int end_bit, void* bytes) {
  size_t nbytes = 0;
  const cudaError_t err = dispatch(wide, nullptr, nbytes, nullptr, nullptr, n, end_bit, 0);
  *(size_t*)bytes = nbytes;
  return (int)err;
}

// out = keys sorted ascending by bits [0, end_bit), on `stream`; temp holds
// temp_bytes of scratch (at least what scorp_sort_keys_temp_bytes gave).
extern "C" int scorp_sort_keys(const void* keys, void* out, void* temp, size_t temp_bytes,
                               int n, int wide, int end_bit, void* stream) {
  const cudaError_t err =
      dispatch(wide, temp, temp_bytes, keys, out, n, end_bit, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
