// Radix sort of (uint64 key, int32 value) pairs for the index build's
// prefix doubling (megapath_tpu_torch/index/suffix.py), on Hopper
// (sm_90a).
//
// Not the port of a TPU kernel: the JAX package builds its suffix array on
// the host (SA-IS, megapath_tpu/index/suffix.py). The port sorts on the
// card, one sort a doubling round, and this sort sets the build's peak
// memory: the keys of a round and their text positions. torch.sort keeps
// its own buffers beside its input and returns int64 indices (24 bytes a
// character on top of the keys); CUB's DeviceRadixSort over two
// DoubleBuffers sorts in the caller's two key and two value buffers (24
// bytes a character in all, int32 positions) with a temporary of a few
// hundred MB, and only over the key's significant bits.
//
// What bounds it: bytes. Each radix pass reads and writes every pair once
// (8 bits a pass); the caller passes the key's bit width so a round whose
// ranks are few sorts in fewer passes.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

// Temporary bytes mp_sort_pairs needs for n pairs of keys below
// 2^end_bit, into *bytes. Returns a cudaError_t.
extern "C" int mp_sort_pairs_temp_bytes(int n, int end_bit, size_t* bytes) {
  cub::DoubleBuffer<unsigned long long> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  *bytes = 0;
  return (int)cub::DeviceRadixSort::SortPairs(nullptr, *bytes, keys, vals, n,
                                              0, end_bit);
}

// Sorts n pairs (keys0[i], vals0[i]) by key, stably, on `stream`, using
// keys1/vals1 as the other halves of the double buffers. Writes 0 to
// *selector when the sorted pairs end in keys0/vals0, 1 when in
// keys1/vals1. Returns cudaGetLastError() after the launches, or the
// error CUB reported; cudaErrorInvalidValue for n < 1 or end_bit outside
// 1..64.
extern "C" int mp_sort_pairs(void* temp, size_t temp_bytes, void* keys0,
                             void* keys1, void* vals0, void* vals1, int n,
                             int end_bit, int* selector, void* stream) {
  if (n < 1 || end_bit < 1 || end_bit > 64) return (int)cudaErrorInvalidValue;
  cub::DoubleBuffer<unsigned long long> keys(
      static_cast<unsigned long long*>(keys0),
      static_cast<unsigned long long*>(keys1));
  cub::DoubleBuffer<int> vals(static_cast<int*>(vals0),
                              static_cast<int*>(vals1));
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, keys, vals, n, 0, end_bit,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  *selector = keys.selector;
  return (int)cudaGetLastError();
}
