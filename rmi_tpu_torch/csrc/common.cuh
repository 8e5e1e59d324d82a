// Shared definitions of the rmi_tpu_torch kernels.
//
// Every kernel is reached through a plain C entry point (RMI_API, listed
// in entries.h) that launches on the stream it is handed and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper as a
// nonzero code (csrc/binding.cpp raises it).  The library is compiled with
// -fmad=false: a multiply and an add fuse only where the source says
// fma().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RMI_API extern "C" __attribute__((visibility("default")))

#define RMI_ENTRY(name, params) RMI_API int name params;
#include "entries.h"
#undef RMI_ENTRY

#define RMI_FULL_MASK 0xffffffffu

// devices whose launch settings (shared memory granted, SM count) a
// kernel caches
constexpr int kMaxDevices = 64;

// How an int64 image decodes (ops/eval_kernel.key_kind): a u64 key's image
// is u ^ 2^63 (u32 keys too), an f64 key's its bits with a negative value's
// low 63 bits complemented (keys.f64_image)
enum class RmiKey : int64_t { kU64 = 0, kF64 = 1 };

// keys.as_float of one int64 key image
template <RmiKey K>
__device__ __forceinline__ double decoded(int64_t image) {
  if constexpr (K == RmiKey::kF64) {
    return __longlong_as_double(image < 0 ? image ^ 0x7fffffffffffffffll : image);
  } else {
    const uint64_t u = (uint64_t)image ^ 0x8000000000000000ull;
    return (double)(u >> 32) * 4294967296.0 + (double)(u & 0xffffffffull);
  }
}

// keys.as_float then two_layer.normalize: a subtraction and a product,
// which -fmad=false keeps apart
template <RmiKey K>
__device__ __forceinline__ double normalized(int64_t image, double offset, double scale) {
  return (decoded<K>(image) - offset) * scale;
}

// Blocks for a grid-stride loop over `work` items.
static inline unsigned int rmi_grid(int64_t work, int per_block) {
  int64_t b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > (1 << 16)) b = 1 << 16;
  return (unsigned int)b;
}
