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

// Blocks for a grid-stride loop over `work` items.
static inline unsigned int rmi_grid(int64_t work, int per_block) {
  int64_t b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > (1 << 16)) b = 1 << 16;
  return (unsigned int)b;
}
