// Asynchronous copies into shared memory, shared by the port's per-segment
// kernels K4 (deep_probe.cu) and K6 (seg_phrase.cu).
//
// A CTA issues every copy of a stage at once (cp.async does not hold a
// register for the data in flight), commits them as one group and waits
// for it before a __syncthreads(); the loads of the stage overlap each
// other instead of following one another.

#pragma once

#include <stdint.h>

namespace tantivy_port {

// 16 bytes from global to shared memory; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes from global to shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Ends the copies this thread issued since the last commit as one group and
// waits until all of them have landed (the caller then synchronises the
// block before any thread reads another thread's copies).
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tantivy_port
