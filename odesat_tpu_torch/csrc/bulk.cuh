// Hopper's 1D bulk copies (the Tensor Memory Accelerator's non-tensor
// form) between device memory and shared memory, and the mbarrier that a
// CTA waits on for them, as PTX wrappers. Used by B10 (stream_chunk.cu,
// namespace rhs) to read its tile's rows into shared memory and write them
// back without spending the threads' instructions or registers on the
// copies.
//
// A copy moves a multiple of 16 bytes between 16-byte-aligned addresses.
// Loads complete on an mbarrier: one thread announces the bytes to expect
// (expect_tx) and issues the copies; every thread waits on the phase's
// parity. Stores are tracked per thread in bulk groups: the issuing thread
// commits them and waits before the shared memory they read is reused or
// the CTA exits. Generic-proxy writes to shared memory are made visible to
// the copies by fence_async (each writer) and a barrier before the issue.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace bulk {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier expecting one arrival a phase.
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Order this thread's generic-proxy accesses to shared memory before the
// bulk copies that follow.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrive on the barrier, expecting `bytes` from the copies of this phase.
__device__ __forceinline__ void expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from device memory at src to shared memory at dst, completing on bar.
__device__ __forceinline__ void load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// `bytes` from shared memory at src to device memory at dst, in this
// thread's current bulk group.
__device__ __forceinline__ void store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

// Wait until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Wait until this thread's committed stores have completed.
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

}  // namespace bulk
