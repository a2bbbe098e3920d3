// Asynchronous global -> shared copies (sm_80+ `cp.async`), shared by the
// paged-attention ring kernels and the float32 GEMM core
// (csrc/gemm_core.cuh): 16-byte copies that bypass L1 (`.cg`), and 8- and
// 4-byte copies (`.ca`, the only variant of those sizes) for the quantized
// pools' narrow rope lines and per-line float32 scales and for the GEMM
// core's element-wise stages; the `_zfill` forms write zeros instead of
// reading where a copy falls outside its operand.  Grouped with
// commit_group and waited on with wait_group, so a block can keep several
// slabs in flight while it computes on an earlier one.
#pragma once

namespace cp_async {

// Copy 16 bytes from global memory at src to shared memory at dst (both
// 16-byte aligned); completes asynchronously, in the current group.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

// Copy 8 / 4 bytes from global memory at src to shared memory at dst (both
// aligned to the size), asynchronously, in the current group.
__device__ __forceinline__ void copy8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

// copy16 / copy4, or 16 / 4 zero bytes at dst if !valid (source size 0:
// src is not read, but must still be a valid address).
__device__ __forceinline__ void copy16_zfill(void* dst, const void* src,
                                             bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy4_zfill(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Close the current group of copies (an empty group is legal and keeps
// the group count uniform across threads and iterations).
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait for the oldest group of a ring of `stages` (2..4) slabs, with
// stages - 2 groups allowed in flight behind it.
__device__ __forceinline__ void wait_oldest(int stages) {
  switch (stages) {
    case 2: wait<0>(); break;
    case 3: wait<1>(); break;
    default: wait<2>(); break;
  }
}

}  // namespace cp_async
