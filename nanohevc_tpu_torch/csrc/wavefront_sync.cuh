// The row schedule's hand-off primitives, shared by the persistent
// kernels that walk a plane block row by block row: the closed-loop
// encoder (wavefront.cu) and the decoder (decode.cu); the RD kernel
// (wavefront_rd.cu) takes the clock.  A row hands its bottom line to the
// row below as self-announcing words in device memory: pixel + 1, so
// that a word is nonzero once written, stored with st.relaxed.gpu into a
// buffer the wrapper zeroes; the row below polls each word it needs with
// ld.relaxed.gpu until it is nonzero.  Each word is atomic on its own
// and carries its own data, so a reader sees exactly the words it has
// seen ready, and no flag, fence, release or acquire is needed; the L1,
// which is not coherent across SMs, is bypassed by the .gpu scope.  A
// spin that lasts a second ends in __trap(), so a schedule fault is a
// CUDA error at the next synchronise, not a hang.

#pragma once

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A spin that lasts a second is a schedule fault: end it in __trap(),
// a CUDA error at the next synchronise, not a hang.
__device__ __forceinline__ void check_spin(unsigned long long t0) {
  if (global_ns() - t0 > 1000000000ull) __trap();
}

// The pixel of an edge-buffer word once it is written (nonzero): 32
// polls back to back, then __nanosleep backoff.
__device__ __forceinline__ int poll_edge(const int* word) {
  int v;
  unsigned spins = 0, ns = 16;
  unsigned long long t0 = 0;
  while ((v = load_relaxed(word)) == 0) {
    if (++spins < 32) continue;
    if (t0 == 0) t0 = global_ns();
    __nanosleep(ns);
    if (ns < 128) ns <<= 1;
    check_spin(t0);
  }
  return v - 1;
}
