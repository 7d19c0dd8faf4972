// The row schedule's hand-off primitives, shared by the persistent
// kernels that walk a plane block row by block row with per-row ready
// flags: the closed-loop encoder (wavefront.cu) and the decoder
// (decode.cu).  A row publishes how many of its blocks are done with a
// st.release.gpu of its flag; the row below spins on ld.acquire.gpu
// (one thread, __nanosleep backoff) until the flag passes the block it
// needs, and then reads the row's pixels through L2 (__ldcg), since
// the L1 is not coherent across SMs.  A spin that lasts a second ends
// in __trap(), so a schedule fault is a CUDA error at the next
// synchronise, not a hang.

#pragma once

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until *flag > bx; returns the value seen.
__device__ int wait_above(const int* flag, int bx) {
  int v = load_acquire(flag);
  if (v > bx) return v;
  const unsigned long long t0 = global_ns();
  unsigned ns = 16;
  while ((v = load_acquire(flag)) <= bx) {
    __nanosleep(ns);
    if (ns < 128) ns <<= 1;
    if (global_ns() - t0 > 1000000000ull) __trap();   // a second: a fault
  }
  return v;
}
