// CTC forward (alpha) and backward (beta + gradient) recursions.
//
// Replaces: ctc_asr_tpu/ops/ctc_pallas.py, _alpha_kernel (K6, launched by
// _run_alpha) and _beta_kernel (K7, launched by _run_beta). Both run the
// log-space DP over the blank-interleaved extended labels, S = 2U+1
// states, on lp_z [T, B, S] (log_softmax gathered at the labels; the
// gather and its gradient stay in PyTorch):
//   alpha_t(s) = lse3(alpha_{t-1}(s), alpha_{t-1}(s-1),
//                     skip(s) ? alpha_{t-1}(s-2) : NEG) + lp_z[t, s]
//   beta_t(s)  = lse3(x(s), x(s+1), skip(s+2) ? x(s+2) : NEG),
//                x = beta_{t+1} + lp_z[t+1]
//   grad[t, s] = -exp(max(alpha_t(s) + beta_t(s), NEG) - logP)
// with the reference's semantics kept exactly: NEG = -1e30 finite
// sentinel, max-clamped log-sum-exp, alpha_0 with state 1 invalid for an
// empty label, rows past their length carrying alpha and getting a zero
// gradient, the NLL from states 2U and 2U-1, beta starting at t = len-1.
//
// What bounds it on the H100: a strict chain of T steps per utterance,
// each a 3-way log-sum-exp per state (3 expf + 1 logf): at B=128, T=399,
// S=193 that is ~10 M states, far below the card's compute, and 40 MB
// of alphas written by K6 and read back by K7. K6's bound by bytes (lp_z
// read and alpha written once) is ~0.024 ms there, K7's ~0.035 ms; both
// are held instead to the chain's latency, T dependent steps of one
// shared-memory exchange and one barrier each.
//
// What the design does about it, simple first: one block per utterance
// (B=128 -> 128 blocks on 132 SMs), one thread per state, the loop over
// t inside the block (the TPU kernel's sequential grid axis becomes this
// loop). A thread keeps its state's value in a register and publishes it
// in a double-buffered shared array, so each step needs one
// __syncthreads: step t reads buffer t&1's neighbours and writes buffer
// (t+1)&1. Writes of alpha / grad are coalesced rows of S floats, plain
// stores that do not stall the chain. Both kernels take the
// device-memory reads off their chains with one RowRing: each thread
// requests its own state's elements of the rows it will need (lp_z for
// K6; lp_z and alpha for K7) PREFETCH steps ahead with 4-byte cp.async
// copies into a ring of rows in shared memory, and waits on the oldest
// copy group at the top of a step. K7 computes the gradient of a row one
// step late, beside the next log-sum-exp. A step is then the barrier,
// the exchange and the log-sum-exp. Not TMA: row (t, b) starts at
// (t*B + b)*S*4 bytes, in steps of 772 B at S=193, not the 16-byte
// multiples TMA's strides (and 16-byte cp.async copies) need without a
// padded layout. Not a ring of registers: in the SASS of such a ring the
// compiler joined the loaded values into it with moves at the end of
// each step, which wait for the loads; cp.async completion is tracked by
// groups, not registers, and a barrier does not wait for it.
//
// An infeasible row (nll = 1e30) gives -exp(0) = -1 at its
// unreachable states, a finite gradient that the zero cotangent turns
// into exact zeros, as in the reference. Compiled without fast math so
// expf/logf keep the reference's f32 results.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  float m = fmaxf(fmaxf(fmaxf(a, b), c), NEG);
  float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return fmaxf(out, NEG);
}

// The prefetch depth: the rows that step t uses were requested
// PREFETCH steps earlier, so their device-memory latency (~0.6 µs) hides
// under PREFETCH steps of the chain instead of stalling each. They land
// in a ring of SLOTS rows in shared memory; the slot refilled at step t
// was last read two steps earlier, whose values are consumed.
constexpr int PREFETCH = 8;
constexpr int SLOTS = PREFETCH + 2;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most PREFETCH - 1 groups (the newest) are in flight
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PREFETCH - 1) : "memory");
}

// This thread's element of row t of N arrays [T, B, S], prefetched into
// a shared ring [SLOTS][N][SP]. A thread reads only the elements it
// copied itself, so its own wait on the copy group is all the ordering
// the ring needs; no barrier waits for a cp.async.
template <int N>
struct RowRing {
  float* slots;          // the ring, offset to this thread's state
  const float* src[N];   // each array, offset to (t = 0, b, s)
  size_t row;            // B * S: one time step of [T, B, S]
  int SP, T;
  bool active;

  // request row t into slot t % SLOTS: one commit group a row, empty
  // where there is nothing to copy, so that the groups count rows
  __device__ __forceinline__ void fetch(int t) const {
    if (active && t >= 0 && t < T) {
      float* d = slots + (t % SLOTS) * N * SP;
#pragma unroll
      for (int i = 0; i < N; ++i) cp_async4(d + i * SP, src[i] + t * row);
    }
    cp_async_commit();
  }
  // row t, once it has landed: it must be the oldest of PREFETCH rows
  // requested and not yet waited on; its arrays are SP floats apart
  __device__ __forceinline__ const float* wait(int t) const {
    cp_async_wait_oldest();
    return slots + (t % SLOTS) * N * SP;
  }
};

__global__ void ctc_alpha_kernel(const float* __restrict__ lpz,   // [T,B,S]
                                 const float* __restrict__ skip,  // [B,S]
                                 const int* __restrict__ lens,    // [B]
                                 const int* __restrict__ ends,    // [B]
                                 float* __restrict__ alphas,      // [T,B,S]
                                 float* __restrict__ nll,         // [B]
                                 int T, int B, int S) {
  extern __shared__ float smem[];
  const int SP = blockDim.x;            // a row of S states, padded
  float* buf = smem;                    // [2][S]: alpha_{t-1}, alpha_t
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool active = s < S;
  const int len = lens[b];
  const int end = ends[b];
  const bool sk = active && skip[(size_t)b * S + s] > 0.5f;
  const size_t row = (size_t)B * S;
  const size_t own = (size_t)b * S + s;

  // rows 1 .. T-1 of lp_z come through the ring; row 0 is read directly
  const RowRing<1> ring{smem + 2 * S + s, {lpz + own}, row, SP, T, active};
  for (int j = 1; j <= PREFETCH; ++j) ring.fetch(j);

  float a = NEG;
  if (active) {
    const float lp0 = lpz[own];
    if (s == 0 || (s == 1 && end > 0)) a = lp0;
    buf[s] = a;
    alphas[own] = a;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float lp = *ring.wait(t);
    ring.fetch(t + PREFETCH);
    const float* prev = buf + ((t - 1) & 1) * S;
    float* cur = buf + (t & 1) * S;
    if (active) {
      const float stay = prev[s];
      const float diag = s >= 1 ? prev[s - 1] : NEG;
      const float sk2 = (sk && s >= 2) ? prev[s - 2] : NEG;
      if (t < len) a = fmaxf(lse3(stay, diag, sk2) + lp, NEG);
      cur[s] = a;
      alphas[t * row + own] = a;
    }
    __syncthreads();
  }
  if (s == 0) {
    const float* fin = buf + ((T - 1) & 1) * S;
    const float ae = end < S ? fin[end] : NEG;
    const float ae1 = (end > 0 && end - 1 < S) ? fin[end - 1] : NEG;
    const float m = fmaxf(fmaxf(ae, ae1), NEG);
    const float total = m + logf(expf(ae - m) + expf(ae1 - m));
    nll[b] = -fmaxf(total, NEG);
  }
}

__global__ void ctc_beta_grad_kernel(const float* __restrict__ lpz,
                                     const float* __restrict__ alphas,
                                     const float* __restrict__ skip,
                                     const int* __restrict__ lens,
                                     const int* __restrict__ ends,
                                     const float* __restrict__ nll,
                                     float* __restrict__ grad,
                                     int T, int B, int S) {
  extern __shared__ float smem[];
  const int SP = blockDim.x;            // a row of S states, padded
  float* xbuf = smem;                   // [2][SP + 2]: beta_{t+1} + lp_z[t+1]
                                        // then the ring [SLOTS][2][SP]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool active = s < S;
  const int len = lens[b];
  const int end = ends[b];
  const float logp = -nll[b];
  const bool sk2 = active && s + 2 < S && skip[(size_t)b * S + s + 2] > 0.5f;
  const bool is_end = s == end || (s == end - 1 && end > 0);
  const size_t row = (size_t)B * S;     // one time step of [T, B, S]
  const size_t own = (size_t)b * S + s;

  // rows of lp_z and alpha, in reverse time
  const RowRing<2> ring{smem + 2 * (SP + 2) + s, {lpz + own, alphas + own},
                        row, SP, T, active};
  for (int j = 0; j < PREFETCH; ++j) ring.fetch(T - 1 - j);

  float beta = NEG, plpz = NEG;          // carried beta_{t+1}, lp_z[t+1]
  // the gradient of row gt (T: none yet) is computed one step late, from
  // its beta and alpha, beside the next step's log-sum-exp
  float gbeta = NEG, galpha = 0.f;
  int gt = T;
  for (int t = T - 1; t >= 0; --t) {
    const float* d = ring.wait(t);
    const float lp = d[0], al = d[SP];
    ring.fetch(t - PREFETCH);
    float* x = xbuf + (t & 1) * (SP + 2);
    if (active) x[s] = fmaxf(plpz + beta, NEG);
    __syncthreads();
    const float stay = x[s];
    const float diag = s + 1 < S ? x[s + 1] : NEG;
    const float skp = sk2 ? x[s + 2] : NEG;
    const float rec = lse3(stay, diag, skp);
    const float g = -expf(fmaxf(galpha + gbeta, NEG) - logp);
    if (active && gt < T) grad[gt * row + own] = gt < len ? g : 0.f;
    if (t == len - 1)
      beta = is_end ? 0.f : NEG;
    else
      beta = t < len - 1 ? rec : NEG;
    plpz = lp;
    gbeta = beta;
    galpha = al;
    gt = t;
    // the next step writes the other x buffer; two steps on, this one is
    // rewritten only after every thread has passed the barrier above
  }
  const float g = -expf(fmaxf(galpha + gbeta, NEG) - logp);
  if (active && gt < T) grad[gt * row + own] = gt < len ? g : 0.f;
}

}  // namespace

// K6: alphas [T,B,S] and nll [B] from lp_z [T,B,S]. Needs S <= 1024.
extern "C" int ctc_alpha(const void* lpz, const void* skip, const void* lens,
                         const void* ends, void* alphas, void* nll, int T,
                         int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0) return (int)cudaSuccess;
  if (S > 1024) return (int)cudaErrorInvalidValue;
  const int threads = ((S + 31) / 32) * 32;
  const int smem = (2 * S + SLOTS * threads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ctc_alpha_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)lpz, (const float*)skip, (const int*)lens,
      (const int*)ends, (float*)alphas, (float*)nll, T, B, S);
  return (int)cudaGetLastError();
}

// K7: grad [T,B,S] = d nll / d lp_z from lp_z, alphas and nll.
extern "C" int ctc_beta_grad(const void* lpz, const void* alphas,
                             const void* skip, const void* lens,
                             const void* ends, const void* nll, void* grad,
                             int T, int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0) return (int)cudaSuccess;
  if (S > 1024) return (int)cudaErrorInvalidValue;
  const int threads = ((S + 31) / 32) * 32;
  const int smem = (2 * (threads + 2) + SLOTS * 2 * threads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_beta_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ctc_beta_grad_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)lpz, (const float*)alphas, (const float*)skip,
      (const int*)lens, (const int*)ends, (const float*)nll, (float*)grad,
      T, B, S);
  return (int)cudaGetLastError();
}
