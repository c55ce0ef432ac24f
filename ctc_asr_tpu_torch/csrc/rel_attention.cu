// K9: the Conformer's relative-position attention core, forward and
// backward, fused (models/conformer.attention_core on CUDA tensors).
//
// Replaces no TPU kernel: the JAX package has no Conformer. It was added
// because the plain core wrote [B, H, T', T'] f32 scores, a [B, H, T',
// 2T'-1] positional product and their softmax to device memory in some
// twenty-five launches a layer, and kept the probabilities for the
// backward; at the train cell's B=64, T' 422 that held the core at ~2% of
// its bound. Per head, with qu = (q + u) / sqrt(d_k), qv = (q + v) /
// sqrt(d_k) (the f32 sums rounded to bf16, formed in the forward's
// prologue) and p the projected embeddings of positions T'-1 ... -(T'-1):
//   s(i, j) = qu_i . k_j + qv_i . p_{T'-1-i+j}    (keys j >= len masked)
//   o_i     = sum_j softmax_j(s(i, .)) v_j         (0 at queries i >= len)
//
// What bounds it on the H100: the bytes of its inputs and outputs (q, k,
// v, p read, o written, once each) against ~18 T'^2 d FLOPs of forward
// and backward (0.64 T' FLOPs a byte): bound by bytes below T' ~ 460, so
// the kernel's task is to keep the T'^2 terms on chip.
//
// What the design does (flash-attention style, bf16 mma.sync with f32
// accumulators, 4 warps of 16 query rows):
// - Forward: one block per (query tile of 64, head, row). It streams key
//   tiles of 64 (K, V) and the 127 rows of p that the tile pair needs (the
//   band: row c of the band is position (BQ-1-i)+j for local i, j) through
//   two cp.async stages. Each warp multiplies its 16 query rows against the
//   80-row window of the band they need and moves each (i, j) from its
//   skewed column 15-i+j by one shuffle inside the row's quad of lanes: the
//   [.., 2T'-1] product and the shift exist only in registers. Online
//   softmax in f32 (base 2); the probabilities are rounded to bf16 for
//   P.V. It forms qu and qv from the q tile and the biases on chip (and
//   writes them out for the backward in training) and saves the
//   log-sum-exp [B, H, T'].
// - Lengths: key tiles and query tiles wholly past a row's length are not
//   visited; keys past it inside a tile get probability 0 (exactly what
//   the plain core's fill of -10000 gives after exp in f32); padded
//   queries get output 0 and no gradient.
// - Backward, with no float atomics (training repeats from its seed):
//   rel_attn_bwd_q (one block per query tile) recomputes the scores and
//   forms dS = P (dO.V - rowsum(dO o)) in f32, gives dqu = dS K, writes dS
//   skewed into a [64, 128] band in shared memory, gives dqv = band . P,
//   writes dq = (dqu + dqv) / sqrt(d_k) and adds the column sums of dqu
//   and dqv (the biases' gradients) to a partial per (group, query tile),
//   and adds band^T . qv into a ring of 128 band rows in shared memory;
//   the 64 rows a key tile finishes are added to a partial of p's gradient
//   per (group of batch rows, head, query tile), which the block walks in
//   order. rel_attn_bwd_kv (one block per key tile) recomputes P and dS
//   for dk = dS^T qu and dv = P^T dO. Both stream their tiles through one
//   stage, so that two blocks fit an SM.
//   rel_attn_dp_reduce sums the partials of each position in a fixed order.
//
// Inputs are read by strides (d contiguous, rows 16-byte aligned), so the
// projections' [B, T', H, d_k] layout needs no copy; the wrapper
// (ops/attention_cuda.py) checks that and allocates every output and
// scratch buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;          // head width
constexpr int BQ = 64;         // query rows of a tile
constexpr int BK = 64;         // key rows of a tile
constexpr int NB = BQ + BK;    // band rows held (BQ + BK - 1 used)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(THREADS == 2 * D, "a bwd_q thread sums one bias column");

struct View {                  // [B, H, T, D] by element strides
  bf16* ptr;
  long long sb, sh, st;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;          // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of k columns [16kc, 16kc + 16) from C fragments (n tiles
// 2kc, 2kc + 1) of the same rows
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// element offset of 16-byte chunk `chunk` of row `row` in a tile of rows
// of D bf16 (8 chunks), chunks XOR-swizzled by the row so that ldmatrix
// reads of 8 rows hit 8 different bank groups
__device__ __forceinline__ int sw(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}
// the same in the [BQ, NB] band of dS (16 chunks a row)
__device__ __forceinline__ int swb(int row, int chunk) {
  return row * NB + ((chunk ^ (row & 7)) << 3);
}

// ldmatrix addresses of this lane: an A fragment (16 rows x 16 k, rows
// r0.., k chunk pair kc2..) stored [row][k]; a B pair (n tiles n0.. and
// n0 + 8.., k chunk pair kc2) stored [n][k]; stored [k][n] (trans)
__device__ __forceinline__ int a_off(int r0, int kc2, int lane) {
  return sw(r0 + (lane & 15), kc2 + (lane >> 4));
}
__device__ __forceinline__ int bn_off(int n0, int kc2, int lane) {
  return sw(n0 + (lane & 7) + ((lane >> 4) << 3), kc2 + ((lane >> 3) & 1));
}
__device__ __forceinline__ int bk_off(int k0, int nc2, int lane) {
  return sw(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), nc2 + (lane >> 4));
}
// an A fragment stored transposed, [k][m] (trans): rows k0.., m chunk pair
__device__ __forceinline__ int at_off(int k0, int mc2, int lane) {
  return sw(k0 + (lane & 7) + ((lane >> 4) << 3), mc2 + ((lane >> 3) & 1));
}

// rows [0, ROWS) of a tile from row g0 of a view at row stride st: row
// g0 + r is read where lo <= g0 + r < hi, zero-filled elsewhere
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base,
                                          long long st, int g0, int lo,
                                          int hi) {
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * 8; idx += THREADS) {
    const int r = idx >> 3, c = idx & 7;
    const int g = g0 + r;
    const bool ok = g >= lo && g < hi;
    const bf16* src = ok ? base + (long long)g * st + c * 8 : base;
    cp_async16(s + sw(r, c), src, ok);
  }
}

// S[nt] += the entry (ii, 15 - ii + j) of a warp's [16, 80] product P
// (C fragments) at each (ii, j) of S. Row ii's entries lie in the lanes of
// its quad, so each is one shuffle: a lane sends the element that the one
// lane asking for its column wants, from one of two tiles.
__device__ __forceinline__ void add_skewed(float S[8][4], const float P[10][4],
                                           int lane) {
  const int r = lane >> 2, q = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int pe = (1 + r + e) & 1;            // the element's column parity
    // as a sender: the column 2 q' of the lane that reads this lane
    const int cqd = (2 * q + pe - 15 + r - e) & 7;
    const bool far = 15 - r + cqd + e >= 16;   // two tiles on, else one
    // as a reader: the lane that holds column 15 - r + 2q + e
    const int src = (lane & ~3) | (((15 - r + 2 * q + e) & 7) >> 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float v0 = far ? (pe ? P[nt + 2][1] : P[nt + 2][0])
                           : (pe ? P[nt + 1][1] : P[nt + 1][0]);
      const float v1 = far ? (pe ? P[nt + 1][3] : P[nt + 1][2])
                           : (pe ? P[nt][3] : P[nt][2]);
      S[nt][e] += __shfl_sync(0xffffffffu, v0, src);
      S[nt][2 + e] += __shfl_sync(0xffffffffu, v1, src);
    }
  }
}

// S (this warp's 16 query rows x BK keys, C fragments) = qu K^T + the
// entries of qv P_band^T at band column (BQ-1-i)+j. The warp's rows
// 16w + ii need band rows [48 - 16w, 128 - 16w), the window in which row
// ii's entry for key j is column 15 - ii + j.
__device__ __forceinline__ void scores(float S[8][4], const bf16* sQu,
                                       const bf16* sQv, const bf16* sK,
                                       const bf16* sP, int warp, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    S[nt][0] = S[nt][1] = S[nt][2] = S[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    ldsm4(a, sQu + a_off(16 * warp, 2 * kc, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4(b, sK + bn_off(16 * np, 2 * kc, lane));
      mma(S[2 * np], a, b[0], b[1]);
      mma(S[2 * np + 1], a, b[2], b[3]);
    }
  }
  float P[10][4];
#pragma unroll
  for (int nt = 0; nt < 10; ++nt)
    P[nt][0] = P[nt][1] = P[nt][2] = P[nt][3] = 0.f;
  const int cw = 48 - 16 * warp;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    ldsm4(a, sQv + a_off(16 * warp, 2 * kc, lane));
#pragma unroll
    for (int np = 0; np < 5; ++np) {
      uint32_t b[4];
      ldsm4(b, sP + bn_off(cw + 16 * np, 2 * kc, lane));
      mma(P[2 * np], a, b[0], b[1]);
      mma(P[2 * np + 1], a, b[2], b[3]);
    }
  }
  add_skewed(S, P, lane);
}

struct Args {
  View q, qu, qv, k, v, o, dout, dq, dk, dv;
  const float* ub;             // [H, D] f32: the biases u and v
  const float* vb;
  float scale;                 // 1 / sqrt(D)
  float* duv;                  // [ceil(B / group), nq, 2, H, D]: their
                               // gradients' partials
  bf16* pe;                    // [H, 2T-1, D] by strides
  long long pe_sh, pe_st;
  bf16* dpe;
  long long dpe_sh, dpe_st;
  const int* lens;
  float* lse;                  // [B, H, T], base-2 log-sum-exp
  float* delta;                // [B, H, T], rowsum(dO o)
  float* part;                 // [ceil(B / group), H, nq, MR, D]: dpe partials
  int B, H, T, nq, MR;
  int group;                   // batch rows a bwd_q block walks
};

__device__ __forceinline__ bf16* at(const View& x, int b, int h) {
  return x.ptr + b * x.sb + h * x.sh;
}

__device__ __forceinline__ int row_len(const Args& a, int b) {
  return min(max(a.lens[b], 0), a.T);
}

// zero rows [r0, min(r0 + n, T)) of a view's (b, h) slice
__device__ __forceinline__ void zero_rows(const View& x, int b, int h,
                                          int r0, int n, int T) {
  bf16* base = x.ptr + b * x.sb + h * x.sh;
  const int rows = min(r0 + n, T) - r0;
  for (int idx = threadIdx.x; idx < rows * 8; idx += THREADS)
    *reinterpret_cast<uint4*>(base + (long long)(r0 + (idx >> 3)) * x.st +
                              (idx & 7) * 8) = make_uint4(0, 0, 0, 0);
}

// the C fragments of 16 rows x 64 (rows r and r + 8 of the warp's 16) to
// rows i0 + 16w + ..: values below len, zeros in [len, T)
__device__ __forceinline__ void store_rows(const View& x, int b, int h,
                                           int row0, int len, int T,
                                           const float acc[8][4], float s0,
                                           float s1, int lane) {
  bf16* base = x.ptr + b * x.sb + h * x.sh;
  const int ia = row0 + (lane >> 2), ib = ia + 8, cq = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (ia < T)
      *reinterpret_cast<uint32_t*>(base + (long long)ia * x.st + 8 * nt +
                                   cq) =
          ia < len ? pack2(acc[nt][0] * s0, acc[nt][1] * s0) : 0u;
    if (ib < T)
      *reinterpret_cast<uint32_t*>(base + (long long)ib * x.st + 8 * nt +
                                   cq) =
          ib < len ? pack2(acc[nt][2] * s1, acc[nt][3] * s1) : 0u;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the q tile in sQu to qu = (q + u) s in sQu and qv = (q + v) s in sQv,
// each sum in f32 rounded once to bf16 (as the plain core's prologue);
// rows at or past T stay zero. Where the wrapper asks for them (a
// differentiable call), rows below T are written to a.qu and a.qv for
// the backward kernels.
__device__ __forceinline__ void rel_queries(const Args& a, bf16* sQu,
                                            bf16* sQv, int b, int h,
                                            int i0) {
  const float* u = a.ub + h * D;
  const float* v = a.vb + h * D;
  for (int idx = threadIdx.x; idx < BQ * 8; idx += THREADS) {
    const int r = idx >> 3, c = idx & 7, g = i0 + r;
    if (g >= a.T) {
      *reinterpret_cast<uint4*>(sQv + sw(r, c)) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4 x = *reinterpret_cast<const uint4*>(sQu + sw(r, c));
    const bf16* xs = reinterpret_cast<const bf16*>(&x);
    uint4 yu, yv;
    bf16* pu = reinterpret_cast<bf16*>(&yu);
    bf16* pv = reinterpret_cast<bf16*>(&yv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __bfloat162float(xs[e]);
      pu[e] = __float2bfloat16_rn((f + u[8 * c + e]) * a.scale);
      pv[e] = __float2bfloat16_rn((f + v[8 * c + e]) * a.scale);
    }
    *reinterpret_cast<uint4*>(sQu + sw(r, c)) = yu;
    *reinterpret_cast<uint4*>(sQv + sw(r, c)) = yv;
    if (a.qu.ptr != nullptr) {
      *reinterpret_cast<uint4*>(at(a.qu, b, h) + (long long)g * a.qu.st +
                                8 * c) = yu;
      *reinterpret_cast<uint4*>(at(a.qv, b, h) + (long long)g * a.qv.st +
                                8 * c) = yv;
    }
  }
}

constexpr int FWD_STAGE = (2 * BK + NB) * D;     // K, V, band (bf16)
constexpr int FWD_SMEM = (2 * BQ * D + 2 * FWD_STAGE) * 2;

__global__ void __launch_bounds__(THREADS, 2)
    rel_attn_fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQu = reinterpret_cast<bf16*>(smem);
  bf16* sQv = sQu + BQ * D;
  bf16* sKV = sQv + BQ * D;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, len = row_len(a, b), i0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* lse = a.lse + ((long long)b * a.H + h) * T;
  if (i0 >= len) {                    // a tile of padded queries
    zero_rows(a.o, b, h, i0, BQ, T);
    for (int i = i0 + threadIdx.x; i < min(i0 + BQ, T); i += THREADS)
      lse[i] = INFINITY;
    return;
  }
  const bf16 *gk = at(a.k, b, h), *gv = at(a.v, b, h);
  const bf16* gp = a.pe + h * a.pe_sh;
  load_tile<BQ>(sQu, at(a.q, b, h), a.q.st, i0, 0, T);
  cp_commit();
  const int nk = (len + BK - 1) / BK;
  auto fetch = [&](int kt) {
    bf16* s = sKV + (kt & 1) * FWD_STAGE;
    const int j0 = kt * BK;
    load_tile<BK>(s, gk, a.k.st, j0, 0, len);
    load_tile<BK>(s + BK * D, gv, a.v.st, j0, 0, len);
    load_tile<NB>(s + 2 * BK * D, gp, a.pe_st, T - BQ - i0 + j0, 0,
                  2 * T - 1);
    cp_commit();
  };
  fetch(0);
  cp_wait<1>();                       // the q tile
  __syncthreads();
  rel_queries(a, sQu, sQv, b, h, i0);  // the loop's barrier orders it

  const int r = lane >> 2, cq = 2 * (lane & 3);
  float O[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    O[nt][0] = O[nt][1] = O[nt][2] = O[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      fetch(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + (kt & 1) * FWD_STAGE;
    const bf16* sV = sK + BK * D;
    float S[8][4];
    scores(S, sQu, sQv, sK, sV + BK * D, warp, lane);
    const int j0 = kt * BK;
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j0 + 8 * nt + cq + e < len;
        S[nt][e] = ok ? S[nt][e] * LOG2E : -INFINITY;
        S[nt][2 + e] = ok ? S[nt][2 + e] * LOG2E : -INFINITY;
        x0 = fmaxf(x0, S[nt][e]);
        x1 = fmaxf(x1, S[nt][2 + e]);
      }
    }
    x0 = fmaxf(m0, quad_max(x0));     // finite: key j0 < len is real
    x1 = fmaxf(m1, quad_max(x1));
    const float c0 = exp2f(m0 - x0), c1 = exp2f(m1 - x1);
    m0 = x0;
    m1 = x1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      O[nt][0] *= c0;
      O[nt][1] *= c0;
      O[nt][2] *= c1;
      O[nt][3] *= c1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        S[nt][e] = exp2f(S[nt][e] - m0);
        S[nt][2 + e] = exp2f(S[nt][2 + e] - m1);
        l0 += S[nt][e];
        l1 += S[nt][2 + e];
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ap[4];
      c_to_a(ap, S[2 * kc], S[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bv[4];
        ldsm4t(bv, sV + bk_off(16 * kc, 2 * dp, lane));
        mma(O[2 * dp], ap, bv[0], bv[1]);
        mma(O[2 * dp + 1], ap, bv[2], bv[3]);
      }
    }
    __syncthreads();                  // this stage is free for kt + 2
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int row0 = i0 + 16 * warp;
  store_rows(a.o, b, h, row0, len, T, O, 1.f / l0, 1.f / l1, lane);
  if ((lane & 3) == 0) {
    const int ia = row0 + r, ib = ia + 8;
    if (ia < T) lse[ia] = ia < len ? m0 + log2f(l0) : INFINITY;
    if (ib < T) lse[ib] = ib < len ? m1 + log2f(l1) : INFINITY;
  }
}

// P (probabilities) and dS of this warp's rows against a key tile, in
// place of S: P = exp2(s log2e - lse) (0 past the length), then with dP =
// dO V^T, dS = P (dP - delta)
__device__ __forceinline__ void probs_and_ds(float S[8][4], float Pout[8][4],
                                             const bf16* sdO,
                                             const bf16* sV, float L0,
                                             float L1, float D0, float D1,
                                             int j0, int len, int warp,
                                             int lane) {
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = j0 + 8 * nt + cq + e < len;
      S[nt][e] = ok ? exp2f(S[nt][e] * LOG2E - L0) : 0.f;
      S[nt][2 + e] = ok ? exp2f(S[nt][2 + e] * LOG2E - L1) : 0.f;
    }
  }
  float dP[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    dP[nt][0] = dP[nt][1] = dP[nt][2] = dP[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    ldsm4(a, sdO + a_off(16 * warp, 2 * kc, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bv[4];
      ldsm4(bv, sV + bn_off(16 * np, 2 * kc, lane));
      mma(dP[2 * np], a, bv[0], bv[1]);
      mma(dP[2 * np + 1], a, bv[2], bv[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (Pout != nullptr) {
#pragma unroll
      for (int c = 0; c < 4; ++c) Pout[nt][c] = S[nt][c];
    }
    S[nt][0] *= dP[nt][0] - D0;
    S[nt][1] *= dP[nt][1] - D0;
    S[nt][2] *= dP[nt][2] - D1;
    S[nt][3] *= dP[nt][3] - D1;
  }
}

// one stage of key tiles: two blocks fit an SM, each hiding the other's
// loads
constexpr int BQ_STAGE = (2 * BK + NB) * D;      // K, V, band (bf16)
constexpr int BQ_SMEM =
    (3 * BQ * D + BQ_STAGE + BQ * NB) * 2 +
    (NB * D + 2 * BQ + WARPS * 2 * D) * 4;

// the column sums of a warp's 16 rows of dqu and dqv (0 at padded
// queries) added to the warp's sums in sUV [WARPS, 2, D]: each sum is
// kept by one lane, so the batch rows add in order
__device__ __forceinline__ void bias_sums(float* sUV, const float dQu[8][4],
                                          const float dQv[8][4], int warp,
                                          int lane) {
  float* su = sUV + warp * 2 * D;
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = dQu[nt][e] + dQu[nt][2 + e];
      float y = dQv[nt][e] + dQv[nt][2 + e];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, m);
        y += __shfl_xor_sync(0xffffffffu, y, m);
      }
      if (lane < 4) {
        su[8 * nt + cq + e] += x;
        su[D + 8 * nt + cq + e] += y;
      }
    }
  }
}

// 64 ring rows to partial rows [m0, m0 + 64), zeroing the ring rows; a
// partial row below `ext` holds the sum of earlier batch rows and is
// added to (each element by the same thread for every batch row)
__device__ __forceinline__ void flush(float* ring, float* part, int m0,
                                      int ext) {
  float4* dst = reinterpret_cast<float4*>(part + (long long)m0 * D);
  for (int idx = threadIdx.x; idx < 64 * D / 4; idx += THREADS) {
    float4* src = reinterpret_cast<float4*>(ring) + idx;
    float4 x = *src;
    if (m0 + (idx >> 4) < ext) {
      const float4 y = dst[idx];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    dst[idx] = x;
    *src = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// one block per (query tile, head, group of a.group batch rows), the rows
// in order; p's partials of the group summed in the block's own slice
__global__ void __launch_bounds__(THREADS, 2)
    rel_attn_bwd_q_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQu = reinterpret_cast<bf16*>(smem);
  bf16* sQv = sQu + BQ * D;
  bf16* sdO = sQv + BQ * D;
  bf16* sKV = sdO + BQ * D;
  bf16* sDS = sKV + BQ_STAGE;                   // [BQ, NB] skewed dS
  float* acc = reinterpret_cast<float*>(sDS + BQ * NB);  // NB band rows
  float* sL = acc + NB * D;
  float* sDl = sL + BQ;
  float* sUV = sDl + BQ;                        // [WARPS, 2, D]
  const int qt = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int T = a.T, i0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, cq = 2 * (lane & 3);
  const int il0 = 16 * warp + r, il1 = il0 + 8;
  const bf16* gp = a.pe + h * a.pe_sh;
  float* part =
      a.part + (((long long)grp * a.H + h) * a.nq + qt) * (long long)a.MR * D;
  for (int idx = threadIdx.x; idx < BQ * NB / 8; idx += THREADS)
    reinterpret_cast<uint4*>(sDS)[idx] = make_uint4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < NB * D / 4; idx += THREADS)
    reinterpret_cast<float4*>(acc)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < WARPS * 2 * D; idx += THREADS)
    sUV[idx] = 0.f;
  int ext = 0;                 // partial rows written by the rows so far
  for (int gi = 0; gi < a.group; ++gi) {
    const int b = grp * a.group + gi;
    if (b >= a.B) break;
    const int len = row_len(a, b);
    const long long bh = (long long)b * a.H + h;
    float* delta = a.delta + bh * T;
    if (i0 >= len) {
      zero_rows(a.dq, b, h, i0, BQ, T);
      for (int i = i0 + threadIdx.x; i < min(i0 + BQ, T); i += THREADS)
        delta[i] = 0.f;
      continue;
    }
    const bf16 *gk = at(a.k, b, h), *gv = at(a.v, b, h);
    load_tile<BQ>(sQu, at(a.qu, b, h), a.qu.st, i0, 0, T);
    load_tile<BQ>(sQv, at(a.qv, b, h), a.qv.st, i0, 0, T);
    load_tile<BQ>(sdO, at(a.dout, b, h), a.dout.st, i0, 0, len);
    cp_commit();
    const int nk = (len + BK - 1) / BK;
    auto fetch = [&](int kt) {
      const int j0 = kt * BK;
      bf16* s = sKV;
      load_tile<BK>(s, gk, a.k.st, j0, 0, len);
      load_tile<BK>(s + BK * D, gv, a.v.st, j0, 0, len);
      load_tile<NB>(s + 2 * BK * D, gp, a.pe_st, T - BQ - i0 + j0, 0,
                    2 * T - 1);
      cp_commit();
    };
    fetch(0);
    // delta = rowsum(dO o) of the tile's rows, two threads a row
    {
      const int rr = threadIdx.x >> 1, half = threadIdx.x & 1, i = i0 + rr;
      float s = 0.f;
      if (i < len) {
        const bf16* po = at(a.o, b, h) + (long long)i * a.o.st + half * 32;
        const bf16* pd =
            at(a.dout, b, h) + (long long)i * a.dout.st + half * 32;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 ov = reinterpret_cast<const uint4*>(po)[c];
          const uint4 dv = reinterpret_cast<const uint4*>(pd)[c];
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 x = __bfloat1622float2(o2[q]);
            const float2 y = __bfloat1622float2(d2[q]);
            s += x.x * y.x + x.y * y.y;
          }
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0) {
        sDl[rr] = s;
        sL[rr] = i < len ? a.lse[bh * T + i] : INFINITY;
        if (i < T) delta[i] = s;
      }
    }
    float dQu[8][4], dQv[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      dQu[nt][0] = dQu[nt][1] = dQu[nt][2] = dQu[nt][3] = 0.f;
      dQv[nt][0] = dQv[nt][1] = dQv[nt][2] = dQv[nt][3] = 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      if (kt > 0) fetch(kt);
      cp_wait<0>();
      __syncthreads();
      const bf16* sK = sKV;
      const bf16* sV = sK + BK * D;
      const bf16* sP = sV + BK * D;
      const int j0 = kt * BK;
      float S[8][4];
      scores(S, sQu, sQv, sK, sP, warp, lane);
      probs_and_ds(S, nullptr, sdO, sV, sL[il0], sL[il1], sDl[il0],
                   sDl[il1], j0, len, warp, lane);
      // dqu += dS K
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t as[4];
        c_to_a(as, S[2 * kc], S[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bk[4];
          ldsm4t(bk, sK + bk_off(16 * kc, 2 * dp, lane));
          mma(dQu[2 * dp], as, bk[0], bk[1]);
          mma(dQu[2 * dp + 1], as, bk[2], bk[3]);
        }
      }
      // dS into the band: (i, j) at column 63 - i + j
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 8 * nt + cq + e;
          const int c0 = 63 - il0 + jl, c1 = 63 - il1 + jl;
          sDS[swb(il0, c0 >> 3) + (c0 & 7)] = __float2bfloat16_rn(S[nt][e]);
          sDS[swb(il1, c1 >> 3) + (c1 & 7)] =
              __float2bfloat16_rn(S[nt][2 + e]);
        }
      }
      __syncthreads();
      // dqv += band (the warp's 80 columns) . P_band
      const int cw = 48 - 16 * warp;
#pragma unroll
      for (int kc = 0; kc < 5; ++kc) {
        uint32_t as[4];
        ldsm4(as, sDS + swb(16 * warp + (lane & 15),
                            (cw >> 3) + 2 * kc + (lane >> 4)));
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bp[4];
          ldsm4t(bp, sP + bk_off(cw + 16 * kc, 2 * dp, lane));
          mma(dQv[2 * dp], as, bp[0], bp[1]);
          mma(dQv[2 * dp + 1], as, bp[2], bp[3]);
        }
      }
      // band rows [16t, 16t + 16), t = w and w + 4, of band^T . qv, added
      // into the ring; query i meets band row c where 63 - i <= c <= 126 - i,
      // so the two tiles need five chunks of 16 queries in every warp
      {
        float G[2][8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            G[mt][nt][0] = G[mt][nt][1] = G[mt][nt][2] = G[mt][nt][3] = 0.f;
          const int t = warp + 4 * mt;
          const int lo = max(0, 48 - 16 * t) >> 4;
          const int hi = min(63, 126 - 16 * t) >> 4;
          for (int kc = lo; kc <= hi; ++kc) {
            uint32_t at4[4];
            ldsm4t(at4, sDS + swb(16 * kc + (lane & 7) + ((lane >> 4) << 3),
                                  2 * t + ((lane >> 3) & 1)));
#pragma unroll
            for (int dp = 0; dp < 4; ++dp) {
              uint32_t bq[4];
              ldsm4t(bq, sQv + bk_off(16 * kc, 2 * dp, lane));
              mma(G[mt][2 * dp], at4, bq[0], bq[1]);
              mma(G[mt][2 * dp + 1], at4, bq[2], bq[3]);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int c = 16 * (warp + 4 * mt) + r;
          float* p0 = acc + ((c + 64 * kt) & (NB - 1)) * D + cq;
          float* p1 = acc + ((c + 8 + 64 * kt) & (NB - 1)) * D + cq;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            float2* q0 = reinterpret_cast<float2*>(p0 + 8 * nt);
            float2* q1 = reinterpret_cast<float2*>(p1 + 8 * nt);
            float2 x0 = *q0, x1 = *q1;
            x0.x += G[mt][nt][0];
            x0.y += G[mt][nt][1];
            x1.x += G[mt][nt][2];
            x1.y += G[mt][nt][3];
            *q0 = x0;
            *q1 = x1;
          }
        }
      }
      __syncthreads();
      // band rows [0, 64) of this key tile are complete
      flush(acc + ((64 * kt) & (NB - 1)) * D, part, 64 * kt, ext);
    }
    __syncthreads();
    // the last key tile's band rows [64, 128)
    flush(acc + ((64 * nk) & (NB - 1)) * D, part, 64 * nk, ext);
    ext = max(ext, 64 * (nk + 1));
    bias_sums(sUV, dQu, dQv, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) dQu[nt][c] += dQv[nt][c];
    store_rows(a.dq, b, h, i0 + 16 * warp, len, T, dQu, a.scale, a.scale,
               lane);
    __syncthreads();           // the tiles are free for the next row
  }
  // the group's partial of the biases' gradients, warps summed in order
  {
    const int w = threadIdx.x / D, c = threadIdx.x % D;   // THREADS = 2 D
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) x += sUV[(k * 2 + w) * D + c];
    a.duv[(((long long)grp * a.nq + qt) * 2 + w) * a.H * D + h * D + c] =
        x * a.scale;
  }
}

// one stage of query tiles: two blocks fit an SM, each hiding the
// other's loads
constexpr int KV_STAGE = (3 * BQ + NB) * D;     // qu, qv, dO, band (bf16)
constexpr int KV_SMEM = (2 * BK * D + KV_STAGE + 2 * BQ * BK) * 2 +
                        2 * BQ * 4;

__global__ void __launch_bounds__(THREADS, 2)
    rel_attn_bwd_kv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * D;
  bf16* sQ = sV + BK * D;                       // qu, qv, dO, band
  bf16* sPs = sQ + KV_STAGE;                    // [BQ, BK] P
  bf16* sdS = sPs + BQ * BK;                    // [BQ, BK] dS
  float* sLD = reinterpret_cast<float*>(sdS + BQ * BK);  // lse, delta
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, len = row_len(a, b), j0 = kt * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (j0 >= len) {                              // a tile of padded keys
    zero_rows(a.dk, b, h, j0, BK, T);
    zero_rows(a.dv, b, h, j0, BK, T);
    return;
  }
  const long long bh = (long long)b * a.H + h;
  const bf16 *gqu = at(a.qu, b, h), *gqv = at(a.qv, b, h);
  const bf16* gdo = at(a.dout, b, h);
  const bf16* gp = a.pe + h * a.pe_sh;
  load_tile<BK>(sK, at(a.k, b, h), a.k.st, j0, 0, len);
  load_tile<BK>(sV, at(a.v, b, h), a.v.st, j0, 0, len);
  cp_commit();
  const int nq = (len + BQ - 1) / BQ;
  auto fetch = [&](int qt) {
    bf16* s = sQ;
    const int i0 = qt * BQ;
    load_tile<BQ>(s, gqu, a.qu.st, i0, 0, T);
    load_tile<BQ>(s + BQ * D, gqv, a.qv.st, i0, 0, T);
    load_tile<BQ>(s + 2 * BQ * D, gdo, a.dout.st, i0, 0, len);
    load_tile<NB>(s + 3 * BQ * D, gp, a.pe_st, T - BQ - i0 + j0, 0,
                  2 * T - 1);
    cp_commit();
    float* ld = sLD;
    if (threadIdx.x < BQ) {
      const int i = i0 + threadIdx.x;
      ld[threadIdx.x] = i < len ? a.lse[bh * T + i] : INFINITY;
      ld[BQ + threadIdx.x] = i < len ? a.delta[bh * T + i] : 0.f;
    }
  };
  fetch(0);

  const int r = lane >> 2, cq = 2 * (lane & 3);
  const int il0 = 16 * warp + r, il1 = il0 + 8;
  float dK[8][4], dV[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dK[nt][0] = dK[nt][1] = dK[nt][2] = dK[nt][3] = 0.f;
    dV[nt][0] = dV[nt][1] = dV[nt][2] = dV[nt][3] = 0.f;
  }
  for (int qt = 0; qt < nq; ++qt) {
    if (qt > 0) fetch(qt);
    cp_wait<0>();
    __syncthreads();
    const bf16* sQu = sQ;
    const bf16* sQv = sQu + BQ * D;
    const bf16* sdO = sQv + BQ * D;
    const bf16* sP = sdO + BQ * D;
    const float* ld = sLD;
    float S[8][4], P[8][4];
    scores(S, sQu, sQv, sK, sP, warp, lane);
    probs_and_ds(S, P, sdO, sV, ld[il0], ld[il1], ld[BQ + il0],
                 ld[BQ + il1], j0, len, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int jl = 8 * nt + cq;
      *reinterpret_cast<uint32_t*>(sPs + sw(il0, jl >> 3) + (jl & 7)) =
          pack2(P[nt][0], P[nt][1]);
      *reinterpret_cast<uint32_t*>(sPs + sw(il1, jl >> 3) + (jl & 7)) =
          pack2(P[nt][2], P[nt][3]);
      *reinterpret_cast<uint32_t*>(sdS + sw(il0, jl >> 3) + (jl & 7)) =
          pack2(S[nt][0], S[nt][1]);
      *reinterpret_cast<uint32_t*>(sdS + sw(il1, jl >> 3) + (jl & 7)) =
          pack2(S[nt][2], S[nt][3]);
    }
    __syncthreads();
    // this warp's keys [16w, 16w + 16): dv += P^T dO, dk += dS^T qu
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ap[4], as[4];
      ldsm4t(ap, sPs + at_off(16 * kc, 2 * warp, lane));
      ldsm4t(as, sdS + at_off(16 * kc, 2 * warp, lane));
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bo[4], bq[4];
        ldsm4t(bo, sdO + bk_off(16 * kc, 2 * dp, lane));
        ldsm4t(bq, sQu + bk_off(16 * kc, 2 * dp, lane));
        mma(dV[2 * dp], ap, bo[0], bo[1]);
        mma(dV[2 * dp + 1], ap, bo[2], bo[3]);
        mma(dK[2 * dp], as, bq[0], bq[1]);
        mma(dK[2 * dp + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  store_rows(a.dk, b, h, j0 + 16 * warp, len, T, dK, 1.f, 1.f, lane);
  store_rows(a.dv, b, h, j0 + 16 * warp, len, T, dV, 1.f, 1.f, lane);
}

// dpe[h, r] = the sum over groups of a.group batch rows and their query
// tiles of the partial row that holds position r, in the order (group,
// qt): no atomics. A group's slice of query tile qt holds rows [0, 64 (n +
// 1)) for every qt < n, n the most key tiles of its rows.
__global__ void __launch_bounds__(D)
    rel_attn_dp_reduce_kernel(const Args a) {
  const int rr = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int T = a.T;
  float s = 0.f;
  for (int g = 0; g * a.group < a.B; ++g) {
    int n = 0;
    for (int b = g * a.group; b < min(a.B, (g + 1) * a.group); ++b)
      n = max(n, (row_len(a, b) + BQ - 1) / BQ);
    const float* base =
        a.part + ((long long)g * a.H + h) * a.nq * (long long)a.MR * D + d;
    for (int qt = 0; qt < n; ++qt) {
      const int m = rr - T + BQ + qt * BQ;     // r = T - BQ - i0 + m
      if (m >= 0 && m < (n + 1) * BK)
        s += base[((long long)qt * a.MR + m) * D];
    }
  }
  a.dpe[h * a.dpe_sh + (long long)rr * a.dpe_st + d] = __float2bfloat16_rn(s);
}

View view(void* p, const long long* s) {
  return View{(bf16*)p, s[0], s[1], s[2]};
}

}  // namespace

// K9 forward. strides (host int64): q, qu, qv, k, v, o as (b, h, t)
// triples, then pe as (h, r). o [B, H, T, D] and lse [B, H, T] f32 are
// written, and qu, qv where they are not null (for the backward); ub, vb
// are the biases [H, D] f32.
extern "C" int rel_attention_fwd(const void* q, const void* ub,
                                 const void* vb, const void* k,
                                 const void* v, const void* pe,
                                 const void* lens, void* qu, void* qv,
                                 void* o, void* lse, const void* strides,
                                 int B, int H, int T, float scale,
                                 void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  const long long* s = (const long long*)strides;
  Args a = {};
  a.q = view((void*)q, s);
  a.qu = view(qu, s + 3);
  a.qv = view(qv, s + 6);
  a.k = view((void*)k, s + 9);
  a.v = view((void*)v, s + 12);
  a.o = view(o, s + 15);
  a.pe = (bf16*)pe;
  a.pe_sh = s[18];
  a.pe_st = s[19];
  a.ub = (const float*)ub;
  a.vb = (const float*)vb;
  a.scale = scale;
  a.lens = (const int*)lens;
  a.lse = (float*)lse;
  a.B = B;
  a.H = H;
  a.T = T;
  a.nq = (T + BQ - 1) / BQ;
  cudaError_t err = cudaFuncSetAttribute(
      rel_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  rel_attn_fwd_kernel<<<dim3(a.nq, H, B), THREADS, FWD_SMEM,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K9 backward. strides (host int64): qu, qv, k, v, o, dout, dq, dk, dv as
// (b, h, t) triples, then pe, dpe as (h, r). delta [B, H, T] f32 and part
// [ceil(B / group), H, nq, (nk + 1) * 64, D] f32 are scratch; duv
// [ceil(B / group), nq, 2, H, D] f32 gets the partials of the biases'
// gradients, which the caller sums over its first two dims.
extern "C" int rel_attention_bwd(const void* qu, const void* qv,
                                 const void* k, const void* v,
                                 const void* pe, const void* o,
                                 const void* dout, const void* lens,
                                 const void* lse, void* delta, void* part,
                                 void* duv, void* dq, void* dk, void* dv,
                                 void* dpe, const void* strides, int B,
                                 int H, int T, int group, float scale,
                                 void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (group <= 0) return (int)cudaErrorInvalidValue;
  const long long* s = (const long long*)strides;
  Args a = {};
  a.qu = view((void*)qu, s);
  a.qv = view((void*)qv, s + 3);
  a.k = view((void*)k, s + 6);
  a.v = view((void*)v, s + 9);
  a.o = view((void*)o, s + 12);
  a.dout = view((void*)dout, s + 15);
  a.dq = view(dq, s + 18);
  a.dk = view(dk, s + 21);
  a.dv = view(dv, s + 24);
  a.pe = (bf16*)pe;
  a.pe_sh = s[27];
  a.pe_st = s[28];
  a.dpe = (bf16*)dpe;
  a.dpe_sh = s[29];
  a.dpe_st = s[30];
  a.scale = scale;
  a.duv = (float*)duv;
  a.lens = (const int*)lens;
  a.lse = (float*)lse;
  a.delta = (float*)delta;
  a.part = (float*)part;
  a.B = B;
  a.H = H;
  a.T = T;
  a.nq = (T + BQ - 1) / BQ;
  a.MR = ((T + BK - 1) / BK + 1) * BK;
  a.group = group;
  cudaError_t err = cudaFuncSetAttribute(
      rel_attn_bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_attn_bwd_kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  rel_attn_bwd_q_kernel<<<dim3(a.nq, H, (B + group - 1) / group), THREADS,
                          BQ_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attn_bwd_kv_kernel<<<dim3((T + BK - 1) / BK, H, B), THREADS, KV_SMEM,
                           st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attn_dp_reduce_kernel<<<dim3(2 * T - 1, H), D, 0, st>>>(a);
  return (int)cudaGetLastError();
}
