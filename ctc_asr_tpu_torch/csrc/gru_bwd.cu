// Backward recurrence (BPTT) of one fused (bi)GRU layer (K5).
//
// Replaces: ctc_asr_tpu/ops/lstm_pallas.py, _gru_bwd_kernel (launched by
// _gru_run_bwd from the custom VJP of gru_seq_pallas). From the
// residuals the forward kernel saved (gru_fwd.cu in residual mode: bf16
// gates (r, z, n, hn) and the masked bf16 output h) and the bf16
// cotangent of h, it runs the reference's cell backward
// (lstm_pallas.py:525-563) in reverse time, for direction d, row b,
// unit j:
//   dh = dh_carry + dhproj_{t+1} @ wh[d]^T        (bf16 operands, f32 sum)
//   dh_total = dh + m*g_out;  dh_new = m*dh_total
//   dz = dh_new*(h_{t-1} - n);  dn_pre = dh_new*(1 - z)*(1 - n^2)
//   dr_pre = dn_pre*hn*r*(1 - r);  dz_pre = dz*z*(1 - z)
//   dxproj[t] = bf16[dr_pre, dz_pre, dn_pre]
//   dhproj_t  = bf16[dr_pre, dz_pre, dn_pre*r]
//   dh_carry <- (1 - m)*dh_total + dh_new*z
// h_{t-1} is the masked output h_seq[t-1] (0 at t = 0), as in the
// reference: outside a row's window either dh_new is 0 or the carried h
// is 0. Outside the window m = 0, so dh passes through and dgates is 0.
// The bias gradient is the sum of the f32 dgates over rows and steps; dwh
// is one large matmul outside the kernel (lstm_pallas._dwh_from_seq).
//
// Unlike the LSTM (lstm_bwd.cu), the gradient of the recurrent product's
// pre-activations is not dxproj: n = tanh(x_n + r*hproj_n) gives
// d(hproj_n) = dn_pre*r. The reference forms it in f32 and rounds it to
// bf16 once; rebuilding it from the bf16 dxproj times the bf16 r would
// round twice and drift along the chain. So each launch writes its
// dhproj into one half of a [2, nd, B, 3H] bf16 scratch and the next
// launch (step t-1) reads it: the launch boundary is the grid-wide
// barrier, and the two halves keep a block from reading rows another
// block of the same launch is writing.
//
// What bounds it on the H100: like the forward, a strict chain of T
// steps, each a [B, 3H] x [3H, H] product (nd=2, B=128, H=512: 0.40
// GFLOP a step, small for the tensor cores) plus the cell; the step's
// latency (launch, L2 -> shared-memory copies, barrier) is the cost.
//
// What the design does about it, simple first: one launch per step in
// reverse time, lstm_bwd.cu's mapping with K = 3H. A block owns 32
// hidden units of one direction for 32 batch rows. Per K chunk of 256
// the dhproj rows and the 32 wh rows of its units are copied to shared
// memory with cp.async, and 8 warps run bf16 tensor-core products (WMMA
// 16x16x16, f32 accumulation; two warps per output tile, each over half
// of the chunk; the last chunk is ragged when 3H % 256 != 0). Then each
// thread runs the cell backward for 4 (row, unit) pairs with dh_carry
// kept in place in global memory by its single owner. The bias gradient
// goes into a per-row-block partial [nbt, nd, 3H] that only this block's
// (row block, direction, units) ever touches, so the sums are
// deterministic; PyTorch adds the nbt partials.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NG = 3;         // gate columns r, z, n
constexpr int JT = 32;        // hidden units per block
constexpr int BT = 32;        // batch rows per block
constexpr int KC = 256;       // K chunk (over the 3H gate columns)
constexpr int THREADS = 256;  // 8 warps
constexpr int RPT = BT / (THREADS / JT);  // rows per thread in the cell
constexpr int LDA = KC + 8;   // bf16, padded rows of the dhproj tile
constexpr int LDB = KC + 8;   // bf16, padded rows (units) of the wh tile
constexpr int LDC = JT + 4;   // f32
static_assert(RPT == 4, "cell mapping assumes 4 rows per thread");
static_assert((size_t)2 * BT * LDC * sizeof(float)
              <= (size_t)BT * LDA * sizeof(bf16), "C aliases A");

__global__ void __launch_bounds__(THREADS)
gru_bwd_step_kernel(const bf16* __restrict__ g_out,   // [nd,T,B,H]
                    const bf16* __restrict__ gates,   // [nd,T,B,4H]
                    const bf16* __restrict__ h_seq,   // [nd,T,B,H]
                    const bf16* __restrict__ wh,      // [nd,H,3H]
                    const int* __restrict__ start,    // [nd,B]
                    const int* __restrict__ end,      // [nd,B]
                    float* __restrict__ dh_state,     // [nd,B,H]
                    const bf16* __restrict__ dhp_in,  // [nd,B,3H], step t+1
                    bf16* __restrict__ dhp_out,       // [nd,B,3H], step t
                    bf16* __restrict__ dxproj,        // [nd,T,B,3H]
                    float* __restrict__ db_part,      // [nbt,nd,3H]
                    int t, int T, int B, int H) {
  __shared__ __align__(128) bf16 As[BT * LDA];        // dhproj_{t+1} rows
  __shared__ __align__(128) bf16 Bs[JT * LDB];        // wh rows (units)
  __shared__ float red[THREADS / JT][NG][JT];         // db row sums
  float* Cs = reinterpret_cast<float*>(As);           // [2][BT][LDC]

  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JT;
  const int b0 = blockIdx.y * BT;
  const int nd = gridDim.z;
  const int G = NG * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tile = warp & 3;                // output 16x16 tile
  const int rb = tile & 1, cb = tile >> 1;  // its row / unit tile
  const int half = warp >> 2;               // which half of a K chunk
  const bool has_next = t + 1 < T;

  if (has_next) {
    const bf16* dg = dhp_in + (size_t)d * B * G;
    const bf16* w = wh + (size_t)d * H * G;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < G; k0 += KC) {
      for (int e = tid; e < BT * (KC / 8); e += THREADS) {
        const int rr = e / (KC / 8), kk = (e % (KC / 8)) * 8;
        bf16* dst = As + rr * LDA + kk;
        if (b0 + rr < B && k0 + kk < G)
          __pipeline_memcpy_async(dst, dg + (size_t)(b0 + rr) * G + k0 + kk,
                                  16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      for (int e = tid; e < JT * (KC / 8); e += THREADS) {
        const int uu = e / (KC / 8), kk = (e % (KC / 8)) * 8;
        bf16* dst = Bs + uu * LDB + kk;
        if (j0 + uu < H && k0 + kk < G)
          __pipeline_memcpy_async(dst, w + (size_t)(j0 + uu) * G + k0 + kk,
                                  16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const int nks = min(KC, G - k0) / 16;
      for (int ks = half; ks < nks; ks += 2) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, As + rb * 16 * LDA + ks * 16, LDA);
        // B[k][n] = wh[j0 + n][k]: the unit rows read as a column-major B
        wmma::load_matrix_sync(bm, Bs + cb * 16 * LDB + ks * 16, LDB);
        wmma::mma_sync(acc, a, bm, acc);
      }
      __syncthreads();   // tiles are rewritten by the next chunk / by C
    }
    wmma::store_matrix_sync(Cs + half * BT * LDC + rb * 16 * LDC + cb * 16,
                            acc, LDC, wmma::mem_row_major);
    __syncthreads();
  }

  const int u = tid % JT;
  const int r = tid / JT;
  const int j = j0 + u;
  float part[NG] = {0.f, 0.f, 0.f};
  if (j < H) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rr = r + 8 * i, bb = b0 + rr;
      if (bb >= B) continue;
      const size_t so = ((size_t)d * B + bb) * H + j;
      const size_t ot = ((size_t)d * T + t) * B + bb;
      const float dh_rec = has_next
          ? Cs[rr * LDC + u] + Cs[BT * LDC + rr * LDC + u] : 0.f;
      const float dh = dh_state[so] + dh_rec;
      const float mf =
          (t >= start[d * B + bb] && t < end[d * B + bb]) ? 1.f : 0.f;
      const bf16* gp = gates + ot * 4 * H;
      const float gr = __bfloat162float(gp[0 * H + j]);
      const float gz = __bfloat162float(gp[1 * H + j]);
      const float gn = __bfloat162float(gp[2 * H + j]);
      const float hn = __bfloat162float(gp[3 * H + j]);
      const float h_prev =
          t > 0 ? __bfloat162float(h_seq[(ot - B) * H + j]) : 0.f;

      const float dh_total = dh + mf * __bfloat162float(g_out[ot * H + j]);
      const float dh_new = mf * dh_total;
      const float dz = dh_new * (h_prev - gn);
      const float dn_pre = dh_new * (1.f - gz) * (1.f - gn * gn);
      const float dr_pre = dn_pre * hn * gr * (1.f - gr);
      const float dz_pre = dz * gz * (1.f - gz);
      const float dhn = dn_pre * gr;

      const float dpre[NG] = {dr_pre, dz_pre, dn_pre};
      bf16* dx = dxproj + ot * G;
      bf16* dp = dhp_out + ((size_t)d * B + bb) * G;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        dx[g * H + j] = __float2bfloat16(dpre[g]);
        part[g] += dpre[g];
      }
      dp[0 * H + j] = __float2bfloat16(dr_pre);
      dp[1 * H + j] = __float2bfloat16(dz_pre);
      dp[2 * H + j] = __float2bfloat16(dhn);
      dh_state[so] = (1.f - mf) * dh_total + dh_new * gz;
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) red[r][g][u] = part[g];
  __syncthreads();
  if (tid < NG * JT) {
    const int g = tid / JT, uu = tid % JT;
    if (j0 + uu < H) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < THREADS / JT; ++q) s += red[q][g][uu];
      db_part[((size_t)blockIdx.y * nd + d) * G + g * H + j0 + uu] += s;
    }
  }
}

}  // namespace

// One layer's BPTT: T launches of gru_bwd_step_kernel on `stream`, in
// reverse time. Needs H % 16 == 0 and 16-byte aligned wh / dhproj.
// dh_state [nd,B,H] f32 and db_part [ceil(B/32), nd, 3H] f32 are zeroed
// by the caller; dhproj [2, nd, B, 3H] bf16 is scratch (the first launch
// reads none of it). Returns cudaError_t.
extern "C" int gru_bwd_seq(const void* g_out, const void* gates,
                           const void* h_seq, const void* wh,
                           const void* start, const void* end,
                           void* dh_state, void* dhproj, void* dxproj,
                           void* db_part, int nd, int T, int B, int H,
                           void* stream) {
  if (nd <= 0 || T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if (H % 16 != 0 || (B + BT - 1) / BT > 65535 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT, nd);
  const size_t half = (size_t)nd * B * NG * H;
  bf16* dhp = (bf16*)dhproj;
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)g_out, (const bf16*)gates, (const bf16*)h_seq,
        (const bf16*)wh, (const int*)start, (const int*)end,
        (float*)dh_state, dhp + ((t + 1) & 1) * half, dhp + (t & 1) * half,
        (bf16*)dxproj, (float*)db_part, t, T, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
