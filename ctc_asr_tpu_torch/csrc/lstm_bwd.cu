// Backward recurrence (BPTT) of one fused (bi)LSTM layer (K3).
//
// Replaces: ctc_asr_tpu/ops/lstm_pallas.py, _bwd_kernel (launched by
// _run_bwd from the custom VJP of lstm_seq_pallas). From the residuals
// the forward kernel saved (lstm_fwd.cu in residual mode: bf16 c and
// activated gates) and the bf16 cotangent of h, it runs the reference's
// cell backward (lstm_pallas.py:266-314) in reverse time, for direction
// d, row b, unit j:
//   dh = dh_direct + dgates_{t+1} @ wh[d]^T     (bf16 operands, f32 sum)
//   dh_total = dh + m*g_out;  dh_new = m*dh_total
//   do = dh_new*tanh(c_t);  dc_total = m*dc + dh_new*o*(1 - tanh(c_t)^2)
//   df = dc_total*c_{t-1} (0 at t = 0);  di = dc_total*g;  dg = dc_total*i
//   dgates = [di*i*(1-i), df*f*(1-f), dg*(1-g^2), do*o*(1-o)]
//   dh_direct <- (1-m)*dh_total;  dc <- (1-m)*dc + dc_total*f
// and writes dgates as bf16 into dxproj[d,t] (the gradient of both the
// input projection and the recurrent product's pre-activations). Outside
// a row's window m = 0, so dh and dc pass through and dgates is 0. The
// bias gradient is the sum of the f32 dgates over rows and steps; dwh is
// one large matmul outside the kernel (lstm_pallas._dwh_from_seq).
//
// What bounds it on the H100: like the forward, a strict chain of T
// steps, each a [B, 4H] x [4H, H] product (nd=2, B=128, H=512: 0.54
// GFLOP a step, small for the tensor cores) plus the cell; the step's
// latency (launch, L2 -> shared-memory copies, barrier) is the cost.
//
// What the design does about it, simple first: one launch per step in
// reverse time, the mirror of lstm_fwd.cu's mapping. A block owns 32
// hidden units of one direction for 32 batch rows. It first forms its
// [32 rows x 32 units] tile of dgates_{t+1} @ wh^T with K = 4H: per K
// chunk of 256 the dgates rows (read back from dxproj[t+1], written by
// the previous launch: the launch boundary is the grid-wide barrier) and
// the 32 wh rows of its units are copied to shared memory with cp.async,
// and 8 warps run bf16 tensor-core products (WMMA 16x16x16, f32
// accumulation; two warps per output tile, each over half of the chunk).
// Then each thread runs the cell backward for 4 (row, unit) pairs with
// dh_direct and dc kept in place in global memory by their single owner.
// The bias gradient goes into a per-row-block partial [nbt, nd, 4H]
// that only this block's (row block, direction, units) ever touches, so
// the sums are deterministic; PyTorch adds the nbt partials.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int JT = 32;        // hidden units per block
constexpr int BT = 32;        // batch rows per block
constexpr int KC = 256;       // K chunk (over the 4H gate columns)
constexpr int THREADS = 256;  // 8 warps
constexpr int RPT = BT / (THREADS / JT);  // rows per thread in the cell
constexpr int LDA = KC + 8;   // bf16, padded rows of the dgates tile
constexpr int LDB = KC + 8;   // bf16, padded rows (units) of the wh tile
constexpr int LDC = JT + 4;   // f32
static_assert(RPT == 4, "cell mapping assumes 4 rows per thread");
static_assert((size_t)2 * BT * LDC * sizeof(float)
              <= (size_t)BT * LDA * sizeof(bf16), "C aliases A");

__global__ void __launch_bounds__(THREADS)
lstm_bwd_step_kernel(const bf16* __restrict__ g_out,   // [nd,T,B,H]
                     const bf16* __restrict__ gates,   // [nd,T,B,4H]
                     const bf16* __restrict__ c_seq,   // [nd,T,B,H]
                     const bf16* __restrict__ wh,      // [nd,H,4H]
                     const int* __restrict__ start,    // [nd,B]
                     const int* __restrict__ end,      // [nd,B]
                     float* __restrict__ dh_state,     // [nd,B,H]
                     float* __restrict__ dc_state,     // [nd,B,H]
                     bf16* __restrict__ dxproj,        // [nd,T,B,4H]
                     float* __restrict__ db_part,      // [nbt,nd,4H]
                     int t, int T, int B, int H) {
  __shared__ __align__(128) bf16 As[BT * LDA];        // dgates_{t+1} rows
  __shared__ __align__(128) bf16 Bs[JT * LDB];        // wh rows (units)
  __shared__ float red[THREADS / JT][4][JT];          // db row sums
  float* Cs = reinterpret_cast<float*>(As);           // [2][BT][LDC]

  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JT;
  const int b0 = blockIdx.y * BT;
  const int nd = gridDim.z;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tile = warp & 3;                // output 16x16 tile
  const int rb = tile & 1, cb = tile >> 1;  // its row / unit tile
  const int half = warp >> 2;               // which half of a K chunk
  const bool has_next = t + 1 < T;

  if (has_next) {
    const bf16* dg = dxproj + (((size_t)d * T + t + 1) * B) * G;
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
  float part[4] = {0.f, 0.f, 0.f, 0.f};
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
      const float dc = dc_state[so];
      const float mf =
          (t >= start[d * B + bb] && t < end[d * B + bb]) ? 1.f : 0.f;
      const bf16* gp = gates + ot * G;
      const float gi = __bfloat162float(gp[0 * H + j]);
      const float gf = __bfloat162float(gp[1 * H + j]);
      const float gg = __bfloat162float(gp[2 * H + j]);
      const float go = __bfloat162float(gp[3 * H + j]);
      const float c_t = __bfloat162float(c_seq[ot * H + j]);
      const float c_prev =
          t > 0 ? __bfloat162float(c_seq[(ot - B) * H + j]) : 0.f;
      const float tanh_c = tanhf(c_t);

      const float dh_total = dh + mf * __bfloat162float(g_out[ot * H + j]);
      const float dh_new = mf * dh_total;
      const float dh_prev_direct = (1.f - mf) * dh_total;
      const float d_o = dh_new * tanh_c;
      const float dc_from_h = dh_new * go * (1.f - tanh_c * tanh_c);
      const float dc_total = mf * dc + dc_from_h;
      const float dc_prev_direct = (1.f - mf) * dc;
      const float df = dc_total * c_prev;
      const float di = dc_total * gg;
      const float dg = dc_total * gi;
      const float dc_prev_from_new = dc_total * gf;

      const float dpre[4] = {di * gi * (1.f - gi), df * gf * (1.f - gf),
                             dg * (1.f - gg * gg), d_o * go * (1.f - go)};
      bf16* dx = dxproj + ot * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dx[g * H + j] = __float2bfloat16(dpre[g]);
        part[g] += dpre[g];
      }
      dh_state[so] = dh_prev_direct;
      dc_state[so] = dc_prev_direct + dc_prev_from_new;
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) red[r][g][u] = part[g];
  __syncthreads();
  if (tid < 4 * JT) {
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

// One layer's BPTT: T launches of lstm_bwd_step_kernel on `stream`, in
// reverse time. Needs H % 16 == 0 and 16-byte aligned dxproj / wh.
// dh_state / dc_state [nd,B,H] f32 and db_part [ceil(B/32), nd, 4H] f32
// are zeroed by the caller. Returns cudaError_t.
extern "C" int lstm_bwd_seq(const void* g_out, const void* gates,
                            const void* c_seq, const void* wh,
                            const void* start, const void* end,
                            void* dh_state, void* dc_state, void* dxproj,
                            void* db_part, int nd, int T, int B, int H,
                            void* stream) {
  if (nd <= 0 || T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if (H % 16 != 0 || (B + BT - 1) / BT > 65535 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT, nd);
  for (int t = T - 1; t >= 0; --t) {
    lstm_bwd_step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)g_out, (const bf16*)gates, (const bf16*)c_seq,
        (const bf16*)wh, (const int*)start, (const int*)end,
        (float*)dh_state, (float*)dc_state, (bf16*)dxproj, (float*)db_part,
        t, T, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
