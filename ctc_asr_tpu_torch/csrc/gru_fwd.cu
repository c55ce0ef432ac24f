// Forward recurrence of one fused (bi)GRU layer (K4).
//
// Replaces: ctc_asr_tpu/ops/lstm_pallas.py, _gru_fwd_kernel (launched by
// _gru_run_fwd / gru_seq_pallas). For direction d, row b and step t:
//   hproj = bf16(h_{t-1}[d,b]) @ wh[d]                     (f32 sum)
//   x = xproj[d,t,b] + bias[d]                             (f32)
//   r = sigmoid(x_r + hproj_r);  z = sigmoid(x_z + hproj_z)
//   n = tanh(x_n + r * hproj_n);  h_t = (1 - z) * n + z * h_{t-1}
// Outside the row's window [start, end) the state carries through
// unchanged and the output is 0 (lstm_pallas.py:502-505). A fused BiGRU
// passes the statically flipped input as direction 1 with window
// [T-len, T); the caller flips its output back. Inference writes h only;
// in residual mode (training) the launch also stores (r, z, n, hproj_n)
// as bf16 [.., 4H] at every step, masked or not, for the BPTT kernel
// (gru_bwd.cu), exactly as lstm_pallas.py:506-507. A null residual
// pointer gives the inference launch.
//
// What bounds it on the H100: a strict chain of T steps, each a
// [B, H] x [H, 3H] product (nd=2, B=128, H=512: 0.40 GFLOP, 3 MB of
// bf16 weights re-read from L2 every step) plus the cell. The product
// is small for the tensor cores; the step's latency is the cost: the
// launch, the L2 -> shared-memory copies of h and wh, and the barrier.
//
// What the design does about it, simple first (the mapping of
// lstm_fwd.cu with three gate columns): the host loop over t runs inside
// this library (one ctypes call per layer), one launch per step on the
// caller's stream. A block owns 32 hidden units j of one direction for
// 32 batch rows and computes exactly the three gate columns {r,z,n} of
// those units, so the cell update needs no exchange between blocks. The
// n gate cannot add its x and h parts before the nonlinearity, so the
// [32, 96] tile holds hproj alone and the cell adds xproj afterwards.
// Per K chunk of 256, h (a bf16 copy kept beside the f32 state, so it is
// the bf16 the reference feeds the product) and the 96 wh columns are
// copied to shared memory with cp.async (16 bytes a copy), and bf16
// tensor-core products (WMMA 16x16x16, f32 accumulation) fill the tile:
// 2 x 6 output tiles, two to each of six warps (the other two warps of
// the block only copy and run the cell). h ping-pongs between two
// buffers (step t reads one, writes the other), so no block reads an h
// another block is writing. bf16 x bf16 products are exact in f32, so
// only the order of the f32 sums (and one fused multiply-add in the
// cell) differs from the plain version. Left for later: a persistent
// kernel with wh resident across SMs and a grid-wide barrier per step.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NG = 3;         // gate columns r, z, n
constexpr int JT = 32;        // hidden units per block (96 gate columns)
constexpr int BT = 32;        // batch rows per block
constexpr int KC = 256;       // K chunk staged in shared memory
constexpr int THREADS = 256;  // 8 warps; 6 of them run the product
constexpr int MMA_WARPS = (BT / 16) * (NG * JT / 16) / 2;  // 2 tiles each
constexpr int RPT = BT / (THREADS / JT);  // rows per thread in the cell
constexpr int LDA = KC + 8;               // bf16, padded rows
constexpr int LDB = NG * JT + 8;          // bf16
constexpr int LDC = NG * JT + 4;          // f32
constexpr size_t A_BYTES = (size_t)BT * LDA * sizeof(bf16);
constexpr size_t B_BYTES = (size_t)KC * LDB * sizeof(bf16);
constexpr size_t SMEM_BYTES = A_BYTES + B_BYTES;
static_assert(MMA_WARPS == 6 && MMA_WARPS <= THREADS / 32, "tile mapping");
static_assert(A_BYTES % 128 == 0, "B tile alignment");
static_assert(LDB % 8 == 0 && LDC % 4 == 0, "WMMA leading dimensions");
static_assert((size_t)BT * LDC * sizeof(float) <= B_BYTES, "C aliases B");
static_assert(RPT == 4, "cell mapping assumes 4 rows per thread");

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
gru_step_kernel(const bf16* __restrict__ xproj,   // [nd,T,B,3H]
                const float* __restrict__ bias,   // [nd,3H]
                const bf16* __restrict__ wh,      // [nd,H,3H]
                const int* __restrict__ start,    // [nd,B]
                const int* __restrict__ end,      // [nd,B]
                const float* __restrict__ h_prev,     // [nd,B,H] f32
                const bf16* __restrict__ hb_prev,     // [nd,B,H] bf16 copy
                float* __restrict__ h_next,
                bf16* __restrict__ hb_next,
                bf16* __restrict__ h_out,             // [nd,T,B,H]
                bf16* __restrict__ gates_out,         // [nd,T,B,4H] or null
                int t, int T, int B, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);             // [BT][LDA]
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);   // [KC][LDB]
  float* Cs = reinterpret_cast<float*>(smem + A_BYTES); // [BT][LDC], after K

  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JT;
  const int b0 = blockIdx.y * BT;
  const int G = NG * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const bool mma_warp = warp < MMA_WARPS;
  const int rb = warp & 1;            // 16-row tile of this warp
  const int cb = (warp >> 1) * 2;     // its two 16-column tiles (of six)
  const bf16* hb = hb_prev + (size_t)d * B * H;
  const bf16* w = wh + (size_t)d * H * G;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < H; k0 += KC) {
    // A: rows b0.. of bf16 h, columns k0..k0+KC (8 bf16 per copy)
    for (int e = tid; e < BT * (KC / 8); e += THREADS) {
      const int rr = e / (KC / 8), k = k0 + (e % (KC / 8)) * 8;
      bf16* dst = As + rr * LDA + (e % (KC / 8)) * 8;
      if (b0 + rr < B && k < H)
        __pipeline_memcpy_async(dst, hb + (size_t)(b0 + rr) * H + k, 16);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    // B: rows k0..k0+KC of wh, the columns g*H + j0 .. +32 of each gate
    for (int e = tid; e < KC * NG * 4; e += THREADS) {
      const int kk = e / (NG * 4), g = (e % (NG * 4)) / 4, q = e % 4;
      const int k = k0 + kk, j = j0 + q * 8;
      bf16* dst = Bs + kk * LDB + g * JT + q * 8;
      if (k < H && j < H)
        __pipeline_memcpy_async(dst, w + (size_t)k * G + g * H + j, 16);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (mma_warp) {
      const int nks = min(KC, H - k0) / 16;
      for (int ks = 0; ks < nks; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, As + rb * 16 * LDA + ks * 16, LDA);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bm;
          wmma::load_matrix_sync(bm, Bs + ks * 16 * LDB + (cb + i) * 16,
                                 LDB);
          wmma::mma_sync(acc[i], a, bm, acc[i]);
        }
      }
    }
    __syncthreads();   // tiles are rewritten by the next chunk / by C
  }
  if (mma_warp) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(Cs + rb * 16 * LDC + (cb + i) * 16, acc[i],
                              LDC, wmma::mem_row_major);
  }
  __syncthreads();

  const int u = tid % JT;             // unit within the block
  const int r = tid / JT;             // rows r, r+8, r+16, r+24
  const int j = j0 + u;
  if (j >= H) return;
  const float* bd = bias + (size_t)d * G;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rr = r + 8 * i, bb = b0 + rr;
    if (bb >= B) continue;
    const bf16* xp = xproj + (((size_t)d * T + t) * B + bb) * G;
    const float xr = __bfloat162float(xp[0 * H + j]) + bd[0 * H + j];
    const float xz = __bfloat162float(xp[1 * H + j]) + bd[1 * H + j];
    const float xn = __bfloat162float(xp[2 * H + j]) + bd[2 * H + j];
    const float hr = Cs[rr * LDC + 0 * JT + u];
    const float hz = Cs[rr * LDC + 1 * JT + u];
    const float hn = Cs[rr * LDC + 2 * JT + u];
    const float gr = sigmoidf(xr + hr);
    const float gz = sigmoidf(xz + hz);
    const float gn = tanhf(xn + gr * hn);
    const size_t so = ((size_t)d * B + bb) * H + j;
    const float h_old = h_prev[so];
    const float h_new = (1.f - gz) * gn + gz * h_old;
    const bool m = t >= start[d * B + bb] && t < end[d * B + bb];
    const float h = m ? h_new : h_old;
    h_next[so] = h;
    hb_next[so] = __float2bfloat16(h);
    const size_t ot = ((size_t)d * T + t) * B + bb;
    h_out[ot * H + j] = __float2bfloat16(m ? h : 0.f);
    if (gates_out != nullptr) {
      bf16* gp = gates_out + ot * 4 * H;
      gp[0 * H + j] = __float2bfloat16(gr);
      gp[1 * H + j] = __float2bfloat16(gz);
      gp[2 * H + j] = __float2bfloat16(gn);
      gp[3 * H + j] = __float2bfloat16(hn);
    }
  }
}

}  // namespace

// One layer: T launches of gru_step_kernel on `stream`. Needs H % 16 == 0
// and 16-byte aligned xproj/wh/hb16. hbuf is [2, nd, B, H] f32 and hb16
// [2, nd, B, H] bf16, each with index 0 zeroed by the caller. gates_out
// [nd,T,B,4H] (bf16) is given for training or null for inference.
// Returns cudaError_t.
extern "C" int gru_fwd_seq(const void* xproj, const void* bias,
                           const void* wh, const void* start,
                           const void* end, void* hbuf, void* hb16,
                           void* h_out, void* gates_out, int nd, int T,
                           int B, int H, void* stream) {
  if (nd <= 0 || T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if (H % 16 != 0 || (B + BT - 1) / BT > 65535 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT, nd);
  const size_t state = (size_t)nd * B * H;
  float* hf = (float*)hbuf;
  bf16* hb = (bf16*)hb16;
  for (int t = 0; t < T; ++t) {
    const size_t cur = (t & 1) * state, nxt = ((t + 1) & 1) * state;
    gru_step_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const bf16*)xproj, (const float*)bias, (const bf16*)wh,
        (const int*)start, (const int*)end, hf + cur, hb + cur, hf + nxt,
        hb + nxt, (bf16*)h_out, (bf16*)gates_out, t, T, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
