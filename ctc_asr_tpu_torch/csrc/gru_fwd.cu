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
// What bounds it on the H100: not bytes and not operations but a strict
// chain of T steps. A step is a [B, H] x [H, 3H] product (nd=2, B=128,
// H=512: 0.40 GFLOP, under a microsecond of tensor-core work) plus the
// cell, and the next step needs all of this step's h. So the cost of a
// step is latency: the exchange of h between the SMs, the barrier, and
// whatever is fetched again although it never changes.
//
// What the design does about it: ONE cooperative launch runs all T steps,
// on the pieces of csrc/recurrence.cuh and the plan of lstm_fwd.cu (K2).
// - A block owns JT hidden units of one direction (the 3*JT gate columns
//   {r,z,n} of those units, so the cell needs no exchange) for BT batch
//   rows, for the whole sequence. Its slice wh[d][:, g*H + j0 .. +JT] is
//   gathered into shared memory once and stays there.
// - The product is wgmma, transposed: D^T[gate columns, rows] = Wa x h^T,
//   the resident slice as the 64-row operand A. 3*JT columns (96 or 48)
//   are no multiple of 64, so the slice is padded with a fourth group of
//   zero columns to 4*JT: K2's tile shapes, ring and warpgroup split carry
//   over unchanged (a wgmma costs about the same however many of its rows
//   are zero, and the product is ~1 us of a step).
// - The n gate cannot add its x and h parts before the nonlinearity, so
//   the product tile holds hproj alone; the cell reads x_r, x_z, x_n from
//   the xproj tile and hproj_r, hproj_z, hproj_n from the product.
// - h is consumed in f32 by z * h_{t-1} (the reference keeps an f32
//   state), so each block keeps its (row, unit) pairs' f32 h in shared
//   memory for all T; the other blocks get it as bf16 through a ping-pong
//   buffer in global memory (step t reads buffer t&1, writes (t+1)&1),
//   read by TMA (L2, never a stale L1 line) in K chunks through a ring of
//   stages that one producer thread feeds; a barrier per (direction, row
//   block) group separates the steps (see lstm_fwd.cu for why two buffers
//   and one barrier a step suffice).
// - xproj[t+1] is fetched while the block waits at the barrier; the bias
//   and the windows are loaded once; h_out and the residual gates of the
//   last pass are written after the block's arrival, off the chain.
// - sigmoid and tanh use the special-function exp (error ~1e-7, far
//   below the bf16 the outputs are rounded to).
// bf16 x bf16 products are exact in f32, so only the order of the f32
// sums (and fused multiply-adds in the cell) differs from the plain
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrence.cuh"

// Internal linkage: each source has its own Params, Layout and launch
// under these names.
namespace {

namespace rc = recurrence;
typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* xproj;    // [nd,T,B,3H]
  const float* bias;    // [nd,3H]
  const bf16* wh;       // [nd,H,3H]
  const int* start;     // [nd,B]
  const int* end;       // [nd,B]
  bf16* hb;             // [2,nd,B,H] ping-pong, exchanged between blocks
  unsigned* sync;       // [nd, row blocks] barrier counters, zeroed
  bf16* h_out;          // [nd,T,B,H]
  bf16* gates_out;      // [nd,T,B,4H] or null
  int T, B, H, BT;
};

// K2's tiling with the gate columns padded to 4*JT. JT = 32: the two
// warpgroups take rows 0-63 ({r, z}) and 64-127 ({n, zero}) of D^T for
// the same 32 batch rows. JT = 16: both take the 64 rows, for rows 0-31
// and 32-63 of a pass of 64.
template <int JT>
struct Layout {
  static constexpr int M = 4 * JT;                 // product rows
  static constexpr int GC = 3 * JT;                // gate columns r, z, n
  static constexpr int PR = JT == 32 ? 32 : 64;    // rows of a pass
  static constexpr int KC = JT == 32 ? 256 : 128;  // K chunk of the h slab
  static constexpr int STAGES = JT == 32 ? 3 : 4;  // ring stages
  static constexpr int LDC = M + 4;                // f32
  size_t wa, ring, cs, xs, hst, bias, se, bars, total;
  __host__ __device__ Layout(int H, int BT) {
    size_t o = 0;
    wa = o;   o += rc::align1024((size_t)(H + 63) / 64 * 64 * M * sizeof(bf16));
    ring = o; o += rc::align1024((size_t)STAGES * KC * PR * sizeof(bf16));
    cs = o;   o += rc::align128((size_t)PR * LDC * sizeof(float));
    xs = o;   o += rc::align128((size_t)BT * GC * sizeof(bf16));
    hst = o;  o += rc::align128((size_t)BT * JT * sizeof(float));
    bias = o; o += rc::align128((size_t)GC * sizeof(float));
    se = o;   o += rc::align128((size_t)2 * BT * sizeof(int));
    bars = o; o += rc::align128((size_t)2 * STAGES * sizeof(long long));
    total = o;
  }
};

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

template <int JT>
__global__ void __launch_bounds__(rc::THREADS, 1)
gru_fwd_persistent_kernel(const Params p,
                          const __grid_constant__ CUtensorMap hmap) {
  constexpr int M = Layout<JT>::M;
  constexpr int GC = Layout<JT>::GC;
  constexpr int PR = Layout<JT>::PR;
  constexpr int STAGES = Layout<JT>::STAGES;
  constexpr int KC = Layout<JT>::KC;
  constexpr int LDC = Layout<JT>::LDC;
  constexpr int CONSUMERS = rc::CONSUMERS;
  constexpr int RSTEP = CONSUMERS / JT;   // row stride of a thread's pairs
  constexpr int RPT = PR / RSTEP;         // (row, unit) pairs per thread
  constexpr int XPR = GC / 8;             // 16-byte pieces per xproj row
  constexpr int STAGE = KC * PR;          // bf16 elements of a ring stage
  static_assert(RPT == 4, "the cell keeps 4 pairs a thread");

  extern __shared__ __align__(1024) unsigned char smem[];
  const int T = p.T, B = p.B, H = p.H, BT = p.BT, G = 3 * p.H;
  const Layout<JT> lay(H, BT);
  bf16* Wa = reinterpret_cast<bf16*>(smem + lay.wa);       // atoms [M][64]
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);   // [STAGES] atoms [PR][64]
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);     // [PR][LDC]
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);       // [BT][GC]
  float* hst = reinterpret_cast<float*>(smem + lay.hst);   // [BT][JT]
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  int* st_s = reinterpret_cast<int*>(smem + lay.se);       // [BT]
  int* en_s = st_s + BT;                                   // [BT]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + lay.bars);   // [STAGES]
  unsigned long long* empty = full + STAGES;                    // [STAGES]

  const int tid = threadIdx.x;
  const bool producer = tid >= CONSUMERS;     // warp 8 feeds the ring
  const int lane = tid % 32;
  const int wq = (tid / 32) % 4;              // warp within its warpgroup
  const int wg = tid / 128;                   // warpgroup (consumers: 0, 1)
  const int nd = gridDim.z;
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JT;
  const int b0 = blockIdx.y * BT;
  const int rows = min(BT, B - b0);           // > 0: the grid covers B
  const int npass = (rows + PR - 1) / PR;
  const int nkc = (H + KC - 1) / KC;
  const int nq = npass * nkc;                 // chunks of one step
  const int m_base = JT == 32 ? 64 * wg : 0;  // this warpgroup's D^T rows
  const int n_base = JT == 32 ? 0 : 32 * wg;  // and its rows of the pass
  const int u = tid % JT;                     // unit within the block
  const int r = tid / JT;                     // first row of its pairs
  const int j = j0 + u;
  const bf16* xp_d = p.xproj + (size_t)d * T * B * G;
  unsigned* counter = p.sync + d * gridDim.y + blockIdx.y;
  const unsigned group = gridDim.x;           // blocks that share the rows
  const unsigned long long desc_a = rc::smem_desc(Wa);

  // xproj[d, t, b0 .. b0+rows, the block's 3*JT columns] -> xs (consumers)
  auto fetch_x = [&](int t) {
    for (int e = tid; e < rows * XPR; e += CONSUMERS) {
      const int rr = e / XPR, g = (e % XPR) / (JT / 8), q = e % (JT / 8);
      if (j0 + q * 8 < H)
        rc::cp_async16(xs + rr * GC + g * JT + q * 8,
                       xp_d + ((size_t)t * B + b0 + rr) * G + g * H + j0
                           + q * 8);
    }
  };

  // once: the resident slice (r, z, n and a zero group), the bias, the
  // windows, xproj[0], the mbarriers of the ring
  if (!producer) {
    fetch_x(0);
    rc::cp_async_commit();
  }
  rc::load_gate_columns<4, JT>(Wa, p.wh + (size_t)d * H * G, H, j0, 3);
  for (int e = tid; e < GC; e += rc::THREADS) {
    const int g = e / JT, uu = e % JT;
    bias_s[e] = j0 + uu < H ? p.bias[(size_t)d * G + g * H + j0 + uu] : 0.f;
  }
  for (int e = tid; e < BT; e += rc::THREADS) {
    st_s[e] = e < rows ? p.start[d * B + b0 + e] : 0;
    en_s[e] = e < rows ? p.end[d * B + b0 + e] : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rc::mbar_init(full + s, 1);                   // the producer + bytes
      rc::mbar_init(empty + s, CONSUMERS / 32);     // one arrival a warp
    }
  }
  rc::cp_async_wait<0>();
  rc::fence_proxy_async();
  __syncthreads();

  // what the cell of the step's last pass leaves to be written after the
  // block's arrival at the barrier
  bf16 o_h[RPT], o_g[RPT][4];
  bool o_m[RPT];
  // Chunks handed over so far, counted alike by producers and consumers:
  // chunk g goes through stage g % STAGES, and is the (g / STAGES)-th use
  // of that stage, which gives the parity its mbarriers are waited with.
  int g_chunk = 0;
  // the h exchange [2 * nd * B, H]: step t reads h_{t-1} from half t&1
  // and writes h_t to the other
  rc::PingPong hx(0, nd, d, B, b0);

  for (int t = 0; t < T; ++t) {
    const bool product = t > 0;               // h_{-1} = 0: no product

    // h_out, and the gates in residual mode, of the pairs of `pass`
    auto write_outputs = [&](int pass) {
      if (j >= H) return;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int br = pass * PR + r + RSTEP * i;
        if (br >= rows) continue;
        const size_t ot = ((size_t)d * T + t) * B + b0 + br;
        p.h_out[ot * H + j] = o_m[i] ? o_h[i] : __float2bfloat16(0.f);
        if (p.gates_out != nullptr) {
          bf16* gp = p.gates_out + ot * 4 * H;
#pragma unroll
          for (int g = 0; g < 4; ++g) gp[g * H + j] = o_g[i][g];
        }
      }
    };

    if (producer) {
      // the slab of h_{t-1}, chunk after chunk, as far ahead of the
      // products as the ring has free stages: one thread, one TMA
      // instruction per box of [PR rows, 64 k]
      if (product && tid == CONSUMERS) {
        rc::fence_proxy_async_global();   // after the barrier's acquire
        for (int q = 0; q < nq; ++q, ++g_chunk) {
          const int s = g_chunk % STAGES, use = g_chunk / STAGES;
          const int pass = q / nkc, k0 = (q % nkc) * KC;
          const int natoms = (min(KC, H - k0) + 63) / 64;
          rc::mbar_wait(empty + s, (use & 1) ^ 1);
          rc::mbar_expect_tx(full + s, natoms * PR * 128);
          for (int a = 0; a < natoms; ++a)
            rc::tma_load_box(ring + s * STAGE + a * PR * 64, &hmap,
                             k0 + 64 * a, hx.read + pass * PR, full + s);
        }
      }
    } else {
      for (int pass = 0; pass < npass; ++pass) {
        if (product) {
          // a warpgroup whose 32 rows are all padding needs no product
          const bool active = pass * PR + n_base < rows;
          float acc[16];
          for (int kc = 0; kc < nkc; ++kc, ++g_chunk) {
            const int s = g_chunk % STAGES, use = g_chunk / STAGES;
            rc::mbar_wait(full + s, use & 1);
            if (active) {
              const unsigned long long db = rc::smem_desc(ring + s * STAGE);
              const int nks = min(KC, H - kc * KC) / 16;
              rc::wgmma_fence();
              for (int ks = 0; ks < nks; ++ks)
                rc::wgmma_m64n32k16(
                    acc, rc::desc_at(desc_a, M, kc * (KC / 16) + ks, m_base),
                    rc::desc_at(db, PR, ks, n_base), kc > 0 || ks > 0);
              rc::wgmma_commit();
            }
            if (kc > 0) {
              // the products of the chunk before are done: its stage
              // goes back to the producers
              rc::wgmma_wait<1>();
              if (lane == 0)
                rc::mbar_arrive(empty + (g_chunk - 1) % STAGES);
            }
          }
          rc::wgmma_wait<0>();
          if (lane == 0) rc::mbar_arrive(empty + (g_chunk - 1) % STAGES);
          rc::consumer_sync();    // the cell of the pass before has read Cs
          if (active) {
            rc::acc_fence(acc);
            float* cw = Cs + (n_base + 2 * (lane % 4)) * LDC + m_base
                        + 16 * wq + lane / 4;
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  cw[(8 * jn + c) * LDC + 8 * hh] = acc[4 * jn + 2 * hh + c];
          }
        }
        rc::cp_async_wait<0>();   // this thread's share of xproj[t]
        rc::consumer_sync();

        // the cell: each thread owns RPT (row, unit) pairs of the pass
        if (j < H) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int rr = r + RSTEP * i;
            const int br = pass * PR + rr;        // row within the block
            if (br >= rows) continue;
            float x[3], hp[3];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              x[g] = __bfloat162float(xs[br * GC + g * JT + u])
                     + bias_s[g * JT + u];
              hp[g] = product ? Cs[rr * LDC + g * JT + u] : 0.f;
            }
            const float gr = sigmoid_fast(x[0] + hp[0]);
            const float gz = sigmoid_fast(x[1] + hp[1]);
            const float gn = tanh_fast(x[2] + gr * hp[2]);
            const float h_old = product ? hst[br * JT + u] : 0.f;
            const float h_new = (1.f - gz) * gn + gz * h_old;
            const bool m = t >= st_s[br] && t < en_s[br];
            const float h_keep = m ? h_new : h_old;
            const bf16 hb = __float2bfloat16(h_keep);
            hst[br * JT + u] = h_keep;
            // the exchanged h first: it is what the other blocks wait for
            if (t + 1 < T) p.hb[(size_t)(hx.write + br) * H + j] = hb;
            o_m[i] = m;
            o_h[i] = hb;
            o_g[i][0] = __float2bfloat16(gr);
            o_g[i][1] = __float2bfloat16(gz);
            o_g[i][2] = __float2bfloat16(gn);
            o_g[i][3] = __float2bfloat16(hp[2]);
          }
        }
        if (pass + 1 < npass) write_outputs(pass);
      }
    }

    if (t + 1 < T) {
      // h_t was stored through the generic proxy and is read by TMA
      if (!producer) rc::fence_proxy_async_global();
      __syncthreads();        // every thread's h_t is written, xs is free
      if (!producer) {
        fetch_x(t + 1);       // arrives while the block waits
        rc::cp_async_commit();
      }
      if (tid == 0) rc::group_arrive(counter);
      if (!producer) write_outputs(npass - 1);   // off the chain
      if (tid == 0) rc::group_wait(counter, (unsigned)(t + 1) * group);
      __syncthreads();
    } else if (!producer) {
      write_outputs(npass - 1);
    }
    hx.swap();
  }
}

template <int JT>
cudaError_t launch(const Params& p, int nd, int smem_bytes,
                   cudaStream_t stream) {
  static bool ready[rc::MAX_DEVICES] = {};
  const Layout<JT> lay(p.H, p.BT);
  if (lay.total != (size_t)smem_bytes) return cudaErrorInvalidValue;
  const dim3 grid((p.H + JT - 1) / JT, (p.B + p.BT - 1) / p.BT, nd);
  Params q = p;
  // the h exchange as a matrix [2 * nd * B, H] for the slab's boxes
  CUtensorMap hmap;
  const cudaError_t err = rc::make_slab_map(
      &hmap, p.hb, 2ull * nd * p.B, p.H, Layout<JT>::PR);
  if (err != cudaSuccess) return err;
  void* args[] = {&q, &hmap};
  return rc::launch_persistent(
      reinterpret_cast<const void*>(&gru_fwd_persistent_kernel<JT>), ready,
      grid, lay.total, args, stream);
}

}  // namespace

// One layer in ONE cooperative launch on `stream`, with the plan the host
// made (plan_recurrence, gate_mult=3): JT units and BT rows a block,
// smem_bytes of dynamic shared memory (checked against the kernel's own
// layout). Needs H % 16 == 0, BT % 32 == 0, 16-byte aligned xproj / wh /
// hb16. hb16 is [2, nd, B, H] bf16, uninitialized; sync is
// [nd * ceil(B / BT)] uint32, zeroed by the caller. gates_out
// [nd,T,B,4H] (bf16) is given for training or null for inference.
// Returns cudaError_t; a grid that cannot be co-resident gives
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int gru_fwd_persistent(const void* xproj, const void* bias,
                                  const void* wh, const void* start,
                                  const void* end, void* hb16, void* sync,
                                  void* h_out, void* gates_out, int nd,
                                  int T, int B, int H, int jt, int bt,
                                  int smem_bytes, void* stream) {
  if (nd <= 0 || T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if (H % 16 != 0 || bt <= 0 || bt % 32 != 0 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = {(const bf16*)xproj, (const float*)bias, (const bf16*)wh,
                    (const int*)start, (const int*)end, (bf16*)hb16,
                    (unsigned*)sync, (bf16*)h_out, (bf16*)gates_out,
                    T, B, H, bt};
  if (jt == 32) return (int)launch<32>(p, nd, smem_bytes, (cudaStream_t)stream);
  if (jt == 16) return (int)launch<16>(p, nd, smem_bytes, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
