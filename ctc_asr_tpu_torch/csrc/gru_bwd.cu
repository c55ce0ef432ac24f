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
// round twice and drift along the chain. So the step exchanges dhproj,
// not dxproj, through a [2, nd, B, 3H] bf16 ping-pong buffer: step t
// reads half (t+1)&1 and writes half t&1.
//
// What bounds it on the H100: like the forward, a strict chain of T
// steps, each a [B, 3H] x [3H, H] product (nd=2, B=128, H=512: 0.40
// GFLOP a step, under a microsecond of tensor-core work) plus the cell;
// step t needs every block's dhproj of step t+1. The cost of a step is
// latency: the exchange of dhproj between the SMs (three times the
// forward's h), the barrier, and whatever is fetched again although it
// never changes.
//
// What the design does about it: ONE cooperative launch runs all T steps
// in reverse time, on the pieces of csrc/recurrence.cuh and the plan of
// lstm_bwd.cu (K3).
// - A block owns JT hidden units of one direction for BT batch rows. Its
//   resident slice is the wh rows of its units, wh[d][j0 .. +JT, :]
//   (JT x 3H bf16), copied to shared memory once: the K-major operand B
//   of dhproj_{t+1} @ wh^T.
// - After the group's barrier one producer thread reads dhproj_{t+1}
//   [rows, 3H] by TMA (L2) in chunks through a ring of stages that a
//   "full" and an "empty" mbarrier per stage hand to the two consumer
//   warpgroups and back. Two halves and one barrier a step suffice: a
//   block writes half t&1 in step t only after barrier t+1, which every
//   block of the group passes only after its last read of that half (the
//   reads of step t+1, of dhproj_{t+2}).
// - The product is wgmma with the slab as the 64-row operand A. JT = 32:
//   the output tile is [32 rows x 32 units], and a wgmma costs ~80 cycles
//   however small it is, so the two halves of K are stacked as rows of
//   both operands and one m64n64k16 forms both halves' partial products
//   (recurrence.cuh). K = 3H halves into no whole k-step where H / 16 is
//   odd (H = 400, 800), so the halves are KH = 3H/2 rounded up to whole
//   atoms of 64 columns, the second half zero-padded. JT = 16 takes
//   m64n16k16 on passes of 64 rows, the warpgroups on alternate k-steps,
//   over K = 3H stored in whole atoms. The cell adds the two partial
//   tiles in a fixed order.
// - dh_carry of the block's (row, unit) pairs lives in shared memory for
//   all T; db is summed in registers over all T and rows and written once
//   per block into db_part[row block, d, :] (no atomics, the same order
//   every run).
// - gates[t-1], h_seq[t-2] and g_out[t-1] for the block's tile are
//   fetched while the block waits at the barrier; dhproj is stored before
//   the arrival, and the last pass's dxproj after it, off the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrence.cuh"

// Internal linkage: each source has its own Params, Layout and launch
// under these names.
namespace {

namespace rc = recurrence;
typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* g_out;    // [nd,T,B,H]
  const bf16* gates;    // [nd,T,B,4H] (r, z, n, hn)
  const bf16* h_seq;    // [nd,T,B,H]
  const bf16* wh;       // [nd,H,3H]
  const int* start;     // [nd,B]
  const int* end;       // [nd,B]
  bf16* dhproj;         // [2,nd,B,3H] ping-pong, exchanged between blocks
  bf16* dxproj;         // [nd,T,B,3H]
  float* db_part;       // [row blocks, nd, 3H], every element written
  unsigned* sync;       // [nd, row blocks] barrier counters, zeroed
  int T, B, H, BT;
};

// The product of a pass: D[rows, JT units] = dhproj[rows, 3H] x
// Wr[JT, 3H]^T, the slab as operand A, the resident slice as operand B.
// JT = 32 (passes of 32 rows): the halves of K stacked as 64 rows, one
// m64n64k16 of warpgroup 0 per k-step of a half. JT = 16 (passes of 64
// rows): m64n16k16, the two warpgroups take the even and the odd k-steps.
template <int JT>
struct Layout {
  static constexpr int PR = JT == 32 ? 32 : 64;    // rows of a pass
  static constexpr int TR = 64;                    // rows of a ring tile
  static constexpr int KC = JT == 32 ? 256 : 128;  // K chunk of a tile row
  static constexpr int STAGES = JT == 32 ? 2 : 3;  // ring stages
  static constexpr int LDC = JT + 4;               // f32
  // the columns a row of the resident slice and of a ring tile spans:
  // JT = 32, half of K = 3H rounded up to whole atoms of 64; JT = 16, K
  __host__ __device__ static int span(int H) {
    return JT == 32 ? (3 * H + 127) / 128 * 64 : 3 * H;
  }
  size_t wr, ring, cs, dh, gt, hp, go, se, bars, total;
  __host__ __device__ Layout(int H, int BT) {
    size_t o = 0;
    wr = o;   o += rc::align1024((size_t)(JT == 32 ? 64 : JT)
                                 * ((span(H) + 63) / 64 * 64) * sizeof(bf16));
    ring = o; o += rc::align1024((size_t)STAGES * KC * TR * sizeof(bf16));
    cs = o;   o += rc::align128((size_t)2 * PR * LDC * sizeof(float));
    dh = o;   o += rc::align128((size_t)BT * JT * sizeof(float));
    gt = o;   o += rc::align128((size_t)BT * 4 * JT * sizeof(bf16));
    hp = o;   o += rc::align128((size_t)BT * JT * sizeof(bf16));
    go = o;   o += rc::align128((size_t)BT * JT * sizeof(bf16));
    se = o;   o += rc::align128((size_t)2 * BT * sizeof(int));
    bars = o; o += rc::align128((size_t)2 * STAGES * sizeof(long long));
    total = o;
  }
};

template <int JT>
__global__ void __launch_bounds__(rc::THREADS, 1)
gru_bwd_persistent_kernel(const Params p,
                          const __grid_constant__ CUtensorMap dmap) {
  constexpr int PR = Layout<JT>::PR;
  constexpr int STAGES = Layout<JT>::STAGES;
  constexpr int KC = Layout<JT>::KC;
  constexpr int LDC = Layout<JT>::LDC;
  constexpr int CONSUMERS = rc::CONSUMERS;
  constexpr int RSTEP = CONSUMERS / JT;   // row stride of a thread's pairs
  constexpr int RPT = PR / RSTEP;         // (row, unit) pairs per thread
  constexpr int PPG = JT / 8;             // 16-byte pieces per [.., JT] row
  constexpr int TR = Layout<JT>::TR;
  constexpr int STAGE = KC * TR;          // bf16 elements of a ring stage
  constexpr bool STACKED = JT == 32;      // K halves stacked as rows
  static_assert(RPT == 4, "the cell keeps 4 pairs a thread");
  static_assert((size_t)RSTEP * 3 * JT <= (size_t)2 * PR * LDC,
                "the db reduction aliases Cs");

  extern __shared__ __align__(1024) unsigned char smem[];
  const int T = p.T, B = p.B, H = p.H, BT = p.BT, G = 3 * p.H;
  const Layout<JT> lay(H, BT);
  bf16* Wr = reinterpret_cast<bf16*>(smem + lay.wr);       // atoms [JT or 64][64]
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);   // [STAGES] atoms [TR][64]
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);     // [2][PR][LDC]
  float* dh_s = reinterpret_cast<float*>(smem + lay.dh);   // [BT][JT]
  bf16* gt_s = reinterpret_cast<bf16*>(smem + lay.gt);     // [BT][4*JT]
  bf16* hp_s = reinterpret_cast<bf16*>(smem + lay.hp);     // [BT][JT] h_{t-1}
  bf16* go_s = reinterpret_cast<bf16*>(smem + lay.go);     // [BT][JT]
  int* st_s = reinterpret_cast<int*>(smem + lay.se);       // [BT]
  int* en_s = st_s + BT;                                   // [BT]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + lay.bars);   // [STAGES]
  unsigned long long* empty = full + STAGES;                    // [STAGES]

  const int tid = threadIdx.x;
  const bool producer = tid >= CONSUMERS;     // warp 8 feeds the ring
  const int lane = tid % 32;
  const int wq = (tid / 32) % 4;              // warp within its warpgroup
  const int wg = tid / 128;                   // warpgroup: its k-steps
  const int nd = gridDim.z;
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JT;
  const int b0 = blockIdx.y * BT;
  const int rows = min(BT, B - b0);           // > 0: the grid covers B
  const int npass = (rows + PR - 1) / PR;
  const int kw = Layout<JT>::span(H);         // columns a tile row spans
  const int nkc = (kw + KC - 1) / KC;
  const int nq = npass * nkc;                 // chunks of one step
  const int u = tid % JT;
  const int r = tid / JT;
  const int j = j0 + u;
  unsigned* counter = p.sync + d * gridDim.y + blockIdx.y;
  const unsigned group = gridDim.x;           // blocks that share the rows
  const unsigned long long desc_b = rc::smem_desc(Wr);

  // the block's tiles of gates[t], h_seq[t-1] and g_out[t] (consumers)
  auto fetch_inputs = [&](int t) {
    const size_t base = ((size_t)d * T + t) * B + b0;
    for (int e = tid; e < rows * 6 * PPG; e += CONSUMERS) {
      const int rr = e / (6 * PPG), a = (e % (6 * PPG)) / PPG, q = e % PPG;
      const int jj = j0 + q * 8;
      if (jj >= H) continue;
      const size_t row = base + rr;
      if (a < 4)
        rc::cp_async16(gt_s + rr * 4 * JT + a * JT + q * 8,
                       p.gates + row * 4 * H + a * H + jj);
      else if (a == 4) {
        if (t > 0)
          rc::cp_async16(hp_s + rr * JT + q * 8,
                         p.h_seq + (row - B) * H + jj);
      } else
        rc::cp_async16(go_s + rr * JT + q * 8, p.g_out + row * H + jj);
    }
  };

  // once: the resident slice, the windows, zero state, step T-1's inputs,
  // the mbarriers of the ring
  if constexpr (STACKED)
    rc::load_unit_rows_stacked(Wr, p.wh + (size_t)d * H * G, H, G, kw, j0);
  else
    rc::load_unit_rows<JT>(Wr, p.wh + (size_t)d * H * G, H, G, j0);
  if (!producer) fetch_inputs(T - 1);
  rc::cp_async_commit();
  for (int e = tid; e < BT * JT; e += rc::THREADS) dh_s[e] = 0.f;
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

  float dbacc[3] = {0.f, 0.f, 0.f};
  // what the cell of the step's last pass leaves to be written after the
  // block's arrival at the barrier
  bf16 o_dx[RPT][3];
  // Chunks handed over so far, counted alike by producers and consumers:
  // chunk g goes through stage g % STAGES, and is the (g / STAGES)-th use
  // of that stage, which gives the parity its mbarriers are waited with.
  int g_chunk = 0;
  // the dhproj exchange [2 * nd * B, 3H]: step t reads dhproj_{t+1} from
  // half (t+1)&1 and writes dhproj_t, read by the group in step t-1, to
  // half t&1
  rc::PingPong ex(T & 1, nd, d, B, b0);

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const bool has_next = s > 0;

    // dxproj[t] of the pairs of `pass`
    auto write_outputs = [&](int pass) {
      if (j >= H) return;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int br = pass * PR + r + RSTEP * i;
        if (br >= rows) continue;
        bf16* dx = p.dxproj + (((size_t)d * T + t) * B + b0 + br) * G;
#pragma unroll
        for (int g = 0; g < 3; ++g) dx[g * H + j] = o_dx[i][g];
      }
    };

    if (producer) {
      // the slab of dhproj_{t+1}, chunk after chunk, as far ahead of the
      // products as the ring has free stages: one thread, one TMA
      // instruction per box of [32 or 64 rows, 64 k]
      if (has_next && tid == CONSUMERS) {
        rc::fence_proxy_async_global();   // after the barrier's acquire
        for (int q = 0; q < nq; ++q, ++g_chunk) {
          const int st = g_chunk % STAGES, use = g_chunk / STAGES;
          const int pass = q / nkc, k0 = (q % nkc) * KC;
          const int natoms = (min(KC, kw - k0) + 63) / 64;
          rc::mbar_wait(empty + st, (use & 1) ^ 1);
          rc::mbar_expect_tx(full + st, natoms * TR * 128);
          for (int a = 0; a < natoms; ++a) {
            bf16* atom = ring + st * STAGE + a * TR * 64;
            if constexpr (STACKED) {
              // tile rows 0-31: columns [0, kw), rows 32-63: [kw, 3H)
              // (past 3H the box is filled with zeros)
              rc::tma_load_box(atom, &dmap, k0 + 64 * a, ex.read + pass * PR,
                               full + st);
              rc::tma_load_box(atom + 32 * 64, &dmap, kw + k0 + 64 * a,
                               ex.read + pass * PR, full + st);
            } else {
              rc::tma_load_box(atom, &dmap, k0 + 64 * a, ex.read + pass * PR,
                               full + st);
            }
          }
        }
      }
    } else {
      for (int pass = 0; pass < npass; ++pass) {
        if (has_next) {
          float acc[STACKED ? 32 : JT / 2];
          for (int kc = 0; kc < nkc; ++kc, ++g_chunk) {
            const int st = g_chunk % STAGES, use = g_chunk / STAGES;
            rc::mbar_wait(full + st, use & 1);
            const unsigned long long da = rc::smem_desc(ring + st * STAGE);
            const int nks = min(KC, kw - kc * KC) / 16;
            if constexpr (STACKED) {
              if (wg == 0) {
                rc::wgmma_fence();
                for (int ks = 0; ks < nks; ++ks)
                  rc::wgmma_m64n64k16(
                      acc, rc::desc_at(da, TR, ks, 0),
                      rc::desc_at(desc_b, 64, kc * (KC / 16) + ks, 0),
                      kc > 0 || ks > 0);
                rc::wgmma_commit();
              }
            } else {
              rc::wgmma_fence();
              for (int ks = wg; ks < nks; ks += 2)
                rc::wgmma_m64n16k16(
                    acc, rc::desc_at(da, TR, ks, 0),
                    rc::desc_at(desc_b, JT, kc * (KC / 16) + ks, 0),
                    kc > 0 || ks > wg);
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
          // D[m][n], m = 16*wq + lane/4 + 8*hh, n = 8*jn + 2*(lane%4) + c
          if constexpr (STACKED) {
            if (wg == 0) {
              rc::acc_fence(acc);
              // rows and units of half h = wq/2 of K: m, n in [32h, 32h+32)
              const int half = wq >> 1;
              float* cw = Cs + half * PR * LDC
                          + ((16 * wq + lane / 4) & 31) * LDC + 2 * (lane % 4);
#pragma unroll
              for (int jn = 0; jn < 8; ++jn) {
                if ((jn >> 2) == half) {
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int c = 0; c < 2; ++c)
                      cw[8 * hh * LDC + 8 * (jn & 3) + c] =
                          acc[4 * jn + 2 * hh + c];
                }
              }
            }
          } else {
            rc::acc_fence(acc);
            float* cw = Cs + wg * PR * LDC + (16 * wq + lane / 4) * LDC
                        + 2 * (lane % 4);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int jn = 0; jn < JT / 8; ++jn)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  cw[8 * hh * LDC + 8 * jn + c] = acc[4 * jn + 2 * hh + c];
          }
        }
        rc::cp_async_wait<0>();   // this thread's share of step t's inputs
        rc::consumer_sync();

        if (j < H) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int rr = r + RSTEP * i;
            const int br = pass * PR + rr;        // row within the block
            if (br >= rows) continue;
            const float dh_rec = has_next
                ? Cs[rr * LDC + u] + Cs[PR * LDC + rr * LDC + u] : 0.f;
            const float dh = dh_s[br * JT + u] + dh_rec;
            const float mf = (t >= st_s[br] && t < en_s[br]) ? 1.f : 0.f;
            const bf16* gp = gt_s + br * 4 * JT + u;
            const float gr = __bfloat162float(gp[0 * JT]);
            const float gz = __bfloat162float(gp[1 * JT]);
            const float gn = __bfloat162float(gp[2 * JT]);
            const float hn = __bfloat162float(gp[3 * JT]);
            const float h_prev =
                t > 0 ? __bfloat162float(hp_s[br * JT + u]) : 0.f;

            const float dh_total =
                dh + mf * __bfloat162float(go_s[br * JT + u]);
            const float dh_new = mf * dh_total;
            const float dz = dh_new * (h_prev - gn);
            const float dn_pre = dh_new * (1.f - gz) * (1.f - gn * gn);
            const float dr_pre = dn_pre * hn * gr * (1.f - gr);
            const float dz_pre = dz * gz * (1.f - gz);
            // the exchanged dhproj first: it is what the other blocks
            // wait for (step 0's is read by no one)
            if (t > 0) {
              bf16* dp = p.dhproj + (size_t)(ex.write + br) * G;
              dp[0 * H + j] = __float2bfloat16(dr_pre);
              dp[1 * H + j] = __float2bfloat16(dz_pre);
              dp[2 * H + j] = __float2bfloat16(dn_pre * gr);
            }
            o_dx[i][0] = __float2bfloat16(dr_pre);
            o_dx[i][1] = __float2bfloat16(dz_pre);
            o_dx[i][2] = __float2bfloat16(dn_pre);
            dbacc[0] += dr_pre;
            dbacc[1] += dz_pre;
            dbacc[2] += dn_pre;
            dh_s[br * JT + u] = (1.f - mf) * dh_total + dh_new * gz;
          }
        }
        if (pass + 1 < npass) write_outputs(pass);
      }
    }

    if (t > 0) {
      // dhproj_t was stored through the generic proxy and is read by TMA
      if (!producer) rc::fence_proxy_async_global();
      __syncthreads();        // every thread's dhproj_t is written
      if (!producer) {
        fetch_inputs(t - 1);  // arrives while the block waits
        rc::cp_async_commit();
      }
      if (tid == 0) rc::group_arrive(counter);
      if (!producer) write_outputs(npass - 1);   // off the chain
      if (tid == 0) rc::group_wait(counter, (unsigned)(s + 1) * group);
      __syncthreads();
    } else if (!producer) {
      write_outputs(npass - 1);
    }
    ex.swap();
  }

  // db: each thread's sums over all steps and its rows, then over the
  // threads of a unit in a fixed order; written once
  __syncthreads();
  float* red = Cs;                              // [RSTEP][3][JT]
  if (!producer) {
#pragma unroll
    for (int g = 0; g < 3; ++g) red[(r * 3 + g) * JT + u] = dbacc[g];
  }
  __syncthreads();
  if (tid < 3 * JT) {
    const int g = tid / JT, uu = tid % JT;
    if (j0 + uu < H) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < RSTEP; ++q) sum += red[(q * 3 + g) * JT + uu];
      p.db_part[((size_t)blockIdx.y * nd + d) * G + g * H + j0 + uu] = sum;
    }
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
  // the dhproj exchange as a matrix [2 * nd * B, 3H] for the slab's boxes
  CUtensorMap dmap;
  const cudaError_t err = rc::make_slab_map(
      &dmap, p.dhproj, 2ull * nd * p.B, 3ull * p.H, Layout<JT>::PR);
  if (err != cudaSuccess) return err;
  void* args[] = {&q, &dmap};
  return rc::launch_persistent(
      reinterpret_cast<const void*>(&gru_bwd_persistent_kernel<JT>), ready,
      grid, lay.total, args, stream);
}

}  // namespace

// One layer's BPTT in ONE cooperative launch on `stream`, with the plan
// the host made (plan_recurrence, gate_mult=3, backward): JT units and BT
// rows a block, smem_bytes of dynamic shared memory (checked against the
// kernel's own layout). Needs H % 16 == 0, BT % 32 == 0, 16-byte aligned
// tensors. dhproj is [2, nd, B, 3H] bf16 scratch, uninitialized (never
// read before it is written); db_part is [ceil(B / BT), nd, 3H] f32,
// uninitialized (every element is written); sync is [nd * ceil(B / BT)]
// uint32, zeroed by the caller. Returns cudaError_t; a grid that cannot
// be co-resident gives cudaErrorCooperativeLaunchTooLarge.
extern "C" int gru_bwd_persistent(const void* g_out, const void* gates,
                                  const void* h_seq, const void* wh,
                                  const void* start, const void* end,
                                  void* dhproj, void* dxproj, void* db_part,
                                  void* sync, int nd, int T, int B, int H,
                                  int jt, int bt, int smem_bytes,
                                  void* stream) {
  if (nd <= 0 || T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if (H % 16 != 0 || bt <= 0 || bt % 32 != 0 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = {(const bf16*)g_out, (const bf16*)gates,
                    (const bf16*)h_seq, (const bf16*)wh, (const int*)start,
                    (const int*)end, (bf16*)dhproj, (bf16*)dxproj,
                    (float*)db_part, (unsigned*)sync, T, B, H, bt};
  if (jt == 32) return (int)launch<32>(p, nd, smem_bytes, (cudaStream_t)stream);
  if (jt == 16) return (int)launch<16>(p, nd, smem_bytes, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
