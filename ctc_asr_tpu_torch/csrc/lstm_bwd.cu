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
// GFLOP a step, under a microsecond of tensor-core work) plus the cell;
// step t needs every block's dgates of step t+1. The cost of a step is
// latency, and it follows the chunks of dgates_{t+1} a block waits for in
// series: a block reads its rows' slab [rows, K] back from L2 through a
// ring of 3 stages, so it waits for one TMA round trip every 3 chunks.
// With 16 KB chunks a step costs about 0.64 us a chunk plus 2 us (the
// step barrier alone 1-1.2 us; the cluster barrier adds ~0.7 us). At
// B=64, H=800 a lone block streaming all of K = 4H waits for 25 chunks a
// step; a block of a cluster of two, 13.
//
// What the design does about it (lstm_bwd_persistent_kernel): ONE
// cooperative launch runs all T steps in reverse time, the mirror of
// lstm_fwd.cu.
// - A block owns JT hidden units of one direction for BT batch rows. Its
//   resident slice is the wh rows of its units, wh[d][j0 .. +JT, :]
//   (JT x 4H bf16), copied to shared memory once: the K-major operand B
//   of dgates_{t+1} @ wh^T.
// - dgates_{t+1} [rows, 4H] is what all blocks of the (direction, row
//   block) group wrote to dxproj[t+1] in the step before. After the
//   group's barrier (recurrence.cuh) one producer thread reads it back by
//   TMA (L2, never a stale L1 line) in chunks through a ring of stages
//   that a "full" and an "empty" mbarrier per stage hand to the two
//   consumer warpgroups and back. dxproj is written once per element, so
//   there is no buffer to overwrite and one barrier a step suffices.
// - Where the plan gives clusters of two blocks (CL = 2), the pair owns
//   the same units and rows and splits K = 4H: rank 0 holds the wh rows'
//   columns [0, 2H) (gates i, f), rank 1 [2H, 4H) (g, o), and each streams
//   only its half of the slab: half the chunks a step, half the L2 reads.
//   Each forms the partial product of all the pass's 64 rows over its half
//   of K and owns half of the rows for the cell: it writes the partner's
//   rows of its partial tile into the partner's shared memory
//   (st.shared::cluster), and after one cluster barrier adds its own and
//   the received partial (f32 addition is commutative, so both ranks form
//   rank 0's half + rank 1's half bit for bit; no atomics). With half of
//   K resident, 32 units a block fit at H = 800 where 16 fit unclustered,
//   so the pairs take as many blocks as the lone blocks did.
// - The product is wgmma (sm_90a) with the slab as the 64-row operand A.
//   Unclustered, the output tile of JT = 32 is only [32 rows x 32 units],
//   and a wgmma costs ~80 cycles however small it is, so the two halves of
//   K are stacked as rows of both operands and one m64n64k16 forms both
//   halves' partial products (recurrence.cuh). Otherwise (JT = 16, or
//   clustered) m64nJTk16 on passes of 64 rows, the warpgroups on alternate
//   k-steps. The cell adds the partial tiles in a fixed order.
// - dh and dc of the block's (row, unit) pairs live in shared memory for
//   all T; db is summed in registers over all T and rows and written once
//   per block into db_part[row block, rank, d, :] (no atomics, the same
//   order every run).
// - gates[t-1], c_seq[t-1], c_seq[t-2] and g_out[t-1] for the block's
//   rows are fetched while the block waits at the barrier.
// - tanh(c_t) uses the special-function exp (error ~1e-7, dgates are
//   rounded to bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrence.cuh"

// Internal linkage: lstm_fwd.cu and lstm_bwd.cu each have their own Params,
// Layout and launch under these names.
namespace {
namespace persistent {

namespace rc = recurrence;
typedef __nv_bfloat16 bf16;


struct Params {
  const bf16* g_out;    // [nd,T,B,H]
  const bf16* gates;    // [nd,T,B,4H]
  const bf16* c_seq;    // [nd,T,B,H]
  const bf16* wh;       // [nd,H,4H]
  const int* start;     // [nd,B]
  const int* end;       // [nd,B]
  bf16* dxproj;         // [nd,T,B,4H], written and read back across blocks
  float* db_part;       // [row blocks, nd, 4H], every element written
  unsigned* sync;       // [nd, row blocks] barrier counters, zeroed
  int T, B, H, BT;
};

// The product of a pass: D[rows, JT units] = dg[rows, K] x Wr[JT, K]^T,
// the slab as the 64-row wgmma operand A, the resident slice as operand B,
// K = 4H, or the block's half of it in a cluster of two (CL = 2). A wgmma
// costs ~80 cycles of the SM's tensor cores however small N is, so the
// tile is shaped to need few of them. JT = 32 unclustered (passes of 32
// rows): the two halves of K are stacked as rows of both operands
// (recurrence.cuh, load_unit_rows_stacked), so one m64n64k16 of warpgroup
// 0 forms both halves' partial products and a step needs 4H/32 of them.
// Otherwise (passes of 64 rows): m64nJTk16, the two warpgroups take the
// even and the odd k-steps. The cell adds the partial tiles. In a cluster
// each block runs the cell for CR = 32 rows of a 64-row pass (rank r the
// rows [32r, 32r + 32)), and keeps the state of those rows alone.
template <int JT, int CL>
struct Layout {
  static constexpr bool STACKED = JT == 32 && CL == 1;
  static constexpr int PR = STACKED ? 32 : 64;     // rows of a pass
  static constexpr int CR = PR / CL;               // ... of its cell here
  static constexpr int TR = 64;                    // rows of a ring tile
  static constexpr int KC = STACKED ? 256 : 128;   // K chunk of a tile row
  static constexpr int STAGES = STACKED ? 2 : 3;   // ring stages
  static constexpr int LDC = JT + 4;               // f32
  int SR;                                          // rows of state
  size_t wr, ring, cs, xs, dh, dc, gt, ct, cp, go, se, bars, total;
  __host__ __device__ Layout(int H, int BT) {
    const int passes = (BT + PR - 1) / PR;
    SR = CL == 1 ? BT : passes * CR;
    // the partner's partial tiles: two buffers, used by alternate passes
    const int xbufs = CL == 1 ? 0 : (passes < 2 ? passes : 2);
    size_t o = 0;
    // STACKED: 64 stacked rows of K/2 = 2H, in whole atoms of 64 k (a
    // partial last atom still spans 64 rows x 128 bytes); otherwise JT
    // rows of the block's 4H / CL columns, in whole atoms
    wr = o;   o += rc::align1024(
        STACKED ? (size_t)64 * ((2 * H + 63) / 64 * 64) * sizeof(bf16)
                : (size_t)JT * ((4 * H / CL + 63) / 64 * 64) * sizeof(bf16));
    ring = o; o += rc::align1024((size_t)STAGES * KC * TR * sizeof(bf16));
    cs = o;   o += rc::align128((size_t)2 * PR * LDC * sizeof(float));
    xs = o;   o += rc::align128((size_t)xbufs * CR * LDC * sizeof(float));
    dh = o;   o += rc::align128((size_t)SR * JT * sizeof(float));
    dc = o;   o += rc::align128((size_t)SR * JT * sizeof(float));
    gt = o;   o += rc::align128((size_t)SR * 4 * JT * sizeof(bf16));
    ct = o;   o += rc::align128((size_t)SR * JT * sizeof(bf16));
    cp = o;   o += rc::align128((size_t)SR * JT * sizeof(bf16));
    go = o;   o += rc::align128((size_t)SR * JT * sizeof(bf16));
    se = o;   o += rc::align128((size_t)2 * SR * sizeof(int));
    bars = o; o += rc::align128((size_t)2 * STAGES * sizeof(long long));
    total = o;
  }
};

// m64nJTk16 of the unstacked product
template <int JT>
__device__ __forceinline__ void wgmma_tile(float (&acc)[JT / 2],
                                           unsigned long long a,
                                           unsigned long long b,
                                           int accumulate) {
  if constexpr (JT == 32)
    rc::wgmma_m64n32k16(acc, a, b, accumulate);
  else
    rc::wgmma_m64n16k16(acc, a, b, accumulate);
}

// exp on the special-function unit, as in the forward kernel
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

template <int JT, int CL>
__global__ void __launch_bounds__(rc::THREADS, 1)
lstm_bwd_persistent_kernel(const Params p,
                           const __grid_constant__ CUtensorMap dmap) {
  typedef Layout<JT, CL> L;
  constexpr bool STACKED = L::STACKED;    // K halves stacked as rows
  constexpr int PR = L::PR;
  constexpr int CR = L::CR;
  constexpr int STAGES = L::STAGES;
  constexpr int KC = L::KC;
  constexpr int LDC = L::LDC;
  constexpr int CONSUMERS = rc::CONSUMERS;
  constexpr int RSTEP = CONSUMERS / JT;   // row stride of a thread's pairs
  constexpr int RPT = CR / RSTEP;         // (row, unit) pairs per thread
  constexpr int PPG = JT / 8;             // 16-byte pieces per [.., JT] row
  constexpr int TR = L::TR;
  constexpr int STAGE = KC * TR;          // bf16 elements of a ring stage
  static_assert(RPT * RSTEP == CR, "the cell covers a pass's rows");
  static_assert((size_t)RSTEP * 4 * JT <= (size_t)2 * PR * LDC,
                "the db reduction aliases Cs");

  extern __shared__ __align__(1024) unsigned char smem[];
  const int T = p.T, B = p.B, H = p.H, BT = p.BT, G = 4 * p.H;
  const L lay(H, BT);
  const int SR = lay.SR;
  bf16* Wr = reinterpret_cast<bf16*>(smem + lay.wr);       // atoms [JT][64]
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);   // [STAGES] atoms [PR][64]
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);     // [2][PR][LDC]
  float* Xs = reinterpret_cast<float*>(smem + lay.xs);     // [2][CR][LDC]
  float* dh_s = reinterpret_cast<float*>(smem + lay.dh);   // [SR][JT]
  float* dc_s = reinterpret_cast<float*>(smem + lay.dc);   // [SR][JT]
  bf16* gt_s = reinterpret_cast<bf16*>(smem + lay.gt);     // [SR][4*JT]
  bf16* ct_s = reinterpret_cast<bf16*>(smem + lay.ct);     // [SR][JT] c_t
  bf16* cp_s = reinterpret_cast<bf16*>(smem + lay.cp);     // [SR][JT] c_{t-1}
  bf16* go_s = reinterpret_cast<bf16*>(smem + lay.go);     // [SR][JT]
  int* st_s = reinterpret_cast<int*>(smem + lay.se);       // [SR]
  int* en_s = st_s + SR;                                   // [SR]
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
  const int rank = CL > 1 ? (int)rc::cluster_ctarank() : 0;
  const int j0 = blockIdx.x / CL * JT;
  const int b0 = blockIdx.y * BT;
  const int rows = min(BT, B - b0);           // > 0: the grid covers B
  const int npass = (rows + PR - 1) / PR;
  // columns of K a tile row spans, from column kbase of dxproj and wh
  const int kw = STACKED ? G / 2 : G / CL;
  const int kbase = STACKED ? 0 : rank * kw;
  const int nkc = (kw + KC - 1) / KC;
  const int u = tid % JT;
  const int r = tid / JT;
  const int j = j0 + u;
  unsigned* counter = p.sync + d * gridDim.y + blockIdx.y;
  const unsigned group = gridDim.x;           // blocks that share the rows
  const unsigned long long desc_b = rc::smem_desc(Wr);
  // the cell's rows: state row sr is row (sr % CR) of this block's share
  // of pass sr / CR, and the block's row returned here
  auto block_row = [&](int sr) {
    return sr / CR * PR + rank * CR + sr % CR;
  };

  // the block's tiles of gates[t], c_seq[t], c_seq[t-1] and g_out[t]
  // (consumers)
  auto fetch_inputs = [&](int t) {
    const size_t base = ((size_t)d * T + t) * B + b0;
    for (int e = tid; e < SR * 7 * PPG; e += CONSUMERS) {
      const int rr = e / (7 * PPG), a = (e % (7 * PPG)) / PPG, q = e % PPG;
      const int jj = j0 + q * 8;
      const int br = block_row(rr);
      if (jj >= H || br >= rows) continue;
      const size_t row = base + br;
      if (a < 4)
        rc::cp_async16(gt_s + rr * 4 * JT + a * JT + q * 8,
                       p.gates + row * G + a * H + jj);
      else if (a == 4)
        rc::cp_async16(ct_s + rr * JT + q * 8, p.c_seq + row * H + jj);
      else if (a == 5) {
        if (t > 0)
          rc::cp_async16(cp_s + rr * JT + q * 8,
                         p.c_seq + (row - B) * H + jj);
      } else
        rc::cp_async16(go_s + rr * JT + q * 8, p.g_out + row * H + jj);
    }
  };

  // once: the resident slice, the windows, zero state, step T-1's inputs,
  // the mbarriers of the ring
  if constexpr (STACKED)
    rc::load_unit_rows_stacked(Wr, p.wh + (size_t)d * H * G, H, G, G / 2,
                                  j0);
  else
    rc::load_unit_rows<JT>(Wr, p.wh + (size_t)d * H * G + kbase, H, G, j0,
                           kw);
  if (!producer) fetch_inputs(T - 1);
  rc::cp_async_commit();
  for (int e = tid; e < SR * JT; e += rc::THREADS) {
    dh_s[e] = 0.f;
    dc_s[e] = 0.f;
  }
  for (int e = tid; e < SR; e += rc::THREADS) {
    const int br = block_row(e);
    st_s[e] = br < rows ? p.start[d * B + b0 + br] : 0;
    en_s[e] = br < rows ? p.end[d * B + b0 + br] : 0;
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
  // the partner block runs before its shared memory is written
  if constexpr (CL > 1) rc::cluster_sync();
  // where this block's partial tiles go in the partner's shared memory
  const unsigned xs_other =
      CL > 1 ? rc::map_shared_rank(Xs, (unsigned)(rank ^ 1)) : 0u;

  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};
  // Chunks handed over so far, counted alike by producers and consumers:
  // chunk g goes through stage g % STAGES, and is the (g / STAGES)-th use
  // of that stage, which gives the parity its mbarriers are waited with.
  int g_chunk = 0;
  // The block's first row of dgates_{t+1} in dxproj seen as a matrix
  // [nd * T * B, 4H], written by the group before the last barrier: no
  // ping-pong here, each step reads its own row block of dxproj. Carried
  // from step to step, as the exchange rows of the other kernels are.
  int drow = (d * T + T) * B + b0;

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const bool has_next = s > 0;

    if (producer) {
      // the slab of dgates_{t+1}, chunk after chunk, as far ahead of the
      // products as the ring has free stages: one thread, one TMA
      // instruction per box of [32 or 64 rows, 64 k]; in a cluster the
      // whole warp meets the partner at the barrier of every pass
      if (has_next) {
        if (tid == CONSUMERS)
          rc::fence_proxy_async_global();   // after the barrier's acquire
        for (int pass = 0; pass < npass; ++pass) {
          for (int kc = 0; tid == CONSUMERS && kc < nkc; ++kc, ++g_chunk) {
            const int st = g_chunk % STAGES, use = g_chunk / STAGES;
            const int k0 = kbase + kc * KC;
            const int natoms = (min(KC, kw - kc * KC) + 63) / 64;
            rc::mbar_wait(empty + st, (use & 1) ^ 1);
            rc::mbar_expect_tx(full + st, natoms * TR * 128);
            for (int a = 0; a < natoms; ++a) {
              bf16* atom = ring + st * STAGE + a * TR * 64;
              if constexpr (STACKED) {
                // tile rows 0-31: the first half of K, rows 32-63: the
                // second
                rc::tma_load_box(atom, &dmap, k0 + 64 * a, drow + pass * PR,
                                 full + st);
                rc::tma_load_box(atom + 32 * 64, &dmap, G / 2 + k0 + 64 * a,
                                 drow + pass * PR, full + st);
              } else {
                rc::tma_load_box(atom, &dmap, k0 + 64 * a, drow + pass * PR,
                                 full + st);
              }
            }
          }
          if constexpr (CL > 1) rc::cluster_sync();
        }
      }
    } else {
      for (int pass = 0; pass < npass; ++pass) {
        // the partner's partial tile of this pass
        const float* xs = Xs + (pass & 1) * CR * LDC;
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
                wgmma_tile<JT>(
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
          if constexpr (CL > 1) {
            // this block's partial (its two warpgroups' tiles summed) of
            // the partner's rows goes to the partner
            rc::consumer_sync();
            constexpr int Q = JT / 4;               // float4 a row
            const int other = rank ^ 1;
            for (int e = tid; e < CR * Q; e += CONSUMERS) {
              const int i = e / Q, q = e % Q;
              const float4 x = *reinterpret_cast<const float4*>(
                  Cs + (other * CR + i) * LDC + 4 * q);
              const float4 y = *reinterpret_cast<const float4*>(
                  Cs + PR * LDC + (other * CR + i) * LDC + 4 * q);
              rc::st_cluster_v4(
                  xs_other + (unsigned)(((pass & 1) * CR * LDC + i * LDC
                                         + 4 * q) * sizeof(float)),
                  make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w));
            }
            rc::cluster_sync();   // both partials are in place
          }
        }
        rc::cp_async_wait<0>();   // this thread's share of step t's inputs
        rc::consumer_sync();

        if (j < H) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int ri = r + RSTEP * i;         // row of the cell's rows
            const int m = rank * CR + ri;         // row within the pass
            const int br = pass * PR + m;         // row within the block
            if (br >= rows) continue;
            const int sr = pass * CR + ri;        // row of the state
            const int bb = b0 + br;
            float dh_rec = 0.f;
            if (has_next) {
              dh_rec = Cs[m * LDC + u] + Cs[PR * LDC + m * LDC + u];
              if constexpr (CL > 1) dh_rec += xs[ri * LDC + u];
            }
            const float dh = dh_s[sr * JT + u] + dh_rec;
            const float dc = dc_s[sr * JT + u];
            const float mf = (t >= st_s[sr] && t < en_s[sr]) ? 1.f : 0.f;
            const bf16* gp = gt_s + sr * 4 * JT + u;
            const float gi = __bfloat162float(gp[0 * JT]);
            const float gf = __bfloat162float(gp[1 * JT]);
            const float gg = __bfloat162float(gp[2 * JT]);
            const float go = __bfloat162float(gp[3 * JT]);
            const float c_t = __bfloat162float(ct_s[sr * JT + u]);
            const float c_prev =
                t > 0 ? __bfloat162float(cp_s[sr * JT + u]) : 0.f;
            const float tanh_c = tanh_fast(c_t);

            const float dh_total =
                dh + mf * __bfloat162float(go_s[sr * JT + u]);
            const float dh_new = mf * dh_total;
            const float dh_prev_direct = (1.f - mf) * dh_total;
            const float d_o = dh_new * tanh_c;
            const float dc_from_h = dh_new * go * (1.f - tanh_c * tanh_c);
            const float dc_total = mf * dc + dc_from_h;
            const float dc_prev_direct = (1.f - mf) * dc;
            const float df = dc_total * c_prev;
            const float di = dc_total * gg;
            const float dg_ = dc_total * gi;
            const float dc_prev_from_new = dc_total * gf;

            const float dpre[4] = {di * gi * (1.f - gi),
                                   df * gf * (1.f - gf),
                                   dg_ * (1.f - gg * gg),
                                   d_o * go * (1.f - go)};
            bf16* dx = p.dxproj + (((size_t)d * T + t) * B + bb) * G;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              dx[g * H + j] = __float2bfloat16(dpre[g]);
              dbacc[g] += dpre[g];
            }
            dh_s[sr * JT + u] = dh_prev_direct;
            dc_s[sr * JT + u] = dc_prev_direct + dc_prev_from_new;
          }
        }
      }
    }

    if (t > 0) {
      // dgates_t was stored through the generic proxy and is read by TMA
      if (!producer) rc::fence_proxy_async_global();
      __syncthreads();        // every thread's dgates_t is written
      if (!producer) {
        fetch_inputs(t - 1);  // arrives while the block waits
        rc::cp_async_commit();
      }
      if (tid == 0) {
        rc::group_arrive(counter);
        rc::group_wait(counter, (unsigned)(s + 1) * group);
      }
      __syncthreads();
    }
    drow -= B;
  }

  // db: each thread's sums over all steps and its rows, then over the
  // threads of a unit in a fixed order; written once
  __syncthreads();
  float* red = Cs;                              // [RSTEP][4][JT]
  if (!producer) {
#pragma unroll
    for (int g = 0; g < 4; ++g) red[(r * 4 + g) * JT + u] = dbacc[g];
  }
  __syncthreads();
  if (tid < 4 * JT) {
    const int g = tid / JT, uu = tid % JT;
    if (j0 + uu < H) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < RSTEP; ++q) sum += red[(q * 4 + g) * JT + uu];
      p.db_part[(((size_t)blockIdx.y * CL + rank) * nd + d) * G + g * H
                + j0 + uu] = sum;
    }
  }
}

template <int JT, int CL>
cudaError_t launch(const Params& p, int nd, int smem_bytes,
                   cudaStream_t stream) {
  static bool ready[rc::MAX_DEVICES] = {};
  const Layout<JT, CL> lay(p.H, p.BT);
  if (lay.total != (size_t)smem_bytes) return cudaErrorInvalidValue;
  const dim3 grid((p.H + JT - 1) / JT * CL, (p.B + p.BT - 1) / p.BT, nd);
  Params q = p;
  // dxproj as a matrix [nd * T * B, 4H] for the slab's boxes
  CUtensorMap dmap;
  const cudaError_t err = rc::make_slab_map(
      &dmap, p.dxproj, (unsigned long long)nd * p.T * p.B, 4ull * p.H,
      Layout<JT, CL>::PR);
  if (err != cudaSuccess) return err;
  void* args[] = {&q, &dmap};
  return rc::launch_persistent(
      reinterpret_cast<const void*>(&lstm_bwd_persistent_kernel<JT, CL>),
      ready, grid, lay.total, args, stream, CL);
}

// The clusters of two blocks of the clustered kernel the card holds at
// once, each block with all the shared memory it may opt in to: one block
// an SM, as every plan runs it.
cudaError_t cluster_capacity(int* clusters) {
  static bool ready[rc::MAX_DEVICES] = {};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return rc::cluster_capacity(
      reinterpret_cast<const void*>(&lstm_bwd_persistent_kernel<32, 2>),
      ready, 2, (size_t)optin, clusters);
}

}  // namespace persistent
}  // namespace

// One layer's BPTT in ONE cooperative launch on `stream`, with the plan
// the host made (plan_recurrence, backward): JT units and BT rows a block,
// in clusters of `cluster` (1 or 2) blocks that split K, smem_bytes of
// dynamic shared memory (checked against the kernel's own layout). Needs
// H % 16 == 0, BT % 32 == 0, 16-byte aligned tensors. db_part is
// [ceil(B / BT) * cluster, nd, 4H] f32, uninitialized (every element is
// written); sync is [nd * ceil(B / BT)] uint32, zeroed by the caller.
// Returns cudaError_t; a grid that cannot be co-resident gives
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int lstm_bwd_persistent(const void* g_out, const void* gates,
                                   const void* c_seq, const void* wh,
                                   const void* start, const void* end,
                                   void* dxproj, void* db_part, void* sync,
                                   int nd, int T, int B, int H, int jt,
                                   int bt, int cluster, int smem_bytes,
                                   void* stream) {
  if (nd <= 0 || T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if (H % 16 != 0 || bt <= 0 || bt % 32 != 0 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  const persistent::Params p = {
      (const __nv_bfloat16*)g_out, (const __nv_bfloat16*)gates,
      (const __nv_bfloat16*)c_seq, (const __nv_bfloat16*)wh,
      (const int*)start, (const int*)end, (__nv_bfloat16*)dxproj,
      (float*)db_part, (unsigned*)sync, T, B, H, bt};
  const cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 1 && jt == 32)
    return (int)persistent::launch<32, 1>(p, nd, smem_bytes, s);
  if (cluster == 1 && jt == 16)
    return (int)persistent::launch<16, 1>(p, nd, smem_bytes, s);
  if (cluster == 2 && jt == 32)
    return (int)persistent::launch<32, 2>(p, nd, smem_bytes, s);
  if (cluster == 2 && jt == 16)
    return (int)persistent::launch<16, 2>(p, nd, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The number of clusters of two K3 blocks the current card holds at once
// (cudaOccupancyMaxActiveClusters at one block an SM), into *out (int).
extern "C" int lstm_bwd_cluster_capacity(void* out) {
  return (int)persistent::cluster_capacity((int*)out);
}
