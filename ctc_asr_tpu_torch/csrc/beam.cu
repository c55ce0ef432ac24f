// CTC prefix beam search with optional char-LM shallow fusion.
//
// Replaces: ctc_asr_tpu/ops/beam_pallas.py, _beam_kernel (K8, launched by
// beam_search_decode_pallas). It computes what ops/beam.py specifies and
// what ops/beam.py of this package (the plain version) spells out step
// by step: per frame, K stay candidates (blank path + repeat-last-char
// path) and K*(C-1) extend candidates; a stay absorbs the one extend that
// spells the same prefix (pairwise rolling-hash test) by log-sum-exp; the
// best K survive, ranked by score, ties in the reference's order (the
// candidate's first hash ascending; then flat = beam * C + char, the stay
// in the blank column), where
// score = lse(p_b, p_nb) + lm_weight * lm + word_bonus * bonus and
// p_b / p_nb stay purely acoustic. NEG = -1e30 is the finite "zero
// probability"; a candidate below NEG/2 is dead, ranks at exactly NEG and
// never merges; a beam made from a dead or merged-away pick gets
// p_b = p_nb = NEG. Frames at t >= len leave the beam untouched.
//
// The TPU kernel's shape is Mosaic's, not the algorithm's: one-hot matmul
// gathers, f32-coded integers, a [C,C] prefix-count matmul, a 31-step
// threshold search and a (B/G, T) grid with the state in VMEM scratch.
// Here parents, table rows and characters are plain indexed reads.
//
// What bounds it on the H100: almost nothing in bytes (the [B,T,C]
// log-probs are read once, a few MB) or operations (K*C = 1856 candidates
// per frame and utterance). The cost is a chain of T dependent steps per
// utterance, each with a block-wide selection, so the time is T times
// the latency of one step: its block barriers and the dependent stages
// between them.
//
// What the design does about it, simple first:
// - One launch for the whole batch, one block per utterance (B=128 blocks
//   on 132 SMs), the loop over the utterance's own frames inside the
//   block; the beam state (K x 10 scalars, double-buffered) lives in
//   shared memory for the whole utterance.
// - Candidates rank by 64-bit keys (monotone score bits << 32 | ~hash)
//   that carry the flat index as a 16-bit value: the reference order with
//   no tie pass and no threshold search, so positive fused scores
//   (word_bonus) and -1e30 order like any other float.
// - Top-K is a selection, not a sort of all NP keys (select_top below):
//   each warp sorts a chunk of L = max(64, K rounded up to a power of two)
//   keys with no block barrier (shuffles in registers, __syncwarp), and a
//   tree of pairwise top-L merges, one level per block barrier, leaves the
//   K best in rank order. A step takes 4 + log2(NP / L) block barriers:
//   after the extend phase, after the stay phase, after the warp sorts,
//   one a merge level (the last one ahead of the pick) and after the pick;
//   9 at K = 64, C = 29 (NP = 2048: 32 chunks, 5 levels).
// - Prefixes are not copied: each step writes one (parent, char) record
//   per beam to a [B, T, K] scratch, and the emitted beams are rebuilt by
//   backtracking at the end. The emitted length clamps at U and
//   characters past U are dropped, as in the reference; U has no cap.
// - The LM table stays in global memory as f32 at any order (an order-5
//   table is 69 MB): K rows of C-1 floats are read per step, mostly from
//   L2.
// Score arithmetic uses __fadd_rn / __fmul_rn so that no multiply-add is
// contracted: the plain PyTorch version rounds after every operation,
// and near-ties between candidates would otherwise break differently.
// Compiled without fast math, so expf / logf are the accurate ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr float DEAD = -0.5e30f;
constexpr uint32_t H1_MUL = 1000003u, H1_ADD = 0x9E3779B9u, H1_SEED = 17u;
constexpr uint32_t H2_MUL = 69069u, H2_ADD = 0x85EBCA6Bu, H2_SEED = 29u;

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  return __fadd_rn(m, logf(__fadd_rn(expf(__fadd_rn(a, -m)),
                                     expf(__fadd_rn(b, -m)))));
}

// (acoustic + lm_weight * lm) + word_bonus * bonus, rounded at each step.
__device__ __forceinline__ float fuse(float acoustic, float lm, float bonus,
                                      float lm_weight, float word_bonus) {
  return __fadd_rn(__fadd_rn(acoustic, __fmul_rn(lm_weight, lm)),
                   __fmul_rn(word_bonus, bonus));
}

// Sort key: larger score first, then smaller hash. The float maps to an
// unsigned int that is monotone over negatives, positives and -1e30; -0
// is folded into +0 first, as the two compare equal.
__device__ __forceinline__ unsigned long long make_key(float score,
                                                       uint32_t h1) {
  if (score == 0.0f) score = 0.0f;
  const uint32_t bits = __float_as_uint(score);
  const uint32_t mono = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)mono << 32) | (0xFFFFFFFFu - h1);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t mono = (uint32_t)(key >> 32);
  const uint32_t bits = (mono & 0x80000000u) ? (mono & 0x7FFFFFFFu) : ~mono;
  return __uint_as_float(bits);
}

struct BeamState {      // one of two buffers, each array [K]
  float* pb;
  float* pnb;
  float* total;         // lse2(pb, pnb)
  float* lm;
  float* bon;
  int* last;
  int* ctx;
  int* flen;            // unclamped prefix length
  uint32_t* h1;
  uint32_t* h2;
};

__device__ __forceinline__ BeamState state_at(unsigned char* base, int K) {
  BeamState s;
  float* f = reinterpret_cast<float*>(base);
  s.pb = f;
  s.pnb = f + K;
  s.total = f + 2 * K;
  s.lm = f + 3 * K;
  s.bon = f + 4 * K;
  s.last = reinterpret_cast<int*>(f + 5 * K);
  s.ctx = reinterpret_cast<int*>(f + 6 * K);
  s.flen = reinterpret_cast<int*>(f + 7 * K);
  s.h1 = reinterpret_cast<uint32_t*>(f + 8 * K);
  s.h2 = reinterpret_cast<uint32_t*>(f + 9 * K);
  return s;
}

constexpr int STATE_ARRAYS = 10;

// ---- top-K selection ---------------------------------------------------
//
// The K best of keys/vals[0..NP) in the total order (key descending, then
// flat index ascending; no two slots share a flat index) come to
// keys/vals[0..K) in rank order. NP is cut into chunks of L = max(64,
// next power of two >= K) slots. Each warp sorts its chunks by itself
// (bitonic: the strides below 64 in registers, two slots a lane, by
// shuffles; longer strides in shared memory, __syncwarp between stages).
// Then a tree of pairwise merges: at each level a warp takes its list a
// and its partner's b, keeps max(a[i], b[L-1-i]) (the L best of both, a
// bitonic sequence) and sorts that with log2 L half-cleaner stages. One
// block barrier after the sorts and one after each of the log2(NP/L)
// levels, the last of which the pick reads.

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int TILE = 64;   // a warp's register tile: slot e*32 + lane, e < 2

// a ranks before b
__device__ __forceinline__ bool ranks_before(unsigned long long ka,
                                             unsigned va,
                                             unsigned long long kb,
                                             unsigned vb) {
  return ka > kb || (ka == kb && va < vb);
}

struct Tile {
  unsigned long long k[2];
  unsigned v[2];
};

__device__ __forceinline__ Tile load_tile(const unsigned long long* keys,
                                          const unsigned short* vals,
                                          int lane) {
  Tile t;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    t.k[e] = keys[e * 32 + lane];
    t.v[e] = vals[e * 32 + lane];
  }
  return t;
}

__device__ __forceinline__ void store_tile(unsigned long long* keys,
                                           unsigned short* vals,
                                           const Tile& t, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    keys[e * 32 + lane] = t.k[e];
    vals[e * 32 + lane] = (unsigned short)t.v[e];
  }
}

// The bitonic stages of strides jmax..1 (jmax <= 32) on a tile held in
// registers, within the merge of runs of `run` slots: the slot at
// position i (pos0 = the tile's first) sorts descending where
// (i & run) == 0, ascending elsewhere.
__device__ __forceinline__ void tile_stages(Tile& t, int pos0, int run,
                                            int jmax, int lane) {
  for (int j = jmax; j > 0; j >>= 1) {
    if (j == 32) {      // slots e = 0 and 1 of one lane
      const bool desc = ((pos0 + lane) & run) == 0;
      if (ranks_before(t.k[1], t.v[1], t.k[0], t.v[0]) == desc) {
        const unsigned long long k = t.k[0];
        const unsigned v = t.v[0];
        t.k[0] = t.k[1];
        t.v[0] = t.v[1];
        t.k[1] = k;
        t.v[1] = v;
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = pos0 + e * 32 + lane;
      const unsigned long long pk = __shfl_xor_sync(FULL_MASK, t.k[e], j);
      const unsigned pv = __shfl_xor_sync(FULL_MASK, t.v[e], j);
      // the lower slot of a descending pair keeps the one ranked first
      const bool keep_first = ((i & j) == 0) == ((i & run) == 0);
      if (ranks_before(pk, pv, t.k[e], t.v[e]) == keep_first) {
        t.k[e] = pk;
        t.v[e] = pv;
      }
    }
  }
}

// One bitonic stage of stride j >= 64 over n slots in shared memory, by
// one warp.
__device__ __forceinline__ void smem_stage(unsigned long long* keys,
                                           unsigned short* vals, int n,
                                           int run, int j, int lane) {
  for (int p = lane; p < n / 2; p += 32) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int q = i + j;
    const unsigned long long a = keys[i], b = keys[q];
    const unsigned short va = vals[i], vb = vals[q];
    if (ranks_before(b, vb, a, va) == ((i & run) == 0)) {
      keys[i] = b;
      keys[q] = a;
      vals[i] = vb;
      vals[q] = va;
    }
  }
  __syncwarp();
}

// Sort the L slots at keys/vals descending, by one warp.
__device__ void warp_sort(unsigned long long* keys, unsigned short* vals,
                          int L, int lane) {
  for (int base = 0; base < L; base += TILE) {
    Tile t = load_tile(keys + base, vals + base, lane);
#pragma unroll
    for (int run = 2; run <= TILE; run <<= 1)
      tile_stages(t, base, run, run >> 1, lane);
    store_tile(keys + base, vals + base, t, lane);
  }
  __syncwarp();
  for (int run = 2 * TILE; run <= L; run <<= 1) {
    for (int j = run >> 1; j >= TILE; j >>= 1)
      smem_stage(keys, vals, L, run, j, lane);
    for (int base = 0; base < L; base += TILE) {
      Tile t = load_tile(keys + base, vals + base, lane);
      tile_stages(t, base, run, 32, lane);
      store_tile(keys + base, vals + base, t, lane);
    }
    __syncwarp();
  }
}

// The L best of two descending lists of L, a (overwritten) and b, sorted
// descending into a, by one warp.
__device__ void warp_merge(unsigned long long* ak, unsigned short* av,
                           const unsigned long long* bk,
                           const unsigned short* bv, int L, int lane) {
  for (int i = lane; i < L; i += 32) {
    const unsigned long long kb = bk[L - 1 - i];
    const unsigned short vb = bv[L - 1 - i];
    if (ranks_before(kb, vb, ak[i], av[i])) {
      ak[i] = kb;
      av[i] = vb;
    }
  }
  __syncwarp();
  for (int j = L >> 1; j >= TILE; j >>= 1)
    smem_stage(ak, av, L, L, j, lane);
  for (int base = 0; base < L; base += TILE) {
    Tile t = load_tile(ak + base, av + base, lane);
    tile_stages(t, base, L, 32, lane);
    store_tile(ak + base, av + base, t, lane);
  }
}

// Chunk length of the selection for a beam of K.
__device__ __forceinline__ int select_chunk(int K) {
  int L = TILE;
  while (L < K) L <<= 1;
  return L;
}

// The selection described above, by the whole block (NP / L chunks;
// blockDim.x a multiple of 32). Ends with a block barrier.
__device__ void select_top(unsigned long long* keys, unsigned short* vals,
                           int NP, int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int chunks = NP / L;
  for (int c = warp; c < chunks; c += nwarps)
    warp_sort(keys + (size_t)c * L, vals + (size_t)c * L, L, lane);
  __syncthreads();
  for (int s = 1; s < chunks; s <<= 1) {
    for (int a = 2 * s * warp; a < chunks; a += 2 * s * nwarps)
      warp_merge(keys + (size_t)a * L, vals + (size_t)a * L,
                 keys + (size_t)(a + s) * L, vals + (size_t)(a + s) * L, L,
                 lane);
    __syncthreads();
  }
}

// At most 1024 threads (NP / 2): 64 registers a thread.
__global__ void __launch_bounds__(1024) beam_search_kernel(
    const float* __restrict__ log_probs,   // [B, T, C]
    const int* __restrict__ lens,          // [B]
    const float* __restrict__ table,       // [n_ctx, C-1] or null
    int* __restrict__ back,                // [B, T, K] scratch
    int* __restrict__ out_ids,             // [B, kout, U], filled with pad
    int* __restrict__ out_lens,            // [B, kout]
    float* __restrict__ out_scores,        // [B, kout]
    int T, int C, int K, int U, int NP, int n_ctx, int lm_vocab, int space,
    int init_ctx, float lm_weight, float word_bonus, int nbest) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int Cr = C - 1;
  const int N = K * C;
  const int blank = C - 1;
  const int L = select_chunk(K);

  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned short* vals = reinterpret_cast<unsigned short*>(
      smem + (size_t)NP * sizeof(unsigned long long));
  unsigned char* p = smem + (size_t)NP * (sizeof(unsigned long long) +
                                          sizeof(unsigned short));
  BeamState st[2];
  st[0] = state_at(p, K);
  st[1] = state_at(p + (size_t)STATE_ARRAYS * K * sizeof(float), K);
  float* f = reinterpret_cast<float*>(
      p + (size_t)2 * STATE_ARRAYS * K * sizeof(float));
  float* stay_pb = f;                // [K]
  float* stay_pnb = f + K;           // [K] after the merge
  float* lp_buf = f + 2 * K;         // [2][C]
  __shared__ int best_beam;

  const int len = min(max(lens[b], 0), T);
  const float* lp_rows = log_probs + (size_t)b * T * C;
  int* back_rows = back + (size_t)b * T * K;

  if (tid < K) {
    BeamState& s = st[0];
    s.pb[tid] = tid == 0 ? 0.0f : NEG;
    s.pnb[tid] = NEG;
    s.total[tid] = lse2(s.pb[tid], NEG);
    s.lm[tid] = 0.0f;
    s.bon[tid] = 0.0f;
    s.last[tid] = -1;
    s.ctx[tid] = init_ctx;
    s.flen[tid] = 0;
    s.h1[tid] = H1_SEED;
    s.h2[tid] = H2_SEED;
  }
  if (len > 0)
    for (int c = tid; c < C; c += nt) lp_buf[c] = lp_rows[c];
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < len; ++t) {
    const BeamState& s = st[cur];
    const BeamState& n = st[cur ^ 1];
    const float* lp = lp_buf + (t & 1) * C;

    // ---- extend candidates: keys[k*C + c], c < C-1 --------------------
    for (int flat = tid; flat < NP; flat += nt) {
      unsigned long long key = 0ull;        // padding sorts last
      const int k = flat / C, c = flat - k * C;
      if (flat < N) {
        if (c == blank) continue;           // the stay's slot, written below
        const float v = __fadd_rn(c == s.last[k] ? s.pb[k] : s.total[k],
                                  lp[c]);
        float score = NEG;
        if (v > DEAD) {
          float lmv = s.lm[k];
          if (table != nullptr)
            lmv = __fadd_rn(lmv, table[(size_t)s.ctx[k] * Cr + c]);
          const float bonv = __fadd_rn(s.bon[k], c == space ? 1.0f : 0.0f);
          score = fuse(v, lmv, bonv, lm_weight, word_bonus);
        }
        key = make_key(score, s.h1[k] * H1_MUL + ((uint32_t)c + H1_ADD));
      }
      keys[flat] = key;
      vals[flat] = (unsigned short)flat;
    }
    __syncthreads();

    // ---- stay candidates, each absorbing the extend it duplicates -----
    if (tid < K) {
      const int k = tid;
      const int c = s.last[k];
      const float spb = __fadd_rn(s.total[k], lp[blank]);
      float spnb = c >= 0 ? __fadd_rn(s.pnb[k], lp[c]) : NEG;
      const bool live = spb > DEAD || spnb > DEAD;
      if (live && c >= 0) {
        const uint32_t want1 = s.h1[k], want2 = s.h2[k];
        for (int j = 0; j < K; ++j) {
          if (s.h1[j] * H1_MUL + ((uint32_t)c + H1_ADD) != want1 ||
              s.h2[j] * H2_MUL + ((uint32_t)c + H2_ADD) != want2)
            continue;
          const float v = __fadd_rn(c == s.last[j] ? s.pb[j] : s.total[j],
                                    lp[c]);
          if (v > DEAD) {
            spnb = lse2(spnb, v);
            keys[j * C + c] = make_key(NEG, want1);
          }
        }
      }
      stay_pb[k] = spb;
      stay_pnb[k] = spnb;
      const float score = live ? fuse(lse2(spb, spnb), s.lm[k], s.bon[k],
                                      lm_weight, word_bonus)
                               : NEG;
      keys[k * C + blank] = make_key(score, s.h1[k]);
      vals[k * C + blank] = (unsigned short)(k * C + blank);
    }
    __syncthreads();

    select_top(keys, vals, NP, L);

    // ---- the K best become the new beam, in rank order -----------------
    if (tid < K) {
      const int i = tid;
      const int flat = vals[i];
      const bool dead = key_score(keys[i]) <= DEAD;
      const int par = flat / C;
      int c = flat - par * C;
      if (c == blank) {
        c = -1;
        n.pb[i] = dead ? NEG : stay_pb[par];
        n.pnb[i] = dead ? NEG : stay_pnb[par];
        n.last[i] = s.last[par];
        n.h1[i] = s.h1[par];
        n.h2[i] = s.h2[par];
        n.ctx[i] = s.ctx[par];
        n.lm[i] = s.lm[par];
        n.bon[i] = s.bon[par];
        n.flen[i] = s.flen[par];
      } else {
        n.pb[i] = NEG;
        n.pnb[i] = dead ? NEG
                        : __fadd_rn(c == s.last[par] ? s.pb[par]
                                                     : s.total[par], lp[c]);
        n.last[i] = c;
        n.h1[i] = s.h1[par] * H1_MUL + ((uint32_t)c + H1_ADD);
        n.h2[i] = s.h2[par] * H2_MUL + ((uint32_t)c + H2_ADD);
        float lmv = s.lm[par];
        int ctx = s.ctx[par];
        if (table != nullptr) {
          lmv = __fadd_rn(lmv, table[(size_t)ctx * Cr + c]);
          ctx = (int)(((long long)ctx * lm_vocab + c) % n_ctx);
        }
        n.ctx[i] = ctx;
        n.lm[i] = lmv;
        n.bon[i] = __fadd_rn(s.bon[par], c == space ? 1.0f : 0.0f);
        n.flen[i] = s.flen[par] + 1;
      }
      n.total[i] = lse2(n.pb[i], n.pnb[i]);
      back_rows[(size_t)t * K + i] = (par << 8) | (c + 1);
    }
    if (t + 1 < len) {
      // The next frame's log-probs, highest threads first: with more
      // threads than K + C they all fall to threads that pick no beam
      // and are fetched meanwhile; with fewer (nt == K when C == 2) the
      // picking threads fetch them after their pick.
      for (int c = nt - 1 - tid; c < C; c += nt)
        lp_buf[((t + 1) & 1) * C + c] = lp_rows[(size_t)(t + 1) * C + c];
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- emit: the best beam, or the whole beam in beam order ------------
  const BeamState& s = st[cur];
  if (tid < K)
    stay_pb[tid] = fuse(s.total[tid], s.lm[tid], s.bon[tid], lm_weight,
                        word_bonus);
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int k = 1; k < K; ++k)
      if (stay_pb[k] > stay_pb[best]) best = k;     // first maximum
    best_beam = best;
  }
  __syncthreads();
  const int kout = nbest ? K : 1;
  if (tid < kout) {
    int j = nbest ? tid : best_beam;
    const int full = s.flen[j];
    const size_t o = (size_t)b * kout + tid;
    out_lens[o] = min(full, U);
    out_scores[o] = stay_pb[j];
    int* ids = out_ids + o * U;
    int pos = full;
    for (int t = len - 1; t >= 0; --t) {
      const int rec = back_rows[(size_t)t * K + j];
      const int c = (rec & 0xFF) - 1;
      if (c >= 0) {
        --pos;
        if (pos < U) ids[pos] = c;
      }
      j = rec >> 8;
    }
  }
}

// The selection alone, for its tests and its timing: one block ranks
// the N candidates make_key(scores[i], h1[i]), flat index i, padded to NP
// with key 0, and writes the K best in rank order. It fills the keys and
// selects `reps` times over (fills only where `select` is 0), so that the
// difference of two rep counts times one fill and selection without the
// launch.
__global__ void __launch_bounds__(1024) select_probe_kernel(
    const float* __restrict__ scores, const uint32_t* __restrict__ h1, int N,
    int K, int NP, int reps, int select,
    unsigned long long* __restrict__ out_keys, int* __restrict__ out_flat) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned short* vals = reinterpret_cast<unsigned short*>(
      smem + (size_t)NP * sizeof(unsigned long long));
  for (int r = 0; r < reps; ++r) {
    for (int flat = threadIdx.x; flat < NP; flat += blockDim.x) {
      keys[flat] = flat < N ? make_key(scores[flat], h1[flat]) : 0ull;
      vals[flat] = (unsigned short)flat;
    }
    __syncthreads();
    if (select) select_top(keys, vals, NP, select_chunk(K));
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    out_keys[i] = keys[i];
    out_flat[i] = vals[i];
  }
}

// A block's threads: one per pair of sort slots, at most 1024 (NP >= 64).
int block_threads(int NP) { return NP / 2 < 1024 ? NP / 2 : 1024; }

}  // namespace

// Shared memory of one block: the sort keys and values, two state
// buffers, the stay arrays and two frames of log-probs.
static size_t beam_smem_bytes(int K, int C, int NP) {
  return (size_t)NP * (sizeof(unsigned long long) + sizeof(unsigned short)) +
         (size_t)(2 * STATE_ARRAYS + 2) * K * sizeof(float) +
         (size_t)2 * C * sizeof(float);
}

extern "C" int beam_search(const void* log_probs, const void* lens,
                           const void* table, void* back, void* out_ids,
                           void* out_lens, void* out_scores, int B, int T,
                           int C, int K, int U, int NP, int n_ctx,
                           int lm_vocab, int space, int init_ctx,
                           float lm_weight, float word_bonus, int nbest,
                           void* stream) {
  const size_t smem = beam_smem_bytes(K, C, NP);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  beam_search_kernel<<<B, block_threads(NP), smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)lens, (const float*)table,
      (int*)back, (int*)out_ids, (int*)out_lens, (float*)out_scores, T, C, K,
      U, NP, n_ctx, lm_vocab, space, init_ctx, lm_weight, word_bonus, nbest);
  return (int)cudaGetLastError();
}

// select_probe_kernel on one block; N <= NP, K <= NP, NP a power of two
// in 64..16384, reps >= 1. Returns cudaError_t.
extern "C" int beam_select_probe(const void* scores, const void* h1, int N,
                                 int K, int NP, int reps, int select,
                                 void* out_keys, void* out_flat,
                                 void* stream) {
  const size_t smem =
      (size_t)NP * (sizeof(unsigned long long) + sizeof(unsigned short));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  select_probe_kernel<<<1, block_threads(NP), smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const uint32_t*)h1, N, K, NP, reps, select,
      (unsigned long long*)out_keys, (int*)out_flat);
  return (int)cudaGetLastError();
}
