// Shared pieces of the persistent recurrence kernels (lstm_fwd.cu,
// lstm_bwd.cu, gru_fwd.cu, gru_bwd.cu): one cooperative launch runs all T
// steps of a layer, each block keeps its slice of the recurrent weights
// in shared memory for the whole sequence, and the blocks that depend on
// each other meet at a barrier in global memory between steps.
//
// - cp.async helpers (16-byte copies for the block's own tiles). What
//   another block wrote during the kernel (the h ping-pong buffer, the
//   LSTM's dxproj, the GRU's dhproj ping-pong buffer) is read by TMA,
//   which goes to L2 and never to the non-coherent L1 / read-only path.
// - group_arrive / group_wait: the step barrier. A counter in global
//   memory that only grows; after its k-th step a block adds one and
//   waits for k * (blocks in the group). The wrapper zeroes it; it is
//   never reset inside the kernel, so there is no reset race.
// - PingPong: the rows a block reads and writes in a two-half exchange
//   buffer, carried from step to step.
// - the wgmma helpers: descriptors of K-major operand tiles in shared
//   memory, the fences, m64nNk16 for N = 16, 32, 64.
// - the mbarrier and TMA helpers: one producer thread copies the slab
//   into a ring of stages (cp.async.bulk.tensor) and two consumer
//   warpgroups multiply from it; a "full" and an "empty" mbarrier per
//   stage hand the stages over.
// - load_gate_columns / load_unit_rows / load_unit_rows_stacked: the
//   resident weight slices.
// - cluster helpers: the block's rank, the address of a variable in the
//   other block's shared memory, a store there, the cluster barrier.
// - launch_persistent: cudaFuncSetAttribute once per device, the
//   occupancy check that the grid is co-resident (and, in clusters, that
//   the card holds its clusters at once), the cooperative launch.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace recurrence {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 256;  // two warpgroups: the products and the cell
constexpr int PRODUCERS = 32;   // one warp; one thread of it feeds the ring
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MAX_DEVICES = 64;
// A barrier that waits this long is a deadlock: trap, so that the launch
// fails instead of holding the card.
constexpr unsigned long long BARRIER_TIMEOUT_NS = 20ull * 1000 * 1000 * 1000;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// wgmma operand tiles: the swizzle pattern repeats every 1024 bytes
__host__ __device__ constexpr size_t align1024(size_t n) {
  return (n + 1023) / 1024 * 1024;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* smem_dst) {
  *reinterpret_cast<uint4*>(smem_dst) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// One thread of the block, after a __syncthreads() that follows the
// block's last global write of the step: the fence makes those writes
// (they are ordered before it by the block barrier) visible device-wide
// before the count rises.
__device__ __forceinline__ void group_arrive(unsigned* counter) {
  __threadfence();
  atomicAdd(counter, 1u);
}

// The same thread, then a __syncthreads(): the acquire load orders every
// later read of the block after the other blocks' arrivals.
__device__ __forceinline__ void group_wait(const unsigned* counter,
                                           unsigned target) {
  unsigned spins = 0;
  unsigned long long t0 = 0;
  while (ld_acquire(counter) < target) {
    ++spins;
    if (spins == 4096) t0 = global_ns();
    if (spins > 4096 && (spins & 4095) == 0
        && global_ns() - t0 > BARRIER_TIMEOUT_NS)
      __trap();
  }
}

// The first rows of the block's tile in the two halves of a ping-pong
// exchange, a matrix [2 * nd * B, width]: a step reads the half the step
// before wrote and writes the other. Both rows are carried and swapped
// after every step, never computed from the step index, so that every
// kernel names the halves in one way.
struct PingPong {
  int read, write;
  // `first_read` is the half the first step reads
  __device__ PingPong(int first_read, int nd, int d, int B, int b0)
      : read((first_read * nd + d) * B + b0),
        write(((first_read ^ 1) * nd + d) * B + b0) {}
  __device__ void swap() {
    const int w = write;
    write = read;
    read = w;
  }
};

// --- wgmma (sm_90a): D[64, N] (+)= A[64, 16] x B[N, 16]^T, both operands
// bf16 in shared memory, K-major, 128-byte swizzle. An operand tile of R
// rows (a multiple of 8) is stored as atoms of 64 k: atom `ka` starts at
// ka * R * 128 bytes (1024-byte aligned), row r of it is the 128 bytes at
// r * 128, and the 16-byte piece c (k = 8c .. 8c+7) of that row lies at
// piece (c ^ (r & 7)). So a row's 128 bytes are one contiguous line of
// the source (coalesced copies, no bank conflicts) and eight rows are the
// 1024-byte swizzle pattern that wgmma undoes. In the descriptor the next
// 8 rows are 1024 bytes on (SBO); a k-step of 16 inside an atom advances
// the start address by 32 bytes. Offsets are in units of 16 bytes.

__device__ __forceinline__ unsigned long long smem_desc(const void* ptr) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(ptr);
  return (unsigned long long)((addr & 0x3FFFF) >> 4)
         | (1ull << 16)                          // LBO: unused when swizzled
         | (64ull << 32)                         // SBO: next 8 rows
         | (1ull << 62);                         // 128-byte swizzle
}

// The descriptor of k-step `ks` (16 k each) and row `row` (a multiple of
// 8) of a tile of R rows.
__device__ __forceinline__ unsigned long long desc_at(
    unsigned long long desc, int R, int ks, int row) {
  return desc + (unsigned long long)((ks / 4) * R * 8 + (ks % 4) * 2
                                     + row * 8);
}

// Where piece (row r, k group kg) of a tile of R rows lies, in elements.
__device__ __forceinline__ int swizzled(int R, int r, int kg) {
  return ((kg / 8) * R + r) * 64 + (((kg % 8) ^ (r & 7)) * 8);
}

// Generic-proxy writes to shared memory (st.shared, cp.async) become
// visible to the async proxy, through which wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving uses of an accumulator across the wait.
template <int NREG>
__device__ __forceinline__ void acc_fence(float (&d)[NREG]) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// m64n32k16: thread (warp w of the warpgroup, lane l) holds
// d[4j + 2h + c] = D[16w + l/4 + 8h][8j + 2(l%4) + c].
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                unsigned long long a,
                                                unsigned long long b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n16k16: d[4j + 2h + c] = D[16w + l/4 + 8h][8j + 2(l%4) + c], j < 2.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8],
                                                unsigned long long a,
                                                unsigned long long b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n64k16: d[4j + 2h + c] = D[16w + l/4 + 8h][8j + 2(l%4) + c], j < 8.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                 unsigned long long a,
                                                 unsigned long long b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Wa (a tile of GM*JT rows): row m = g*JT + u, piece kg holds
// w[kg*8 .. +8][g*H + j0 + u]: the gate columns of the block's JT units,
// resident for the whole sequence. w is [H, GW*H] row-major (GW gate
// groups, GW <= GM); the rows of groups past GW (padding) and of units
// past H (a ragged last tile) are zero. A piece gathers 8 rows; once a
// launch.
template <int GM, int JT>
__device__ __forceinline__ void load_gate_columns(bf16* Wa, const bf16* w,
                                                  int H, int j0,
                                                  int GW = GM) {
  constexpr int M = GM * JT;
  for (int e = threadIdx.x; e < (H / 8) * M; e += THREADS) {
    const int kg = e / M, m = e % M, g = m / JT, j = j0 + m % JT;
    __align__(16) bf16 piece[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      piece[i] = j < H && g < GW
                     ? w[(size_t)(kg * 8 + i) * GW * H + g * H + j]
                     : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(Wa + swizzled(M, m, kg)) =
        *reinterpret_cast<const uint4*>(piece);
  }
}

// Wr (a tile of JT rows): row u, piece kg holds w[j0 + u][kg*8 .. +8] for
// kg < span/8: `span` columns of the rows of the block's units, w pointing
// at the first of them in a matrix of row stride K. Rows past H are zero;
// the pieces past `span` of a partial last atom are not written (no k-step
// reads them).
template <int JT>
__device__ __forceinline__ void load_unit_rows(bf16* Wr, const bf16* w,
                                               int H, int K, int j0,
                                               int span) {
  const int nkg = span / 8;
  for (int e = threadIdx.x; e < JT * nkg; e += THREADS) {
    const int u = e / nkg, kg = e % nkg;
    bf16* dst = Wr + swizzled(JT, u, kg);
    if (j0 + u < H)
      cp_async16(dst, w + (size_t)(j0 + u) * K + kg * 8);
    else
      zero16(dst);
  }
}

// The whole rows (span = K).
template <int JT>
__device__ __forceinline__ void load_unit_rows(bf16* Wr, const bf16* w,
                                               int H, int K, int j0) {
  load_unit_rows<JT>(Wr, w, H, K, j0, K);
}

// The two halves of K stacked as rows, so that one wgmma with M = 64 and
// N = 64 forms both halves' partial products of a [32, 32] tile: tile row
// r < 32 holds columns [0, KH) of source row r, tile row 32 + r holds
// columns [KH, K) of the same source row. With A and B stacked alike,
// D[m][n] is a partial product where m and n lie in the same half, and is
// not used elsewhere. KH >= K - KH is a multiple of 8: K / 2 for the
// LSTM; the GRU's K = 3H halves into no whole k-step of 16 where H / 16
// is odd, so it takes KH = K / 2 rounded up to whole atoms of 64.

// Wr (64 rows of KH, in whole atoms of 64 k: 64 * ceil(KH/64) * 64
// elements): row 32*h + u, piece kg holds w[j0 + u][h*KH + kg*8 .. +8].
// Rows past H, the pieces past KH of a partial last atom and those past
// K of the second half are zero.
__device__ __forceinline__ void load_unit_rows_stacked(bf16* Wr,
                                                       const bf16* w, int H,
                                                       int K, int KH,
                                                       int j0) {
  const int nkg = KH / 8;                       // pieces of half a row
  const int nkgp = (nkg + 7) / 8 * 8;           // ... in whole atoms
  for (int e = threadIdx.x; e < 64 * nkgp; e += THREADS) {
    const int n = e / nkgp, kg = e % nkgp, u = n & 31;
    const int k = (n >> 5) * KH + kg * 8;
    bf16* dst = Wr + swizzled(64, n, kg);
    if (j0 + u < H && kg < nkg && k < K)
      cp_async16(dst, w + (size_t)(j0 + u) * K + k);
    else
      zero16(dst);
  }
}

// --- mbarriers in shared memory: the hand-over of ring stages between
// the producer thread (TMA) and the consumer warpgroups (wgmma).

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(a), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(a) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0, spins = 0;
  unsigned long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    ++spins;
    if (spins == 4096) t0 = global_ns();
    if (spins > 4096 && (spins & 4095) == 0
        && global_ns() - t0 > BARRIER_TIMEOUT_NS)
      __trap();
  }
}

// A barrier of the consumer threads alone (the producers never join it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// --- thread block clusters (sm_90): the blocks of a cluster run at once
// on neighbouring SMs and can write each other's shared memory.

// This block's rank in its cluster.
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of `smem_ptr`'s counterpart in the block of
// rank `rank` of this cluster.
__device__ __forceinline__ unsigned map_shared_rank(const void* smem_ptr,
                                                    unsigned rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem_ptr);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v4(unsigned addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Every thread of every block of the cluster arrives, then waits for all
// the others: what any of them wrote to any block's shared memory before
// is visible to all of them after. Not aligned: the threads of a warp may
// reach it apart (the producer thread later than its warp).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// --- TMA: the slab of the exchanged operand goes from global memory into
// the ring as boxes of [box_rows, 64 k] with the 128-byte swizzle, one
// instruction of one thread per box, completion counted in bytes on the
// stage's "full" mbarrier.

// A map of a row-major bf16 matrix [rows, cols] cut into boxes of
// [box_rows, 64]. Elements of a box outside the matrix arrive as zeros.
inline cudaError_t make_slab_map(CUtensorMap* map, const void* base,
                                 unsigned long long rows,
                                 unsigned long long cols, unsigned box_rows) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (fn == nullptr || found != cudaDriverEntryPointSuccess)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(a), "r"(bytes) : "memory");
}

// The box whose first element is (row, col) of the mapped matrix.
__device__ __forceinline__ void tma_load_box(void* smem_dst,
                                             const CUtensorMap* map, int col,
                                             int row,
                                             unsigned long long* bar) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(col), "r"(row), "r"(b) : "memory");
}

// Orders this thread's generic-proxy accesses to global memory (plain
// stores, the acquire of the step barrier) with async-proxy ones (TMA).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Once per device and kernel instantiation (`ready` is a static array of
// the caller): the kernel may opt in to all of the block's shared memory.
// `dev` receives the current device.
inline cudaError_t prepare_persistent(const void* kernel, bool* ready,
                                      int* dev) {
  int coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[*dev]) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, *dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    ready[*dev] = true;
  }
  return cudaSuccess;
}

// A launch of `grid` in clusters of `cluster` blocks along x.
inline cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attrs,
                                         int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `cluster` blocks of `kernel`, each with `smem`
// bytes of dynamic shared memory, the card holds at once.
inline cudaError_t cluster_capacity(const void* kernel, bool* ready,
                                    int cluster, size_t smem, int* clusters) {
  int dev = 0;
  cudaError_t err = prepare_persistent(kernel, ready, &dev);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(cluster), smem, 0, attrs, cluster);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The cooperative launch of a persistent kernel, in clusters of `cluster`
// blocks along x where cluster > 1. The grid must be co-resident at this
// shared-memory size (blocks per SM, and clusters the card holds at once),
// or the launch is refused (never shrunk).
inline cudaError_t launch_persistent(const void* kernel, bool* ready,
                                     dim3 grid, size_t smem, void** args,
                                     cudaStream_t stream, int cluster = 1) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = prepare_persistent(kernel, ready, &dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)grid.x * grid.y * grid.z;
  if (blocks > (long long)per_sm * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  if (cluster == 1) {
    err = cudaLaunchCooperativeKernel(kernel, grid, dim3(THREADS), args,
                                      smem, stream);
  } else {
    if (grid.x % cluster != 0) return cudaErrorInvalidValue;
    int clusters = 0;
    err = cluster_capacity(kernel, ready, cluster, smem, &clusters);
    if (err != cudaSuccess) return err;
    if (blocks > (long long)clusters * cluster)
      return cudaErrorCooperativeLaunchTooLarge;
    cudaLaunchAttribute attrs[2];
    cudaLaunchConfig_t cfg = cluster_config(grid, smem, stream, attrs,
                                            cluster);
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelExC(&cfg, kernel, args);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace recurrence
