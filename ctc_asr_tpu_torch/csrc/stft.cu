// Fused STFT -> power -> mel -> log (-> DCT) feature frontend.
//
// Replaces: ctc_asr_tpu/ops/stft_pallas.py, _stft_kernel (launched by
// features_pallas). Computes what the plain path computes
// (ctc_asr_tpu_torch/features.py plain_features): for each frame t of
// utterance b, with x_t[n] = samples[b, min(t*hop + n, S-1)],
//   power[k] = (sum_n x_t[n] cw[n,k])^2 + (sum_n x_t[n] sw[n,k])^2
//   out[b,t,m] = log(max(sum_k power[k] mel[k,m], floor))   (then @ dct)
// where cw / sw are the cos / -sin DFT bases with the Hann window folded
// in and truncated to the NB bins the filterbank uses.
//
// What bounds it on the H100: the DFT is 2*W*NB multiply-adds per frame
// (W=400, NB=256: 205k per frame, ~21 G for B=128 x 8 s), done in f32 on
// the CUDA cores (67 TFLOP/s), so it is compute-bound, with the basis
// (800 KB) streamed from L2 once per block as the second limit. The
// samples, the power spectrum and the log-mel tile never leave the SM.
//
// What the design does about it: one block owns FT=32 consecutive frames
// of one utterance and stages their overlapping sample span
// ((FT-1)*hop + W floats, ~21 KB) in shared memory once, so each sample
// is read from device memory about once. The Pallas kernel cut frames
// into hop-rows only because Mosaic cannot load at unaligned lane
// offsets; here a frame is read directly at any offset. Each thread
// keeps an 8-frame x 4-bin register tile of re/im sums (64 accumulators):
// per window sample it loads 4+4 basis values (coalesced across the
// warp) and 8 samples (a shared-memory broadcast: a warp shares its
// frames) for 64 FMAs. Power goes to shared memory; the mel product, the
// log floor and the optional DCT follow in the same block. f32 only: a
// bf16 split of the DFT was measured 2x slower on the TPU and the power
// spectrum of a low-energy frame needs f32.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;          // frames per block
constexpr int THREADS = 256;
constexpr int FG = 8;           // frames per thread
constexpr int BIN_LANES = 64;   // threads across bins
constexpr int BG = 4;           // bins per thread per pass (stride 64)
static_assert(FT == (THREADS / BIN_LANES) * FG, "frame tiling");

__global__ void __launch_bounds__(THREADS)
stft_mel_kernel(const float* __restrict__ samples,
                const float* __restrict__ cosb,
                const float* __restrict__ sinb,
                const float* __restrict__ melfb,
                const float* __restrict__ dct,
                float* __restrict__ out,
                int S, int T, int W, int hop, int NB, int M, int F,
                int use_dct, float log_floor) {
  extern __shared__ float smem[];
  const int span = (FT - 1) * hop + W;
  float* xs = smem;              // [span]
  float* pw = xs + span;         // [FT][NB]
  float* lm = pw + FT * NB;      // [FT][M]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const float* x = samples + (size_t)b * S;
  const long long base = (long long)t0 * hop;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    long long g = base + i;
    if (g > S - 1) g = S - 1;    // the reference's index clamp
    xs[i] = x[g];
  }
  __syncthreads();

  const int lane_bin = threadIdx.x % BIN_LANES;
  const int f0 = (threadIdx.x / BIN_LANES) * FG;
  for (int kb = 0; kb < NB; kb += BIN_LANES * BG) {
    float re[FG][BG], im[FG][BG];
#pragma unroll
    for (int j = 0; j < FG; ++j)
#pragma unroll
      for (int q = 0; q < BG; ++q) { re[j][q] = 0.f; im[j][q] = 0.f; }
    bool kv[BG];
#pragma unroll
    for (int q = 0; q < BG; ++q) kv[q] = kb + lane_bin + BIN_LANES * q < NB;

    for (int n = 0; n < W; ++n) {
      float c[BG], s[BG];
#pragma unroll
      for (int q = 0; q < BG; ++q) {
        const int k = kb + lane_bin + BIN_LANES * q;
        c[q] = kv[q] ? cosb[(size_t)n * NB + k] : 0.f;
        s[q] = kv[q] ? sinb[(size_t)n * NB + k] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < FG; ++j) {
        const float xv = xs[(f0 + j) * hop + n];
#pragma unroll
        for (int q = 0; q < BG; ++q) {
          re[j][q] = fmaf(xv, c[q], re[j][q]);
          im[j][q] = fmaf(xv, s[q], im[j][q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < FG; ++j)
#pragma unroll
      for (int q = 0; q < BG; ++q)
        if (kv[q])
          pw[(f0 + j) * NB + kb + lane_bin + BIN_LANES * q] =
              re[j][q] * re[j][q] + im[j][q] * im[j][q];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < FT * M; o += THREADS) {
    const int f = o / M, m = o % M;
    float acc = 0.f;
    for (int k = 0; k < NB; ++k) acc = fmaf(pw[f * NB + k], melfb[k * M + m], acc);
    const float v = logf(fmaxf(acc, log_floor));
    if (use_dct) {
      lm[f * M + m] = v;
    } else if (t0 + f < T) {
      out[((size_t)b * T + t0 + f) * F + m] = v;
    }
  }
  if (!use_dct) return;
  __syncthreads();
  for (int o = threadIdx.x; o < FT * F; o += THREADS) {
    const int f = o / F, kk = o % F;
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc = fmaf(lm[f * M + m], dct[m * F + kk], acc);
    if (t0 + f < T) out[((size_t)b * T + t0 + f) * F + kk] = acc;
  }
}

}  // namespace

// samples [B, S] f32; cosb/sinb [W, NB]; melfb [NB, M]; dct [M, F]
// (ignored unless use_dct); out [B, T, F] f32. Returns cudaError_t.
extern "C" int stft_mel_forward(const void* samples, const void* cosb,
                                const void* sinb, const void* melfb,
                                const void* dct, void* out, int B, int S,
                                int T, int W, int hop, int NB, int M, int F,
                                int use_dct, float log_floor, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (B > 65535 || S <= 0 || W <= 0 || hop <= 0 || NB <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const int span = (FT - 1) * hop + W;
  const size_t smem = (size_t)(span + FT * NB + FT * M) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + FT - 1) / FT, B);
  stft_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)samples, (const float*)cosb, (const float*)sinb,
      (const float*)melfb, (const float*)dct, (float*)out, S, T, W, hop, NB,
      M, F, use_dct, log_floor);
  return (int)cudaGetLastError();
}
