// Fused STFT -> power -> mel -> log (-> DCT) feature frontend, direct-DFT
// route: K1 for an n_fft that is not a power of two (stft.cu's FFT takes
// the powers of two). ctc_asr_tpu_torch/ops/stft_cuda.py check_geometry
// picks the route from the geometry alone.
//
// Replaces: ctc_asr_tpu/ops/stft_pallas.py, _stft_kernel (launched by
// features_pallas), for the sizes the FFT kernel does not take: the
// reference builds its DFT bases for any n_fft. Computes what the plain
// path computes (ctc_asr_tpu_torch/features.py plain_features): for each
// frame t of utterance b, with x_t[n] = samples[b, min(t*hop + n, S-1)],
//   power[k] = (sum_n x_t[n] cw[n,k])^2 + (sum_n x_t[n] sw[n,k])^2
//   out[b,t,m] = log(max(sum_k power[k] mel[k,m], floor))   (then @ dct)
// where cw / sw are the cos / -sin DFT bases [W, NB] with the Hann window
// folded in (a window longer than n_fft folds by the bases' period), cut
// to the NB bins the filterbank uses.
//
// What bounds it on the H100: the DFT is 2*W*NB multiply-adds a frame
// (W=400, n_fft=400: NB=201, 161k a frame, ~16 G for B=128 x 8 s), done
// in f32 on the CUDA cores (67 TFLOP/s), so it is bound by operations,
// with the bases (~640 KB) streamed from L2 once a block as the second
// limit. The samples, the power spectrum and the log-mel tile never leave
// the SM. An FFT needs far fewer operations; this route is for the sizes
// it does not take, and PERF.md gives its time beside the FFT's.
//
// What the design does about it: one block owns FT=32 consecutive frames
// of one utterance and stages their overlapping sample span
// ((FT-1)*hop + W floats) in shared memory once, so each sample is read
// from device memory about once. Each thread keeps an 8-frame x 4-bin
// register tile of re/im sums (64 accumulators): per window sample it
// loads 4+4 basis values (coalesced across the warp) and 8 samples (a
// shared-memory broadcast: a warp shares its frames) for 64 FMAs. Power
// goes to shared memory; the mel product, the log floor and the optional
// DCT follow in the same block. Shared memory is span + FT*NB + FT*M
// floats; the host refuses a geometry above the 227 KB a block may have.
// f32 only, as the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;          // frames per block
constexpr int THREADS = 256;
constexpr int FG = 8;           // frames per thread
constexpr int BIN_LANES = 64;   // threads across bins
constexpr int BG = 4;           // bins per thread per pass (stride 64)
static_assert(FT == (THREADS / BIN_LANES) * FG, "frame tiling");

__global__ void __launch_bounds__(THREADS)
stft_dft_kernel(const float* __restrict__ samples,
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
// (ignored unless use_dct); out [B, T, F] f32. Returns cudaError_t (the
// launch is refused where the shared memory exceeds the block's limit).
extern "C" int stft_dft_forward(const void* samples, const void* cosb,
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
      stft_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + FT - 1) / FT, B);
  stft_dft_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)samples, (const float*)cosb, (const float*)sinb,
      (const float*)melfb, (const float*)dct, (float*)out, S, T, W, hop, NB,
      M, F, use_dct, log_floor);
  return (int)cudaGetLastError();
}
