// Fused STFT -> power -> mel -> log (-> DCT) feature frontend.
//
// Replaces: ctc_asr_tpu/ops/stft_pallas.py, _stft_kernel (launched by
// features_pallas). Computes what the plain path computes
// (ctc_asr_tpu_torch/features.py plain_features): for each frame t of
// utterance b, with x_t[n] = samples[b, min(t*hop + n, S-1)] * hann[n]
// for n < W, zero-padded (or, for W > N, folded mod N) to N = n_fft,
//   power[k] = |sum_n x_t[n] e^{-2 pi i n k / N}|^2          (k < NB)
//   out[b,t,m] = log(max(sum_k power[k] mel[k,m], floor))    (then @ dct)
//
// What bounds it on the H100: the function needs ~13k f32 operations a
// frame for N=512 (a 256-point complex FFT, the real split, the power,
// ~2 * NB mel products), ~1.4 GFLOP at B=128 x 8 s: 0.02 ms at the f32
// peak, below the bytes (the samples read and the features written
// once, 98 MB: 0.029 ms). So the aim is to touch device memory once and
// keep the arithmetic short.
//
// What the design does about it: one block owns FT=8 consecutive frames
// of one utterance and stages their overlapping sample span
// ((FT-1)*hop + W floats), the window, the twiddle table and the sparse
// filterbank in shared memory once; then each warp owns one frame. The
// warp packs the N real samples as N/2 complex points
// z[p] = x[2p] + i x[2p+1] and runs an N/2-point Stockham FFT (natural
// order in and out, no bit reversal) in radix-8 passes with one last
// pass of radix 4 or 2: a lane holds a pass's butterflies in registers,
// and the passes exchange through the warp's own tile of shared memory
// (re and im planes, one float of padding every 32) with __syncwarp
// only. The real split X[k] = (A + W_N^k (-i) B) / 2, A = Z[k] +
// conj(Z[N/2-k]), B = Z[k] - conj(Z[N/2-k]), gives bins 0..NB-1
// (Nyquist included when a filter uses it). Each mel filter sums only
// its nonzero bins [lo, lo + len) against packed weights (each bin
// feeds at most two triangular filters). The log floor and the DCT
// follow, and each warp writes its frame's row of F features coalesced.
// Twiddles come from a host table computed in f64 (no __sinf, no fast
// math); everything is f32, as the plain version is.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 8;           // frames per block, one warp each
constexpr int THREADS = 32 * FT;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-register forward DFT of R points, natural order in and out.
template <int R> __device__ __forceinline__ void dft(float2* v);

template <> __device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <> __device__ __forceinline__ void dft<4>(float2* v) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <> __device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float H = 0.70710678118654752f;   // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  // o[k] *= e^{-2 pi i k / 8}
  o[1] = make_float2(H * (o[1].x + o[1].y), H * (o[1].y - o[1].x));
  o[2] = mul_mi(o[2]);
  o[3] = make_float2(H * (o[3].y - o[3].x), -H * (o[3].x + o[3].y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// The radix of pass p of an NH-point FFT: 8 while three or more bits are
// left, then 4 or 2 (256 = 8.8.4, 512 = 8.8.8, 1024 = 8.8.8.2).
template <int NH> struct Plan {
  static constexpr int LOG = NH == 32 ? 5 : NH == 64 ? 6 : NH == 128 ? 7
      : NH == 256 ? 8 : NH == 512 ? 9 : 10;
  static_assert((1 << LOG) == NH, "NH is a power of two in 32..1024");
  static constexpr int PASSES = (LOG + 2) / 3;
  __host__ __device__ static constexpr int radix(int p) {
    return p < LOG / 3 ? 8 : (LOG % 3 == 1 ? 2 : 4);
  }
};

// Twiddle, butterfly and store of one Stockham pass (stride NS so far)
// for the butterflies a lane holds: bf = lane + 32 i < NH / R.
template <int NH, int R, int NS, int PER>
__device__ __forceinline__ void butterflies(float2 (&v)[PER][R], int lane,
                                            const float2* tw, float* re,
                                            float* im) {
  constexpr int NBF = NH / R;
  constexpr int STEP = 2 * NH / (NS * R);    // twiddle table stride
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int bf = lane + 32 * i;
    if (NBF % 32 != 0 && bf >= NBF) continue;
    const int k = bf & (NS - 1);
    if (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[i][r] = cmul(v[i][r], tw[r * k * STEP]);
    }
    dft<R>(v[i]);
    const int dst = (bf / NS) * NS * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = pad(dst + r * NS);
      re[j] = v[i][r].x;
      im[j] = v[i][r].y;
    }
  }
}

// Passes 1.. of the FFT: read the tile, sync, butterflies, sync.
template <int NH, int P, int NS>
__device__ __forceinline__ void later_passes(int lane, const float2* tw,
                                             float* re, float* im) {
  if constexpr (P < Plan<NH>::PASSES) {
    constexpr int R = Plan<NH>::radix(P);
    constexpr int NBF = NH / R;
    constexpr int PER = (NBF + 31) / 32;
    float2 v[PER][R];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int bf = lane + 32 * i;
      if (NBF % 32 != 0 && bf >= NBF) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = pad(bf + r * NBF);
        v[i][r] = make_float2(re[j], im[j]);
      }
    }
    __syncwarp();
    butterflies<NH, R, NS, PER>(v, lane, tw, re, im);
    __syncwarp();
    later_passes<NH, P + 1, NS * R>(lane, tw, re, im);
  }
}

template <int NH>
__global__ void __launch_bounds__(THREADS)
stft_mel_kernel(const float* __restrict__ samples,
                const float* __restrict__ window,   // [W]
                const float2* __restrict__ twiddle, // [2*NH]: e^{-2 pi i e/N}
                const float* __restrict__ mel_w,    // [n_melw] packed
                const int* __restrict__ mel_lo,     // [M] first bin
                const int* __restrict__ mel_off,    // [M+1] offsets in mel_w
                const float* __restrict__ dct,      // [M, F]
                float* __restrict__ out,            // [B, T, F]
                int S, int T, int W, int hop, int NB, int M, int F,
                int n_melw, int plane, int use_dct, float log_floor) {
  constexpr int N = 2 * NH;
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);          // [N]
  float* win = reinterpret_cast<float*>(tw + N);          // [W]
  float* mw = win + W;                                    // [n_melw]
  int* mlo = reinterpret_cast<int*>(mw + n_melw);         // [M]
  int* moff = mlo + M;                                    // [M + 1]
  float* xs = reinterpret_cast<float*>(moff + M + 1);     // [span]
  const int span = (FT - 1) * hop + W;
  float* tiles = xs + span;                      // [FT][2][plane]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const float* x = samples + (size_t)b * S;
  const long long base = (long long)t0 * hop;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    long long g = base + i;
    if (g > S - 1) g = S - 1;    // the reference's index clamp
    xs[i] = x[g];
  }
  for (int i = threadIdx.x; i < N; i += THREADS) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < W; i += THREADS) win[i] = window[i];
  for (int i = threadIdx.x; i < n_melw; i += THREADS) mw[i] = mel_w[i];
  for (int i = threadIdx.x; i < M; i += THREADS) mlo[i] = mel_lo[i];
  for (int i = threadIdx.x; i <= M; i += THREADS) moff[i] = mel_off[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = t0 + warp;
  if (t >= T) return;            // no block barrier follows
  const float* xf = xs + warp * hop;
  float* re = tiles + warp * 2 * plane;         // re and im planes of
  float* im = re + plane;                        // the warp's tile

  // pass 0 (stride 1, no twiddles) straight from the windowed samples:
  // z[p] = x[2p] + i x[2p+1], folded mod N where W > N
  {
    constexpr int R = Plan<NH>::radix(0);
    constexpr int NBF = NH / R;
    constexpr int PER = (NBF + 31) / 32;
    float2 v[PER][R];
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) v[i][r] = make_float2(0.f, 0.f);
    for (int f0 = 0; f0 < W; f0 += N) {     // one trip unless W > N
#pragma unroll
      for (int i = 0; i < PER; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int n = f0 + 2 * (lane + 32 * i + r * NBF);
          if (n < W) v[i][r].x = fmaf(xf[n], win[n], v[i][r].x);
          if (n + 1 < W) v[i][r].y = fmaf(xf[n + 1], win[n + 1], v[i][r].y);
        }
      }
    }
    butterflies<NH, R, 1, PER>(v, lane, tw, re, im);
    __syncwarp();
  }
  later_passes<NH, 1, Plan<NH>::radix(0)>(lane, tw, re, im);

  // real split: power of bins k = lane + 32 q < NB (NB <= NH + 1)
  constexpr int QB = NH / 32 + 1;
  float pw[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const int k = lane + 32 * q;
    pw[q] = 0.f;
    if (k < NB) {
      const int k1 = pad(k & (NH - 1)), k2 = pad((NH - k) & (NH - 1));
      const float2 zk = make_float2(re[k1], im[k1]);
      const float2 zc = make_float2(re[k2], -im[k2]);
      const float2 X = cadd(cadd(zk, zc), cmul(tw[k], mul_mi(csub(zk, zc))));
      pw[q] = 0.25f * (X.x * X.x + X.y * X.y);
    }
  }
  __syncwarp();
  float* pwr = re;               // [NB], over the tile's re plane
  float* lm = im;                // [M], over its im plane
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const int k = lane + 32 * q;
    if (k < NB) pwr[k] = pw[q];
  }
  __syncwarp();

  float* row = out + ((size_t)b * T + t) * F;
  for (int m = lane; m < M; m += 32) {
    const int lo = mlo[m], o0 = moff[m], n = moff[m + 1] - o0;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) acc = fmaf(pwr[lo + i], mw[o0 + i], acc);
    const float v = logf(fmaxf(acc, log_floor));
    if (use_dct)
      lm[m] = v;
    else
      row[m] = v;
  }
  if (!use_dct) return;
  __syncwarp();
  for (int kk = lane; kk < F; kk += 32) {
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc = fmaf(lm[m], __ldg(dct + m * F + kk), acc);
    row[kk] = acc;
  }
}

template <int NH>
int launch(const float* samples, const float* window, const float2* twiddle,
           const float* mel_w, const int* mel_lo, const int* mel_off,
           const float* dct, float* out, int B, int S, int T, int W, int hop,
           int NB, int M, int F, int n_melw, int use_dct, float log_floor,
           cudaStream_t stream) {
  const int span = (FT - 1) * hop + W;
  // a plane holds NH padded points, then NB <= NH + 1 powers, or M log-mels
  const int plane = NH + NH / 32 > M ? NH + NH / 32 : M;
  const size_t smem = (size_t)(2 * 2 * NH + W + n_melw + M + M + 1 + span
                               + FT * 2 * plane) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_kernel<NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + FT - 1) / FT, B);
  stft_mel_kernel<NH><<<grid, THREADS, smem, stream>>>(
      samples, window, twiddle, mel_w, mel_lo, mel_off, dct, out, S, T, W,
      hop, NB, M, F, n_melw, plane, use_dct, log_floor);
  return (int)cudaGetLastError();
}

}  // namespace

// samples [B, S] f32; window [W]; twiddle [n_fft] complex (float2);
// mel_w [n_melw], mel_lo [M], mel_off [M+1]; dct [M, F] (ignored unless
// use_dct); out [B, T, F] f32. n_fft is a power of two in 64..2048 and
// NB <= n_fft/2 + 1. Returns cudaError_t.
extern "C" int stft_mel_forward(const void* samples, const void* window,
                                const void* twiddle, const void* mel_w,
                                const void* mel_lo, const void* mel_off,
                                const void* dct, void* out, int B, int S,
                                int T, int W, int hop, int n_fft, int NB,
                                int M, int F, int n_melw, int use_dct,
                                float log_floor, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (B > 65535 || S <= 0 || W <= 0 || hop <= 0 || M <= 0 || NB <= 0 ||
      NB > n_fft / 2 + 1 || n_melw < 0)
    return (int)cudaErrorInvalidValue;
#define STFT_ARGS                                                          \
  (const float*)samples, (const float*)window, (const float2*)twiddle,    \
      (const float*)mel_w, (const int*)mel_lo, (const int*)mel_off,       \
      (const float*)dct, (float*)out, B, S, T, W, hop, NB, M, F, n_melw,  \
      use_dct, log_floor, (cudaStream_t)stream
  switch (n_fft) {
    case 64: return launch<32>(STFT_ARGS);
    case 128: return launch<64>(STFT_ARGS);
    case 256: return launch<128>(STFT_ARGS);
    case 512: return launch<256>(STFT_ARGS);
    case 1024: return launch<512>(STFT_ARGS);
    case 2048: return launch<1024>(STFT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef STFT_ARGS
}
