// Kernel 1: fused STFT front end (framing + reflect pad + windowed, scaled DFT).
//
// Replaces the Pallas kernel dcs_net_tpu/dsp/stft_pallas.py:_forward (kernel
// _kernel). For each batch row b, frame t and bin f:
//
//   re[b, f, t] = sum_k xpad[b, t*hop + k] * cosb[k, f]
//   im[b, f, t] = sum_k xpad[b, t*hop + k] * sinb[k, f]
//
// where xpad is x reflect-padded by `pad` samples on each side (pad = 0 for
// center=False) and cosb/sinb are the (n_fft, F) analysis bases with the Hann
// window and the 1/sqrt(n_fft) scale folded in (in float64, host side).
//
// What bounds it on the H100: the function is bound by bytes. At the enhance
// shape (B=4, 4 s at 16 kHz, T=2001, F=256, n_fft=512) it must move ~18 MB
// (input 1 MB, bases 1 MB, output 16.4 MB, ~0.005 ms at HBM rate), while an
// FFT needs only ~0.09 GFLOP. This kernel is a dense DFT instead: it does
// 2*2*B*T*F*n_fft = 4.2 GFLOP of float32 FMAs, so its own ceiling is the
// float32 rate (~0.06 ms), about 12x the function's bound. A later PR closes
// that gap with tensor cores (3xTF32) or an FFT factorization.
//
// Design: one block per (tile of 64 frames, tile of 64 bins, batch row). The
// block stages the contiguous sample span hop*(64-1)+n_fft of its frames once
// in shared memory (the overlapping frames are never materialized; reflect
// padding is index math here), then streams both bases through shared memory
// in 32-row chunks. Each thread keeps a 4-frame x 4-bin tile of cos and sin
// accumulators in registers (float32 FMAs, no tensor cores: the plain version
// is float32 and parity is held at 1e-4). Frames sit 32 samples apart, which
// would put a warp's frames in one shared-memory bank, so the sample span is
// stored skewed by one word per 32. Output is written straight to (B, F, T)
// with consecutive threads on consecutive frames; no transpose pass.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 64;            // frames per block
constexpr int FB = 64;            // bins per block
constexpr int KC = 32;            // basis rows per shared-memory chunk
constexpr int TX = 16;            // threads along frames
constexpr int TY = 16;            // threads along bins
constexpr int RF = FT / TX;       // frames per thread
constexpr int RB = FB / TY;       // bins per thread

__host__ __device__ __forceinline__ int skew(int s) { return s + (s >> 5); }

__global__ void __launch_bounds__(TX * TY)
stft_kernel(const float* __restrict__ x, const float* __restrict__ cosb,
            const float* __restrict__ sinb, float* __restrict__ re,
            float* __restrict__ im, int n, int n_fft, int hop, int F, int T,
            int pad, int span) {
  extern __shared__ float xs[];   // skewed sample span of this frame tile
  __shared__ float cs[KC][FB];
  __shared__ float ss[KC][FB];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * FT;
  const int f0 = blockIdx.y * FB;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const float* xb = x + (long long)b * n;

  // samples [t0*hop, t0*hop + span) of the padded signal; reflect without
  // edge repeat (torch 'reflect'); positions no valid frame reads are zero
  const int s0 = t0 * hop - pad;
  for (int s = tid; s < span; s += TX * TY) {
    int i = s0 + s;
    if (pad > 0) {
      if (i < 0) i = -i;
      if (i >= n) i = 2 * (n - 1) - i;
    }
    xs[skew(s)] = (i >= 0 && i < n) ? xb[i] : 0.f;
  }

  float acc_c[RF][RB], acc_s[RF][RB];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc_c[i][j] = acc_s[i][j] = 0.f;

  for (int k0 = 0; k0 < n_fft; k0 += KC) {
    __syncthreads();  // sample span staged / previous basis chunk consumed
    for (int e = tid; e < KC * FB; e += TX * TY) {
      const int kk = e / FB, ff = e % FB;
      const int k = k0 + kk, f = f0 + ff;
      const bool ok = k < n_fft && f < F;
      cs[kk][ff] = ok ? cosb[(long long)k * F + f] : 0.f;
      ss[kk][ff] = ok ? sinb[(long long)k * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float xv[RF], cv[RB], sv[RB];
#pragma unroll
      for (int i = 0; i < RF; ++i) xv[i] = xs[skew((tx + i * TX) * hop + k0 + kk)];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        cv[j] = cs[kk][ty + j * TY];
        sv[j] = ss[kk][ty + j * TY];
      }
#pragma unroll
      for (int i = 0; i < RF; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          acc_c[i][j] = fmaf(xv[i], cv[j], acc_c[i][j]);
          acc_s[i][j] = fmaf(xv[i], sv[j], acc_s[i][j]);
        }
    }
  }

#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int f = f0 + ty + j * TY;
    if (f >= F) continue;
#pragma unroll
    for (int i = 0; i < RF; ++i) {
      const int t = t0 + tx + i * TX;
      if (t < T) {
        const long long o = ((long long)b * F + f) * T + t;
        re[o] = acc_c[i][j];
        im[o] = acc_s[i][j];
      }
    }
  }
}

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, n) f32; cosb, sinb (n_fft, F) f32; re, im (B, F, T) f32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int dcs_stft_forward(const float* x, const float* cosb,
                                const float* sinb, float* re, float* im, int B,
                                int n, int n_fft, int hop, int F, int T,
                                int pad, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || hop <= 0 || n_fft <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kk loop reads up to the next KC multiple of n_fft past each frame
  const int span = hop * (FT - 1) + (n_fft + KC - 1) / KC * KC;
  const size_t smem = static_cast<size_t>(skew(span - 1) + 1) * sizeof(float);
  if (smem + sizeof(float) * 2 * KC * FB > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + FT - 1) / FT, (F + FB - 1) / FB, B);
  dim3 block(TX, TY);
  stft_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, cosb, sinb, re, im, n, n_fft, hop, F, T, pad, span);
  return static_cast<int>(cudaGetLastError());
}
