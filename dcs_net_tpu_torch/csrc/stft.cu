// Kernel 1: fused STFT front end (framing + reflect pad + windowed, scaled
// real DFT), two entry points.
//
// Replaces the Pallas kernel dcs_net_tpu/dsp/stft_pallas.py:_forward (kernel
// _kernel). For each batch row b, frame t and bin k:
//
//   re[b, k - first_bin, t] =  sum_m xpad[b, t*hop + m] * w[m] * cos(2 pi m k / n_fft)
//   im[b, k - first_bin, t] = -sum_m xpad[b, t*hop + m] * w[m] * sin(2 pi m k / n_fft)
//
// where xpad is x reflect-padded by `pad` samples on each side (pad = 0 for
// center=False) and w is the analysis window with the 1/sqrt(n_fft) scale
// folded in (in float64, host side).
//
// What bounds it on the H100: bytes. At the enhance shape (B=4, 4 s at 16 kHz,
// T=2001, F=256, n_fft=512) the function must move ~17.4 MB (input 1 MB,
// output 16.4 MB, ~0.005 ms at the HBM rate) and an FFT needs ~0.09 GFLOP.
//
// Entry point dcs_stft_fft (power-of-two n_fft of 64, 128, 256 or 512): an FFT
// inside the kernel, so the work is the FFT's and the kernel is bound by the
// output it writes. One block owns 32 consecutive frames of one batch row and
// one lane owns one frame, so every shared-memory access of a warp is a row
// of 32 consecutive words whatever the butterfly stride, and every twiddle
// and window value is the same for the whole warp (read through the
// read-only cache, one broadcast per warp). Steps:
//   1. the tile's contiguous sample span, hop*31 + n_fft samples, is staged
//      once in shared memory (frames overlap n_fft/hop-fold; reflect padding
//      is index math). Frames start `hop` words apart, which for hop = 32
//      would put a warp's 32 frames in one bank: the span is stored skewed by
//      one word per 32;
//   2. the real frame of n_fft points is packed into N2 = n_fft/2 complex
//      points z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1] and transformed as
//      N2 = R1 * R2 (16 x 16 for n_fft = 512): a warp takes one residue
//      q = n mod R2, runs the radix-R1 DFT over r (n = q + R2 r) in
//      registers, multiplies by the twiddles exp(-2 pi i q k1 / N2) and writes
//      the R1 results to rows k1 + R1 q of a (N2, 32) complex tile in shared
//      memory;
//   3. a warp takes one k1, reads rows k1 + R1 q, runs the radix-R2 DFT over
//      q in registers and writes Z[k1 + R1 k2] back in place (row k1 + R1 k2);
//   4. the split step turns Z into the real signal's bins,
//      X[k] = E + exp(-2 pi i k / n_fft) O with E = (Z[k] + conj Z[N2-k]) / 2,
//      O = (Z[k] - conj Z[N2-k]) / 2i (indices mod N2; the halves are folded
//      into the window table), for the bins first_bin .. first_bin + F - 1
//      only, and writes (B, F, T) directly: a warp writes 32 consecutive
//      frames of one bin, one full 128-byte line.
// No dense basis is read and no transpose pass runs.
//
// Entry point dcs_stft_forward (any n_fft, generic (n_fft, F) bases): the
// dense DFT, 2*2*B*T*F*n_fft float32 FMAs (4.2 GFLOP at the enhance shape, a
// ceiling of ~0.06 ms at the float32 rate). It serves the sizes the FFT
// kernel is not instantiated for. One block per (tile of 64 frames, tile of
// 64 bins, batch row) stages the sample span as above, streams both bases
// through shared memory in 32-row chunks, and each thread keeps a 4-frame x
// 4-bin tile of cos and sin accumulators in registers.

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


// ---- the FFT entry point ----------------------------------------------------

constexpr int FFT_FT = 32;   // frames per block: one lane per frame
constexpr int FFT_NT = 512;  // threads per block: two blocks share an SM
constexpr int FFT_NW = FFT_NT / 32;

// cos and sin of j*pi/8 for j in [0, 8): the twiddles of a DFT of size <= 16
__device__ __forceinline__ float cos_pi8(int j) {
  switch (j) {
    case 0: return 1.f;
    case 1: return 0.92387953251128674f;
    case 2: return 0.70710678118654752f;
    case 3: return 0.38268343236508977f;
    case 4: return 0.f;
    case 5: return -0.38268343236508977f;
    case 6: return -0.70710678118654752f;
    default: return -0.92387953251128674f;
  }
}

__device__ __forceinline__ float sin_pi8(int j) {
  switch (j) {
    case 0: return 0.f;
    case 1: return 0.38268343236508977f;
    case 2: return 0.70710678118654752f;
    case 3: return 0.92387953251128674f;
    case 4: return 1.f;
    case 5: return 0.92387953251128674f;
    case 6: return 0.70710678118654752f;
    default: return 0.38268343236508977f;
  }
}

// In-register DFT of R points (R a power of two <= 16), natural order in and
// out, radix-2 decimation in time; every index is a compile-time constant
// after unrolling, so the arrays stay in registers and the twiddles are
// immediates.
template <int R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R]) {
  if constexpr (R > 1) {
    constexpr int H = R / 2;
    float er[H], ei[H], qr[H], qi[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      er[j] = re[2 * j];
      ei[j] = im[2 * j];
      qr[j] = re[2 * j + 1];
      qi[j] = im[2 * j + 1];
    }
    dft<H>(er, ei);
    dft<H>(qr, qi);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      // (qr + i qi) * exp(-2 pi i k / R), the angle being j * pi / 8
      const int j = k * (16 / R);
      float tr, ti;
      if (j == 0) {
        tr = qr[k];
        ti = qi[k];
      } else if (j == 4) {
        tr = qi[k];
        ti = -qr[k];
      } else {
        const float c = cos_pi8(j), sn = sin_pi8(j);
        tr = qr[k] * c + qi[k] * sn;
        ti = qi[k] * c - qr[k] * sn;
      }
      re[k] = er[k] + tr;
      im[k] = ei[k] + ti;
      re[k + H] = er[k] - tr;
      im[k + H] = ei[k] - ti;
    }
  }
}

// win2 (N2) = (w[2n], w[2n+1]) / 2; tw (R2, R1) = exp(-2 pi i q k1 / N2);
// sp (N2 + 1) = exp(-2 pi i k / n_fft); all as (cos, -sin) float2 pairs.
template <int R1, int R2>
__global__ void __launch_bounds__(FFT_NT, 2)
stft_fft_kernel(const float* __restrict__ x, const float2* __restrict__ win2,
                const float2* __restrict__ tw, const float2* __restrict__ sp,
                float* __restrict__ re, float* __restrict__ im, int n, int hop,
                int first_bin, int F, int T, int pad, int span) {
  constexpr int N2 = R1 * R2;
  extern __shared__ float2 fft_smem[];
  float2* zs = fft_smem;                                    // (N2, 32)
  float* fxs = reinterpret_cast<float*>(fft_smem + N2 * FFT_FT);  // skewed span

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FFT_FT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* xb = x + (long long)b * n;

  const int s0 = t0 * hop - pad;
  for (int s = tid; s < span; s += FFT_NT) {
    int i = s0 + s;
    if (pad > 0) {
      if (i < 0) i = -i;
      if (i >= n) i = 2 * (n - 1) - i;
    }
    fxs[skew(s)] = (i >= 0 && i < n) ? xb[i] : 0.f;
  }
  __syncthreads();

  // radix R1 over r for the residue q = n mod R2, twiddle, to rows k1 + R1 q
  for (int q = warp; q < R2; q += FFT_NW) {
    float zr[R1], zi[R1];
#pragma unroll
    for (int r = 0; r < R1; ++r) {
      const int nn = q + R2 * r;
      // an odd hop makes s odd for odd lanes, and then the pair of word s
      // may lie across a skew step: both words are skewed on their own
      const int s = lane * hop + 2 * nn;
      const float2 w = __ldg(&win2[nn]);
      zr[r] = fxs[skew(s)] * w.x;
      zi[r] = fxs[skew(s + 1)] * w.y;
    }
    dft<R1>(zr, zi);
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      const float2 t = __ldg(&tw[q * R1 + k1]);
      zs[(k1 + R1 * q) * FFT_FT + lane] = make_float2(
          zr[k1] * t.x - zi[k1] * t.y, zr[k1] * t.y + zi[k1] * t.x);
    }
  }
  __syncthreads();

  // radix R2 over q for one k1, in place: Z[k1 + R1 k2] to row k1 + R1 k2
  for (int k1 = warp; k1 < R1; k1 += FFT_NW) {
    float yr[R2], yi[R2];
#pragma unroll
    for (int q = 0; q < R2; ++q) {
      const float2 v = zs[(k1 + R1 * q) * FFT_FT + lane];
      yr[q] = v.x;
      yi[q] = v.y;
    }
    dft<R2>(yr, yi);
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2)
      zs[(k1 + R1 * k2) * FFT_FT + lane] = make_float2(yr[k2], yi[k2]);
  }
  __syncthreads();

  // split step and store: a warp writes 32 consecutive frames of one bin
  const int t = t0 + lane;
  for (int f = warp; f < F; f += FFT_NW) {
    const int k = first_bin + f;
    const float2 a = zs[(k & (N2 - 1)) * FFT_FT + lane];
    const float2 c = zs[((N2 - k) & (N2 - 1)) * FFT_FT + lane];
    const float2 w = __ldg(&sp[k]);
    const float er = a.x + c.x, ei = a.y - c.y;   // E (halves in the window)
    const float orr = a.y + c.y, oi = c.x - a.x;  // O
    if (t < T) {
      const long long o = ((long long)b * F + f) * T + t;
      re[o] = er + orr * w.x - oi * w.y;
      im[o] = ei + orr * w.y + oi * w.x;
    }
  }
}

template <int R1, int R2>
int launch_fft(cudaStream_t s, const float* x, const float* win2,
               const float* tw, const float* sp, float* re, float* im, int B,
               int n, int hop, int first_bin, int F, int T, int pad) {
  const int span = hop * (FFT_FT - 1) + 2 * R1 * R2;
  const size_t smem = sizeof(float2) * R1 * R2 * FFT_FT +
                      sizeof(float) * (skew(span - 1) + 1);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stft_fft_kernel<R1, R2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + FFT_FT - 1) / FFT_FT, B);
  stft_fft_kernel<R1, R2><<<grid, FFT_NT, smem, s>>>(
      x, reinterpret_cast<const float2*>(win2),
      reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(sp),
      re, im, n, hop, first_bin, F, T, pad, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dense entry point. x (B, n) f32; cosb, sinb (n_fft, F) f32; re, im
// (B, F, T) f32. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
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

// The FFT entry point. x (B, n) f32; win2 (n_fft/2, 2), tw (R2, R1, 2), sp
// (n_fft/2 + 1, 2) f32 tables as described above stft_fft_kernel; re, im
// (B, F, T) f32 hold the bins first_bin .. first_bin + F - 1. n_fft must be
// 64, 128, 256 or 512. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int dcs_stft_fft(const float* x, const float* win2, const float* tw,
                            const float* sp, float* re, float* im, int B, int n,
                            int n_fft, int hop, int first_bin, int F, int T,
                            int pad, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || hop <= 0 || B > 65535 || first_bin < 0 ||
      first_bin + F > n_fft / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 64:
      return launch_fft<8, 4>(s, x, win2, tw, sp, re, im, B, n, hop, first_bin, F, T, pad);
    case 128:
      return launch_fft<8, 8>(s, x, win2, tw, sp, re, im, B, n, hop, first_bin, F, T, pad);
    case 256:
      return launch_fft<16, 8>(s, x, win2, tw, sp, re, im, B, n, hop, first_bin, F, T, pad);
    case 512:
      return launch_fft<16, 16>(s, x, win2, tw, sp, re, im, B, n, hop, first_bin, F, T, pad);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
