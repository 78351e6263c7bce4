// Kernel 3: stride-1 VALID tap correlation (implicit GEMM).
//
// Replaces the Pallas kernel dcs_net_tpu/ops/pallas_tapconv.py:tapconv_valid
// (kernel _kernel):
//
//   y[b, h, w, n] = sum_{dh < Dh, dw < Dw, ci} x[b, h+dh, w+dw, ci]
//                                              * w[dh*Dw + dw, ci, n]
//
// x (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N), y (B, Hp-Dh+1, Wp-Dw+1, N), float32
// with float32 accumulation. Every decoder stage of the DCS U-Net reduces to
// this op (the fused skip-concat + nearest-upsample + 3x3 conv in its unified
// form, Dh = Dw = 3), with Cin from 32 to 512 and N from 8 to 512.
//
// What bounds it on the H100: operations. The decoder stages run 2*M*9*Cin*N
// FLOPs on M output pixels while moving only x, w and y once, hundreds of
// FLOP per byte at Cin, N >= 64 (about 107 GFLOP per enhance call at batch 4
// of 4 s). In float32 without tensor cores the ceiling is 67 TFLOP/s.
//
// Design: a GEMM of M = B*HO*WO output pixels by N channels over the
// reduction Dh*Dw*Cin, with the A operand gathered from x on the fly (no
// patch tensor in device memory). The TPU kernel keeps a whole batch element
// in VMEM; that does not fit 227 KB of shared memory, so a block owns a BM x
// BN tile of (pixels x channels) and walks the taps and 16-channel chunks,
// staging the shifted input rows and the matching weight slab in shared
// memory. Each thread accumulates a TM x TN register tile with float32 FMAs.
// Two tile shapes: 64 x 64 for N > 16, and 128 x 16 for the narrow last stage
// (N = 8) so most of the block's work is not spent on padding channels.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;  // input channels per reduction chunk

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tapconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, int Hp, int Wp, int Cin, int Dw,
               int taps, int N, int HO, int WO, long long M) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(NT % BK == 0, "threads must cover whole channel chunks");
  constexpr int ROWS_PER_PASS = NT / BK;
  constexpr int A_PER = BM / ROWS_PER_PASS;  // A rows each thread stages
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int a_k = tid % BK;

  // x offset of the tap-(0, 0) input pixel for each output row this thread
  // stages; -1 past the last pixel
  long long a_base[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    const long long m = m0 + tid / BK + r * ROWS_PER_PASS;
    if (m < M) {
      const int wo = static_cast<int>(m % WO);
      const long long t = m / WO;
      const int ho = static_cast<int>(t % HO);
      const long long b = t / HO;
      a_base[r] = ((b * Hp + ho) * Wp + wo) * Cin;
    } else {
      a_base[r] = -1;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < taps; ++tap) {
    const long long tap_off =
        (static_cast<long long>(tap / Dw) * Wp + tap % Dw) * Cin;
    const float* wt = w + static_cast<long long>(tap) * Cin * N;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int c = c0 + a_k;
#pragma unroll
      for (int r = 0; r < A_PER; ++r) {
        const int mm = tid / BK + r * ROWS_PER_PASS;
        As[a_k][mm] =
            (a_base[r] >= 0 && c < Cin) ? x[a_base[r] + tap_off + c] : 0.f;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int nn = e % BN, kk = e / BN;
        const int cc = c0 + kk, n = n0 + nn;
        Bs[kk][nn] =
            (cc < Cin && n < N) ? wt[static_cast<long long>(cc) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][tm * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tn * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + tm * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n < N) y[m * N + n] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(cudaStream_t s, const float* x, const float* w, float* y, int Hp,
            int Wp, int Cin, int Dw, int taps, int N, int HO, int WO,
            long long M) {
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (N + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  tapconv_kernel<BM, BN, TM, TN><<<grid, block, 0, s>>>(
      x, w, y, Hp, Wp, Cin, Dw, taps, N, HO, WO, M);
}

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N), y (B, Hp-Dh+1, Wp-Dw+1, N); all f32
// and contiguous. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int dcs_tapconv_valid(const float* x, const float* w, float* y,
                                 int B, int Hp, int Wp, int Cin, int Dh,
                                 int Dw, int N, void* stream) {
  const int HO = Hp - Dh + 1, WO = Wp - Dw + 1;
  if (B < 1 || Cin < 1 || N < 1 || Dh < 1 || Dw < 1 || HO < 1 || WO < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * HO * WO;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    launch<128, 16, 4, 2>(s, x, w, y, Hp, Wp, Cin, Dw, Dh * Dw, N, HO, WO, M);
  else
    launch<64, 64, 4, 4>(s, x, w, y, Hp, Wp, Cin, Dw, Dh * Dw, N, HO, WO, M);
  return static_cast<int>(cudaGetLastError());
}
