// Kernel 2: stride-1 "same" cross-correlation for small output channel counts.
//
// Replaces the Pallas kernel dcs_net_tpu/ops/pallas_conv.py:_conv_fwd_pallas
// (kernel _kernel):
//
//   y[b, h, w, co] = bias[co] + sum_{kh, kw, ci}
//                    x[b, h + kh - K/2, w + kw - K/2, ci] * w[kh, kw, ci, co]
//
// NHWC activations, HWIO weights, zero halo, float32 accumulation; odd K <= 7
// and Cout <= 16, any H, W and Cin. On the DCS path these are the 13 CBAM
// spatial-attention convs: Cin = 4 (packed re/im of channel mean and max),
// Cout = 2, K = 7.
//
// What bounds it on the H100: operations, narrowly. Per output pixel it reads
// Cin floats and writes Cout floats (24 bytes for the SA convs) against
// 2*K*K*Cin*Cout = 784 float32 FLOPs, 33 FLOP/byte, above the card's float32
// ridge point of 20 (67 TFLOP/s over 3.35 TB/s). So the design reads the input
// from device memory once and keeps every FMA operand in shared memory or
// registers.
//
// Design: one thread per output pixel, a block owns an 8 x 32 tile of pixels.
// The block stages its input tile plus the K/2 halo (zero outside the image)
// in shared memory, 8 input channels at a time, laid out channel-planar so a
// warp's 32 neighbouring pixels read 32 consecutive words; the weights of the
// chunk sit in shared memory too and every thread reads the same word
// (broadcast). Each thread holds all Cout accumulators in registers (Cout is a
// template parameter, so the register array is fully unrolled) and adds the
// bias in the epilogue. Writes are contiguous: neighbouring threads write
// neighbouring pixels' Cout-vectors.

#include <cuda_runtime.h>

namespace {

constexpr int BW = 32;      // output columns per block
constexpr int BH = 8;       // output rows per block
constexpr int CC = 8;       // input channels staged per chunk
constexpr int MAXK = 7;
constexpr int MAXCOUT = 16;

template <int COUT>
__global__ void __launch_bounds__(BW * BH)
conv_same_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, int H,
                 int W, int Cin, int K) {
  __shared__ float xs[CC][BH + MAXK - 1][BW + MAXK - 1];
  __shared__ float ws[MAXK * MAXK * CC * COUT];

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * BH;
  const int w0 = blockIdx.x * BW;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BW + tx;
  const int p = K / 2;
  const int th = BH + K - 1, tw = BW + K - 1;

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int cc = min(CC, Cin - c0);
    __syncthreads();  // previous chunk consumed
    for (int e = tid; e < cc * th * tw; e += BW * BH) {
      const int c = e % cc;
      const int r = e / cc;
      const int col = r % tw, row = r / tw;
      const int hh = h0 - p + row, ww = w0 - p + col;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = x[(((long long)b * H + hh) * W + ww) * Cin + c0 + c];
      xs[c][row][col] = v;
    }
    for (int e = tid; e < K * K * cc * COUT; e += BW * BH) {
      const int co = e % COUT;
      const int r = e / COUT;
      const int c = r % cc, tap = r / cc;
      ws[e] = w[((long long)tap * Cin + c0 + c) * COUT + co];
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c)
      for (int kh = 0; kh < K; ++kh)
        for (int kw = 0; kw < K; ++kw) {
          const float v = xs[c][ty + kh][tx + kw];
          const float* wp = &ws[((kh * K + kw) * cc + c) * COUT];
#pragma unroll
          for (int co = 0; co < COUT; ++co) acc[co] = fmaf(v, wp[co], acc[co]);
        }
  }

  const int hh = h0 + ty, ww = w0 + tx;
  if (hh < H && ww < W) {
    float* yp = y + (((long long)b * H + hh) * W + ww) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) yp[co] = acc[co] + bias[co];
  }
}

using Launch = void (*)(dim3, dim3, cudaStream_t, const float*, const float*,
                        const float*, float*, int, int, int, int);

template <int COUT>
void launch(dim3 grid, dim3 block, cudaStream_t s, const float* x,
            const float* w, const float* bias, float* y, int H, int W, int Cin,
            int K) {
  conv_same_kernel<COUT><<<grid, block, 0, s>>>(x, w, bias, y, H, W, Cin, K);
}

constexpr Launch kLaunch[MAXCOUT] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W, Cin), w (K, K, Cin, Cout), bias (Cout,), y (B, H, W, Cout); all
// f32 and contiguous. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int dcs_conv_same_small_cout(const float* x, const float* w,
                                        const float* bias, float* y, int B,
                                        int H, int W, int Cin, int K, int Cout,
                                        void* stream) {
  if (K % 2 == 0 || K < 1 || K > MAXK || Cout < 1 || Cout > MAXCOUT ||
      Cin < 1 || B < 1 || B > 65535 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH, B);
  dim3 block(BW, BH);
  kLaunch[Cout - 1](grid, block, static_cast<cudaStream_t>(stream), x, w, bias,
                    y, H, W, Cin, K);
  return static_cast<int>(cudaGetLastError());
}
