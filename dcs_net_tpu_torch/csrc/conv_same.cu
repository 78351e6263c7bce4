// Kernel 2: stride-1 "same" cross-correlation for small output channel counts,
// and the CBAM spatial-attention gate built around it.
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
// Cout = 2, K = 7. There the conv is the middle of a gate,
//
//   pooled = [mean_c re, max_c re, mean_c im, max_c im]          (B, H, W, 4)
//   a      = sigmoid(conv(pooled))                                (B, H, W, 2)
//   out    = x * a  (complex product, a broadcast over channels)  (B, H, W, C)
//
// whose pooling and product move far more bytes than the conv computes on, so
// the file has three entry points: the conv alone (dcs_conv_same_small_cout),
// the pooling pass (dcs_sa_pool) and the conv with a sigmoid-and-product
// epilogue (dcs_sa_gate); the real family's pair of the last two (below);
// at bf16 the whole gate in one kernel (dcs_sa_fused_bf16), the conv
// entry's bf16 class and the real pair's bf16 classes.
//
// What bounds them on the H100. The conv alone: operations, narrowly. Per
// output pixel it reads Cin floats and writes Cout floats (24 bytes for the
// SA convs) against 2*K*K*Cin*Cout = 784 float32 FLOPs, 33 FLOP/byte, above
// the card's float32 ridge point of 20 (67 TFLOP/s over 3.35 TB/s). The gate
// as a whole: bytes. x has 8 to 128 complex channels, so one pass over it is
// 64 to 1024 bytes a pixel against the same 784 FLOPs; the design reads x
// twice (pool, gate) and writes it once, and keeps the pooled map, the
// attention map and every FMA operand out of device memory or in registers.
// A single kernel that pooled inside the gate would read x again for the
// 3-pixel halo of every tile.
//
// Why not the tensor cores at float32: N = Cout = 2 padded to wgmma's n8
// wastes 4x, and float32 accuracy costs three TF32 passes, 495 / 12 = 41
// TFLOP/s effective, below the 67 TFLOP/s of the float32 pipes. (The bf16
// classes below run on the tensor cores: their operands need no split, and
// N is filled with output shifts instead of zeros.)
//
// The bf16 class of the gate (serving at --dtype bfloat16) overturns both
// arguments, and runs as one kernel (dcs_sa_fused_bf16, below; PR 15's pool
// and gate pair, dcs_sa_pool_bf16 + dcs_sa_gate_bf16, serves only the shapes
// it refuses). Pooling inside the gate: at bf16 x is half the bytes and the
// largest site's x (16.4 MB at 4 x 128 x 1004 x 8, both planes) fits the
// card's 50 MB L2, so the halo that neighbouring tiles read again is served
// by L2 while those tiles are in flight; at the C = 128 sites the images are
// 2-8 rows high, and a tile that spans the height has no halo rows at all.
// So a block's two tensor copies bring each plane's tile with its halo into
// shared memory once, it pools from there, convolves, and multiplies the
// same tile: x crosses device memory once, the pooled and attention maps
// never, and a site is one launch and one round trip to device memory
// where the pair was two launches, each waiting on its own. The tensor
// cores: at bf16 there is no 3xTF32 split (the operands are bf16 already,
// their products exact in float32), so the 7 x 7 x 4 -> 2 conv is an
// mma.sync m16n8k16 product with N = 2 padded to 8: 989 TFLOP/s wasting 4x
// is still ~250 against the float32 pipes' 67, and the 392 FMAs a pixel
// that set the C = 8 sites' time (widened to float32 from a float4 a pixel
// in shared memory) become 14 mma a 16-pixel group reading 4 bf16 (8 bytes)
// a pooled pixel. See sa_fused_bf16_kernel's notes.
//
// Design of the register-tiled body, written for (K, Cin, Cout) = (7, 4, 2)
// and shared by the conv and the gate. A block of 128 threads owns a tile of
// TY rows x R*TX columns; the first TX*TY threads each own a run of R pixels
// along W. The block stages the tile plus its 3-pixel halo (zero outside the
// image) in shared memory, one float4 per pixel (its 4 input channels), and
// the 392 weights beside it.
// For each of the 7 tap rows a thread loads the R + 6 pixels under its run
// into registers once and slides the 7 taps over that window: one
// shared-memory load of a pixel feeds up to 7 taps x 4 channels x 2 outputs,
// and the 8 weights of a tap arrive as two float4 loads at an address that
// is uniform over the warp (a broadcast). Per tap row that is R + 6 + 14
// loads for 56 R FMAs: 9.3 FMAs a load at R = 4 (the first version of this
// kernel, one pixel a thread, made 3 loads for 2 FMAs; R = 8 was no faster
// at any shape of the model and was dropped). A thread's run starts R pixels
// after its neighbour's, a stride of 16 R bytes that would put a
// quarter-warp's float4 loads on the same banks, so a staged row has one
// slot of padding after every R pixels (pixel p sits at slot p + p/R): the
// runs then start R + 1 slots apart, an odd stride, and eight threads of a
// row read eight different 16-byte bank groups. The taps of a row are
// unrolled; the loop over tap rows is not (its body is 56 R FMAs, and
// unrolled it ran slower).
//
// The tile follows the image (chosen by the wrapper, ops/cuda_conv.py:
// choose_tile): a large image gets 16 x 32 pixel tiles with R = 4 (1.6x
// staged per output); a small one gets tiles down to 8 pixels with R = 2, so
// that a few thousand pixels still spread over the card's 132 SMs, which
// matters for the gate, where a small image carries the most channels. Fewer
// than 128 threads then take part in the conv, all 128 in staging and in the
// product.
//
// Epilogues. The attention map (with the bias, or through the sigmoid) goes
// to shared memory. The conv entry writes it out coalesced. The gate streams
// its tile of x through it: a warp takes a tile row, whose pixels are
// contiguous in NHWC, as float4 loads along (pixel, channel), multiplies by
// the pixel's (a_re, a_im) and stores; one read and one write of x.
//
// The input gradient of the spatial-attention conv (the JAX package's _bwd,
// dcs_net_tpu/ops/pallas_conv.py:210, in XLA) is the same conv of the
// upstream gradient with the flipped, transposed kernel: class (7, 2, 4),
// 13 launches a train step. It runs the same body as a template over
// (Cin, Cout): a staged pixel is one float2, a tap's 8 weights are still two
// float4 broadcasts (now one per input channel), an output pixel is one
// float4. A half-warp's 8-byte loads span rows where a tile is fewer than 16
// runs wide, so the row pitch is padded further (make_tile) to keep them on
// 16 different 8-byte bank groups.
//
// The real family (DR, DRS). Its spatial attention pools one plane,
//
//   pooled = [mean_c x, max_c x]                                  (B, H, W, 2)
//   out    = x * sigmoid(conv(pooled))   (a broadcast over C)     (B, H, W, C)
//
// so its conv is class (7, 2, 1) and its input gradient (7, 1, 2): 98
// weights, 2 a tap, a quarter of the complex classes' operations per pixel
// on a pixel of 8 or 4 bytes. The same body runs them as a template over
// (Cin, Cout): a tap's 2 weights are one float2 broadcast, a staged pixel a
// float2 or a float, an output pixel a float or a float2. At these classes
// the window loads outnumber the FMAs' operands less (R + 6 + 7 loads for
// 14 R FMAs a tap row), so R = 8 is offered beside 2 and 4. A warp's 4-byte
// loads (Cin = 1) are served all 32 at once and must differ mod 32: the
// pitch is padded to TX * (R + 1) mod 32, the 8-byte rule's at twice the
// modulus. What the generic body spent at the small sites over an empty
// launch was a serial chain: its staging loop waits on one global load per
// element before the next (1064 values over 256 threads, four round trips),
// and its 98-step tap loop is not unrolled, a shared-memory load feeding
// each dependent FMA. The tiled body has every staging load of a thread in
// flight at once and unrolls the taps of a row over a window in registers.
// In eval the real attention runs as a gate of its own, as the complex one
// does: a pooling pass (dcs_sa_pool_real, one read of x; the complex pool's
// kernel over one plane instead of two) and the (7, 2, 1) body with a
// sigmoid-and-product epilogue (dcs_sa_gate_real, one more read and one
// write of x), whose product spreads a tile's pixels over all 128 threads.
//
// Training at bf16 (the JAX _conv_fwd_pallas and _bwd at bf16 operands)
// runs the conv entry's bf16 class (dcs_conv_same_small_cout_bf16) at every
// tiled class on the tensor cores (conv7_mma_kernel): bf16 mma.sync
// m16n8k16 with float32 sums, the float32 bias added and y rounded once to
// bf16; the input gradient, class (7, 2, 4) or, for DR / DRS, (7, 1, 2), is
// the same entry on the bf16 gradient with the flipped, transposed kernel.
// The float32 SIMT body it replaced widened every bf16 operand and ran 49
// Cin Cout FMAs a pixel (392 at the complex classes) on the float32 pipes:
// at the 128 x 128 sites those alone take longer than the bytes. On the
// tensor cores the products are ~1% of the work, and what is left is bytes
// at the large sites (x once, y once: 12 bytes a pixel at the complex
// classes, 6 at the real) and launch latency at the small ones. So a block
// stages its tile with the 3-pixel halo once by cp.async (every copy in
// flight at once, zeros outside the image by a zero source size: no row of
// 16 bytes for a tensor copy to crawl through), builds the B table from w
// while the copies fly, and each warp walks its task's staged rows once,
// one staged row's A fragments serving every group of output rows it
// reaches. N = 8 holds Cout outputs x column x row shifts, never zero
// columns, and K the staged pixels x channels a thread's register holds:
// the class table at MmaClass. The fused gate's conv is the (7, 4, 2)
// instance of the same device function (mma_conv) with a sigmoid epilogue.
// Tiles (ops/cuda_conv.py:mma_tile): 16 x 64 at the 128 x 128 sites (1.5x
// staged per output), at most 8 rows at the others, where a launch's time
// is its latency: the launch, a block's one round trip to device memory,
// its table and a short chain of products.
//
// Serving DR / DRS at bf16 runs the real pool and gate's bf16 classes
// (dcs_sa_pool_real_bf16, dcs_sa_gate_real_bf16): the same two kernels over
// bf16 x (16-byte loads of 8 channels where C and the pointers allow), the
// pooled map and w bf16. They round where the JAX real spatial attention
// and widen.mul_bcast round: the mean once from float32 sums (the max is
// exact), the conv's float32 sums to bf16, the sigmoid of that to bf16, the
// product once. Like the float32 pair they are bound by the bytes of x, now
// half as many.
//
// Every other (K, Cin, Cout) takes the generic body below: one thread per
// output pixel on an 8 x 32 tile, input chunk and weights in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// generic body: any odd K <= 7, any Cin, Cout <= 16
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// the register-tiled body, classes (K, Cin, Cout) = (7, 4, 2), (7, 2, 4),
// (7, 2, 1) and (7, 1, 2)
// ---------------------------------------------------------------------------

constexpr int NT = 128;       // threads per block
constexpr int HALO = 6;       // K - 1
constexpr int TAPS = 49;      // K * K
constexpr int MAX_SMEM = 48 * 1024;

// slot of pixel p in a staged row: one slot of padding after every run, so
// that neighbouring threads' runs start R + 1 slots apart, an odd stride
template <int R>
__device__ __forceinline__ int slot(int p) { return p + p / R; }

// a pixel of C channels as one word: float4, float2 or float
template <int C>
struct Px;
template <>
struct Px<4> {
  using T = float4;
  static __device__ __forceinline__ float at(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ T make(const float* a) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <>
struct Px<2> {
  using T = float2;
  static __device__ __forceinline__ float at(const T& v, int i) {
    return i == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ T make(const float* a) {
    return make_float2(a[0], a[1]);
  }
};
template <>
struct Px<1> {
  using T = float;
  static __device__ __forceinline__ float at(const T& v, int) { return v; }
  static __device__ __forceinline__ T make(const float* a) { return a[0]; }
};

// the KW = Cin * Cout weights of one tap as N words of WORD floats: two
// float4 for the complex classes (8 weights), one float2 for the real ones
template <int KW>
struct TapWords {
  static constexpr int WORD = KW % 4 == 0 ? 4 : 2;
  static constexpr int N = KW / WORD;
  using T = typename Px<WORD>::T;
};

// word i of C values from global memory as Px<C>::T: float32 as it is; the
// bf16 class's pooled pixel (4 bf16, 8 bytes) and weight word widened to a
// float4, exactly
template <typename G, int C>
struct Load {
  static __device__ __forceinline__ typename Px<C>::T at(const G* p, long long i) {
    return reinterpret_cast<const typename Px<C>::T*>(p)[i];
  }
};
template <>
struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ float4 at(const __nv_bfloat16* p, long long i) {
    const uint2 u = reinterpret_cast<const uint2*>(p)[i];
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
template <>
struct Load<__nv_bfloat16, 2> {
  static __device__ __forceinline__ float2 at(const __nv_bfloat16* p, long long i) {
    return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
  }
};
template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ float at(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
};

struct Tile {
  int tx, ty;        // threads along W and H that take part in the conv
  int tw;            // R * tx, the tile's columns
  int pitch;         // pixel slots per staged row
  int cin, cout;     // channels a slot (float4, float2 or float) and a pixel out
  __host__ __device__ int rows() const { return ty + HALO; }
  __host__ __device__ int cols() const { return tw + HALO; }
  // float4s of dynamic shared memory: weights, staged tile, attention map
  // (cout floats a pixel)
  __host__ __device__ int weights4() const { return (TAPS * cin * cout + 3) / 4; }
  __host__ __device__ int staged4() const { return (rows() * pitch * cin + 3) / 4; }
  __host__ __device__ int smem4() const {
    return weights4() + staged4() + (ty * tw * cout + 3) / 4;
  }
};

// For 16-byte slots (Cin = 4) a quarter-warp's 8 loads go to 8 bank groups
// when 8 neighbouring threads' slots differ mod 8: the odd run stride does
// that within a row (a tile is at least 8 runs wide where it has 2 rows).
// For 8-byte slots (Cin = 2) a half-warp's 16 loads must differ mod 16, and
// a half-warp spans rows where the tile is fewer than 16 runs wide: thread
// (tx, ty), the ty * TX + tx-th, reads slot ty * pitch + tx * (R + 1) + j, so
// a pitch of TX * (R + 1) mod 16 makes that (ty * TX + tx) * (R + 1) mod 16,
// 16 different values for any 16 consecutive threads. For 4-byte slots
// (Cin = 1) a warp's 32 loads must differ mod 32: the same rule mod 32.
Tile make_tile(int R, int TX, int TY, int cin, int cout) {
  Tile t;
  t.tx = TX;
  t.ty = TY;
  t.tw = R * TX;
  t.cin = cin;
  t.cout = cout;
  t.pitch = t.tw + HALO + (t.tw + HALO - 1) / R;   // slot(cols - 1) + 1
  if (cin < 4) {
    const int banks = 32 / cin;
    t.pitch += ((TX * (R + 1) - t.pitch) % banks + banks) % banks;
  }
  return t;
}

// Stages the tile of x (B, H, W, CIN) at (b, h0, w0) and the weights, runs the
// 7 x 7 x CIN -> COUT taps for this thread's run of R pixels. Every thread of
// the block must call it (it holds the block barrier); acc is meaningful for
// threads with tid < t.tx * t.ty. Returns the attention-map region. G is the
// type of x and w in device memory: float, or bf16 for the complex gate's
// bf16 class, widened to float32 (exactly) as it is staged.
template <int R, int CIN, int COUT, typename G = float>
__device__ __forceinline__ float* conv7_tile(
    const G* __restrict__ x, const G* __restrict__ w, const Tile t,
    float4* smem, int b, int h0, int w0, int H, int W,
    float (&acc)[R][COUT]) {
  using P = Px<CIN>;
  using T = typename P::T;
  using TW = TapWords<CIN * COUT>;
  using WT = typename TW::T;
  constexpr int NWORDS = TAPS * TW::N;    // 98 float4 or 49 float2
  constexpr int W4 = (TAPS * CIN * COUT + 3) / 4;   // t.weights4()
  WT* ws = reinterpret_cast<WT*>(smem);
  T* xs = reinterpret_cast<T*>(smem + W4);
  const int tid = threadIdx.x;
  const int rows = t.rows(), cols = t.cols();
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  // every load of the block is in flight before the first store waits for
  // one: a thread's weight word, then its pixels four at a time
  WT wv = Px<TW::WORD>::make(zero);
  if (tid < NWORDS) wv = Load<G, TW::WORD>::at(w, tid);
  const G* xv = x + (long long)b * H * W * CIN;
  const int total = rows * cols;
  for (int e0 = tid; e0 < total; e0 += 4 * NT) {
    T v[4];
    int dst[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NT;
      const int row = e / cols, col = e - row * cols;
      const int hh = h0 - HALO / 2 + row, ww = w0 - HALO / 2 + col;
      v[u] = P::make(zero);
      dst[u] = row * t.pitch + slot<R>(col);
      if (e < total && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v[u] = Load<G, CIN>::at(xv, (long long)hh * W + ww);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * NT < total) xs[dst[u]] = v[u];
  }
  if (tid < NWORDS) ws[tid] = wv;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[r][co] = 0.f;
  if (tid < t.tx * t.ty) {
    const int ty = tid / t.tx, tx = tid - ty * t.tx;
    int sl[R + HALO];
#pragma unroll
    for (int j = 0; j < R + HALO; ++j) sl[j] = slot<R>(tx * R + j);
    const T* base = xs + ty * t.pitch;
#pragma unroll 1
    for (int kh = 0; kh < 7; ++kh) {
      const T* row = base + kh * t.pitch;
      T win[R + HALO];
#pragma unroll
      for (int j = 0; j < R + HALO; ++j) win[j] = row[sl[j]];
      const WT* wk = ws + kh * 7 * TW::N;
#pragma unroll
      for (int kw = 0; kw < 7; ++kw) {
        // the tap's weights w[kh][kw][ci][co], ci-major, as broadcast words
        float wt[CIN * COUT];
#pragma unroll
        for (int i = 0; i < TW::N; ++i) {
          const WT word = wk[kw * TW::N + i];
#pragma unroll
          for (int j = 0; j < TW::WORD; ++j)
            wt[i * TW::WORD + j] = Px<TW::WORD>::at(word, j);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T v = win[r + kw];
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[r][co] = fmaf(P::at(v, ci), wt[ci * COUT + co], acc[r][co]);
        }
      }
    }
  }
  return reinterpret_cast<float*>(smem + W4 + t.staged4());
}

template <int R, int CIN, int COUT>
__global__ void __launch_bounds__(NT)
conv7_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y,
             const Tile t, int H, int W) {
  using Q = Px<COUT>;
  using T = typename Q::T;
  extern __shared__ float4 smem[];
  const int b = blockIdx.z, h0 = blockIdx.y * t.ty, w0 = blockIdx.x * t.tw;
  const int tid = threadIdx.x;
  float acc[R][COUT];
  T* att = reinterpret_cast<T*>(
      conv7_tile<R, CIN, COUT>(x, w, t, smem, b, h0, w0, H, W, acc));
  if (tid < t.tx * t.ty) {
    const int ty = tid / t.tx, tx = tid - ty * t.tx;
    float bv[COUT];
#pragma unroll
    for (int co = 0; co < COUT; ++co) bv[co] = bias[co];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float o[COUT];
#pragma unroll
      for (int co = 0; co < COUT; ++co) o[co] = acc[r][co] + bv[co];
      att[ty * t.tw + tx * R + r] = Q::make(o);
    }
  }
  __syncthreads();
  T* yv = reinterpret_cast<T*>(y) + (long long)b * H * W;
  for (int e = tid; e < t.ty * t.tw; e += NT) {
    const int row = e / t.tw, col = e - row * t.tw;
    const int hh = h0 + row, ww = w0 + col;
    if (hh < H && ww < W) yv[(long long)hh * W + ww] = att[e];
  }
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// eight bf16 (16 bytes) widened to float32, and eight float32 rounded to bf16
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// out = x * sigmoid(conv(pooled)); vec: C % 4 == 0 and every x pointer is
// 16-byte aligned; shift: log2(C / 4) where that is a power of two, else -1.
// G = bf16: the bf16 class (pooled, w, x and out bf16): the conv, the sigmoid
// and the product in float32 on the widened values, each output rounded
// once; vec then asks C % 8 == 0 (16 bytes, 8 channels a word) and shift is
// log2(C / 8).
template <int R, typename G = float>
__global__ void __launch_bounds__(NT)
sa_gate_kernel(const G* __restrict__ pooled, const G* __restrict__ w,
               const G* __restrict__ re, const G* __restrict__ im,
               G* __restrict__ out_re, G* __restrict__ out_im,
               const Tile t, int H, int W, int C, int vec, int shift) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.z, h0 = blockIdx.y * t.ty, w0 = blockIdx.x * t.tw;
  const int tid = threadIdx.x;
  float acc[R][2];
  float2* att = reinterpret_cast<float2*>(
      conv7_tile<R, 4, 2, G>(pooled, w, t, smem, b, h0, w0, H, W, acc));
  if (tid < t.tx * t.ty) {
    const int ty = tid / t.tx, tx = tid - ty * t.tx;
#pragma unroll
    for (int r = 0; r < R; ++r)
      att[ty * t.tw + tx * R + r] =
          make_float2(sigmoidf(acc[r][0]), sigmoidf(acc[r][1]));
  }
  __syncthreads();

  const int rows_v = min(t.ty, H - h0), cols_v = min(t.tw, W - w0);
  const int warp = tid >> 5, lane = tid & 31;
  for (int row = warp; row < rows_v; row += NT / 32) {
    const long long pix0 = ((long long)b * H + h0 + row) * W + w0;
    const float2* arow = att + row * t.tw;
    if constexpr (!std::is_same<G, float>::value) {
      if (vec) {
        const int nv = C >> 3, n = cols_v * nv;
        const uint4* r8 = reinterpret_cast<const uint4*>(re) + pix0 * nv;
        const uint4* i8 = reinterpret_cast<const uint4*>(im) + pix0 * nv;
        uint4* o_r = reinterpret_cast<uint4*>(out_re) + pix0 * nv;
        uint4* o_i = reinterpret_cast<uint4*>(out_im) + pix0 * nv;
#pragma unroll 2
        for (int i = lane; i < n; i += 32) {
          const float2 a = arow[shift >= 0 ? i >> shift : i / nv];
          float xr[8], xi[8], yr[8], yi[8];
          unpack8(r8[i], xr);
          unpack8(i8[i], xi);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            yr[k] = xr[k] * a.x - xi[k] * a.y;
            yi[k] = xr[k] * a.y + xi[k] * a.x;
          }
          o_r[i] = pack8(yr);
          o_i[i] = pack8(yi);
        }
      } else {
        const int n = cols_v * C;
        for (int i = lane; i < n; i += 32) {
          const float2 a = arow[i / C];
          const float xr = __bfloat162float(re[pix0 * C + i]);
          const float xi = __bfloat162float(im[pix0 * C + i]);
          out_re[pix0 * C + i] = __float2bfloat16_rn(xr * a.x - xi * a.y);
          out_im[pix0 * C + i] = __float2bfloat16_rn(xr * a.y + xi * a.x);
        }
      }
    } else if (vec) {
      const int nv = C >> 2, n = cols_v * nv;
      const float4* r4 = reinterpret_cast<const float4*>(re) + pix0 * nv;
      const float4* i4 = reinterpret_cast<const float4*>(im) + pix0 * nv;
      float4* o_r = reinterpret_cast<float4*>(out_re) + pix0 * nv;
      float4* o_i = reinterpret_cast<float4*>(out_im) + pix0 * nv;
#pragma unroll 4
      for (int i = lane; i < n; i += 32) {
        const float2 a = arow[shift >= 0 ? i >> shift : i / nv];
        const float4 xr = r4[i], xi = i4[i];
        o_r[i] = make_float4(xr.x * a.x - xi.x * a.y, xr.y * a.x - xi.y * a.y,
                             xr.z * a.x - xi.z * a.y, xr.w * a.x - xi.w * a.y);
        o_i[i] = make_float4(xr.x * a.y + xi.x * a.x, xr.y * a.y + xi.y * a.x,
                             xr.z * a.y + xi.z * a.x, xr.w * a.y + xi.w * a.x);
      }
    } else {
      const int n = cols_v * C;
      const float* r1 = re + pix0 * C;
      const float* i1 = im + pix0 * C;
      float* o_r = out_re + pix0 * C;
      float* o_i = out_im + pix0 * C;
      for (int i = lane; i < n; i += 32) {
        const float2 a = arow[i / C];
        const float xr = r1[i], xi = i1[i];
        o_r[i] = xr * a.x - xi * a.y;
        o_i[i] = xr * a.y + xi * a.x;
      }
    }
  }
}

// pooled[p] = (mean_c, max_c) of each of the NP planes of pixel p: (mean re,
// max re, mean im, max im) for the complex gate (NP = 2, a float4), (mean,
// max) for the real (NP = 1, a float2). NG = 2^lg lanes share a pixel, each
// striding over the channels (as float4 when vec) and loading every plane in
// one step; a shuffle tree inside the NG lanes combines them.
// G = bf16: the bf16 class (the complex gate's, NP = 2, and the real's, NP
// = 1): bf16 planes (vec: 8 channels a 16-byte load), the sums in float32,
// the mean rounded once to bf16 and the max exact; pooled (B, H, W, 2 NP)
// bf16.
template <int NP, typename G = float>
__global__ void __launch_bounds__(256)
sa_pool_kernel(const G* __restrict__ p0, const G* __restrict__ p1,
               G* __restrict__ pooled, long long P, int C, int lg,
               int vec) {
  const G* plane[2] = {p0, p1};
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long pix = gt >> lg;
  const int NG = 1 << lg, lane = (int)(gt & (NG - 1));
  float s[NP], m[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) s[q] = 0.f, m[q] = -INFINITY;
  if constexpr (!std::is_same<G, float>::value) {
    if (pix < P) {
      if (vec) {
        for (int i = lane; i < (C >> 3); i += NG) {
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            float a[8];
            unpack8(__ldg(reinterpret_cast<const uint4*>(plane[q] + pix * C) + i), a);
            s[q] += ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
            m[q] = fmaxf(m[q], fmaxf(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])),
                                     fmaxf(fmaxf(a[4], a[5]), fmaxf(a[6], a[7]))));
          }
        }
      } else {
        for (int i = lane; i < C; i += NG) {
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            const float a = __bfloat162float(plane[q][pix * C + i]);
            s[q] += a;
            m[q] = fmaxf(m[q], a);
          }
        }
      }
    }
  } else if (pix < P) {
    if (vec) {
      for (int i = lane; i < (C >> 2); i += NG) {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(plane[q] + pix * C) + i);
          s[q] += (a.x + a.y) + (a.z + a.w);
          m[q] = fmaxf(m[q], fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
        }
      }
    } else {
      for (int i = lane; i < C; i += NG) {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const float a = __ldg(plane[q] + pix * C + i);
          s[q] += a;
          m[q] = fmaxf(m[q], a);
        }
      }
    }
  }
  for (int o = NG >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
      m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
    }
  }
  if (pix < P && lane == 0) {
    if constexpr (!std::is_same<G, float>::value && NP == 1) {
      // (mean, max) as a bf16 pair, 4 bytes
      reinterpret_cast<__nv_bfloat162*>(pooled)[pix] =
          __floats2bfloat162_rn(s[0] / (float)C, m[0]);
    } else if constexpr (!std::is_same<G, float>::value) {
      // NP = 2: (mean re, max re, mean im, max im) as four bf16, 8 bytes
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s[0] / (float)C, m[0]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[NP - 1] / (float)C, m[NP - 1]);
      reinterpret_cast<uint2*>(pooled)[pix] =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else if constexpr (NP == 2)
      reinterpret_cast<float4*>(pooled)[pix] =
          make_float4(s[0] / (float)C, m[0], s[1] / (float)C, m[1]);
    else
      reinterpret_cast<float2*>(pooled)[pix] = make_float2(s[0] / (float)C, m[0]);
  }
}

// out = x * sigmoid(conv(pooled)) for the real attention: the (7, 2, 1) body
// over pooled (B, H, W, 2), the one-channel map broadcast over C. vec: C % 4
// == 0 and x, out 16-byte aligned; shift: log2 of a pixel's words (C / 4 or
// C) where that is a power of two, else -1. The tile's rows_v x cols_v pixels
// are spread over all 128 threads: a warp a row would leave three warps
// idle on the one-row tiles of the small images, which carry the most
// channels. G = bf16: the bf16 class (pooled, w, x and out bf16): the conv's
// float32 sums rounded to bf16, the sigmoid of that rounded to bf16, the
// product in float32 rounded once; vec then asks C % 8 == 0 (8 channels a
// 16-byte word) and shift is log2(C / 8) (or of C).
template <int R, typename G = float>
__global__ void __launch_bounds__(NT)
sa_gate_real_kernel(const G* __restrict__ pooled,
                    const G* __restrict__ w, const G* __restrict__ x,
                    G* __restrict__ out, const Tile t, int H, int W, int C,
                    int vec, int shift) {
  constexpr bool F32 = std::is_same<G, float>::value;
  extern __shared__ float4 smem[];
  const int b = blockIdx.z, h0 = blockIdx.y * t.ty, w0 = blockIdx.x * t.tw;
  const int tid = threadIdx.x;
  float acc[R][1];
  float* att = conv7_tile<R, 2, 1, G>(pooled, w, t, smem, b, h0, w0, H, W, acc);
  if (tid < t.tx * t.ty) {
    const int ty = tid / t.tx, tx = tid - ty * t.tx;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (F32)
        att[ty * t.tw + tx * R + r] = sigmoidf(acc[r][0]);
      else
        att[ty * t.tw + tx * R + r] = __bfloat162float(__float2bfloat16_rn(
            sigmoidf(__bfloat162float(__float2bfloat16_rn(acc[r][0])))));
    }
  }
  __syncthreads();

  const int rows_v = min(t.ty, H - h0), cols_v = min(t.tw, W - w0);
  const int nv = vec ? C >> (F32 ? 2 : 3) : C;   // words a pixel
  const int n = cols_v * nv;             // words of a tile row, contiguous
  const long long pix0 = ((long long)b * H + h0) * W + w0;
#pragma unroll 4
  for (int e = tid; e < rows_v * n; e += NT) {
    const int row = e / n, i = e - row * n;
    const float a = att[row * t.tw + (shift >= 0 ? i >> shift : i / nv)];
    const long long k = (pix0 + (long long)row * W) * nv + i;
    if (vec) {
      if constexpr (F32) {
        const float4 v = reinterpret_cast<const float4*>(x)[k];
        reinterpret_cast<float4*>(out)[k] =
            make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
      } else {
        float f[8];
        unpack8(reinterpret_cast<const uint4*>(x)[k], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] *= a;
        reinterpret_cast<uint4*>(out)[k] = pack8(f);
      }
    } else {
      if constexpr (F32)
        out[k] = x[k] * a;
      else
        out[k] = __float2bfloat16_rn(__bfloat162float(x[k]) * a);
    }
  }
}

__global__ void empty_kernel() {}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// R in {2, 4}, and 8 at the real classes (2 weights a tap)
bool tile_ok(int R, int TX, int TY, int cin, int cout) {
  const bool r_ok = R == 2 || R == 4 || (R == 8 && cin * cout == 2);
  if (!r_ok || TX < 1 || TY < 1 || TX * TY > NT) return false;
  return make_tile(R, TX, TY, cin, cout).smem4() * 16 <= MAX_SMEM;
}

// the tiled classes: (K, Cin, Cout) = (7, 4, 2), (7, 2, 4), (7, 2, 1), (7, 1, 2)
bool tiled_class(int K, int cin, int cout) {
  return K == 7 && ((cin == 4 && cout == 2) || (cin == 2 && cout == 4) ||
                    (cin == 2 && cout == 1) || (cin == 1 && cout == 2));
}

// the word in which the tiled body reads a tap's weights: 16 or 8 bytes
int tap_word_bytes(int cin, int cout) { return (cin * cout) % 4 == 0 ? 16 : 8; }

template <int CIN, int COUT>
void launch_conv7(int R, dim3 grid, int smem, cudaStream_t s, const float* x,
                  const float* w, const float* bias, float* y, const Tile& t,
                  int H, int W) {
  if (R == 2)
    conv7_kernel<2, CIN, COUT><<<grid, NT, smem, s>>>(x, w, bias, y, t, H, W);
  else if (CIN * COUT != 2 || R == 4)
    conv7_kernel<4, CIN, COUT><<<grid, NT, smem, s>>>(x, w, bias, y, t, H, W);
  else if constexpr (CIN * COUT == 2)
    conv7_kernel<8, CIN, COUT><<<grid, NT, smem, s>>>(x, w, bias, y, t, H, W);
}

// log2(n) where n is a power of two, else -1
int log2_exact(int n) {
  for (int k = 0; k < 31; ++k)
    if (n == (1 << k)) return k;
  return -1;
}

bool image_ok(int B, int H, int W) {
  return B >= 1 && B <= 65535 && H >= 1 && W >= 1;
}

dim3 tile_grid(const Tile& t, int B, int H, int W) {
  return dim3((W + t.tw - 1) / t.tw, (H + t.ty - 1) / t.ty, B);
}

// sa_pool_kernel<NP, G> over the B H W pixels of p0 (and p1), pooled aligned
// to its word: NG lanes a pixel, the least power of two >= the pixel's loads,
// at most a warp.
template <int NP, typename G = float>
int launch_pool(const G* p0, const G* p1, G* pooled, int B, int H, int W, int C,
                void* stream) {
  constexpr int V = 16 / sizeof(G);   // channels a 16-byte load
  if (!image_ok(B, H, W) || C < 1 || !aligned(pooled, 2 * NP * sizeof(G)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = C % V == 0 && aligned(p0, 16) && (NP == 1 || aligned(p1, 16));
  const int steps = vec ? C / V : C;
  int lg = 0;
  while ((1 << lg) < 32 && (1 << lg) < steps) ++lg;
  const long long P = (long long)B * H * W;
  const long long blocks = ((P << lg) + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  sa_pool_kernel<NP, G><<<(unsigned)blocks, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(p0, p1, pooled, P,
                                                               C, lg, vec);
  return static_cast<int>(cudaGetLastError());
}

// the complex gate over float32 or (G = bf16) bf16 tensors: pooled and w
// aligned to their words (16 or 8 bytes); x's product 16 bytes a load where
// C and the pointers allow (4 floats, 8 bf16)
template <typename G>
int launch_gate(const G* pooled, const G* w, const G* re, const G* im, G* out_re,
                G* out_im, int B, int H, int W, int C, int R, int TX, int TY,
                void* stream) {
  constexpr int word = 4 * sizeof(G), V = 16 / sizeof(G);
  if (!image_ok(B, H, W) || C < 1 || !tile_ok(R, TX, TY, 4, 2) ||
      !aligned(pooled, word) || !aligned(w, word))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = make_tile(R, TX, TY, 4, 2);
  const dim3 grid = tile_grid(t, B, H, W);
  const int smem = t.smem4() * 16;
  const int vec = C % V == 0 && aligned(re, 16) && aligned(im, 16) &&
                  aligned(out_re, 16) && aligned(out_im, 16);
  const int shift = vec ? log2_exact(C / V) : -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 2)
    sa_gate_kernel<2, G><<<grid, NT, smem, s>>>(pooled, w, re, im, out_re, out_im,
                                                t, H, W, C, vec, shift);
  else
    sa_gate_kernel<4, G><<<grid, NT, smem, s>>>(pooled, w, re, im, out_re, out_im,
                                                t, H, W, C, vec, shift);
  return static_cast<int>(cudaGetLastError());
}

// the real gate over float32 or (G = bf16) bf16 tensors: pooled and w
// aligned to their words (8 or 4 bytes); x's product 16 bytes a load where C
// and the pointers allow (4 floats, 8 bf16)
template <typename G>
int launch_gate_real(const G* pooled, const G* w, const G* x, G* out, int B, int H,
                     int W, int C, int R, int TX, int TY, void* stream) {
  constexpr int word = 2 * sizeof(G), V = 16 / sizeof(G);
  if (!image_ok(B, H, W) || C < 1 || !tile_ok(R, TX, TY, 2, 1) ||
      !aligned(pooled, word) || !aligned(w, word))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = make_tile(R, TX, TY, 2, 1);
  const dim3 grid = tile_grid(t, B, H, W);
  const int smem = t.smem4() * 16;
  const int vec = C % V == 0 && aligned(x, 16) && aligned(out, 16);
  const int shift = log2_exact(vec ? C / V : C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 2)
    sa_gate_real_kernel<2, G><<<grid, NT, smem, s>>>(pooled, w, x, out, t, H, W, C, vec,
                                                     shift);
  else if (R == 4)
    sa_gate_real_kernel<4, G><<<grid, NT, smem, s>>>(pooled, w, x, out, t, H, W, C, vec,
                                                     shift);
  else
    sa_gate_real_kernel<8, G><<<grid, NT, smem, s>>>(pooled, w, x, out, t, H, W, C, vec,
                                                     shift);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the 7 x 7 conv at bf16 on tensor cores: the fused gate's conv (class
// (7, 4, 2)) and the conv entry's bf16 class at every tiled class
// ---------------------------------------------------------------------------

constexpr int SMEM_LIMIT = 232448;         // 227 KB, a block's most on the H100

// d (16 x 8, float32) += a (16 x 16 bf16, row-major fragments) b (16 x 8
// bf16, column-major fragments)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The products of class (7, CIN, COUT) on mma m16n8k16 (mma_conv). N = 8 is
// COUT outputs x SC column shifts x SR row shifts, n = (dy SC + s) COUT +
// co: no column is dead. M row m of a product is tile column c0 + SC m, so
// its 16 rows span 16 SC columns and the shifts fill the columns between.
// K = 16 is staged pixels x CIN channels, in the order that makes a
// thread's A register one staged word: at CIN 4 a step is 4 pixels x 4
// channels (two steps cover the 8 pixels under SC = 2 shifts of 7 taps);
// at CIN 2 one step is 8 pixels x 2 channels (the 7 taps and one shift);
// at CIN 1 one step is 16 pixels (the 7 taps and 3 shifts; two pixels a
// 4-byte word). The staged tile is th + 6 rows of words from LEAD columns
// left of the tile: LEAD = 4 at CIN 1, so that a word's two pixels start
// at an even column. One staged row feeds a group of SR tile rows at D = 6
// + SR row offsets d, each product of (row, step) serving every group whose
// offset it reaches.
//
//   class        A word          N = 8                  products a pixel
//   (7, 4, 2)    8-byte pixel    2 out x 2 col x 2 row  0.25
//   (7, 2, 4)    4-byte pixel    4 out x 2 col          0.22
//   (7, 2, 1)    4-byte pixel    1 out x 2 col x 4 row  0.08
//   (7, 1, 2)    2 pixels        2 out x 4 col          0.11
template <int CIN, int COUT>
struct MmaClass {
  static constexpr int SC = CIN == 1 ? 4 : 2;      // column shifts
  static constexpr int SR = 8 / (COUT * SC);       // row shifts
  static constexpr int U = CIN == 4 ? 2 : 1;       // k16 steps a staged row
  static constexpr int D = 6 + SR;                 // row offsets of a group
  static constexpr int LEAD = CIN == 1 ? 4 : 3;    // staged columns left of the tile
  static constexpr int SPAN = 16 * SC;             // tile columns of a product's M rows
  static constexpr int PX = CIN == 1 ? 2 : 1;      // pixels a staged word
  static constexpr int WIN = U * 16 / CIN;         // staged pixels a product's row reads
  static constexpr int WORDS = D * U * 2;          // B registers a lane
  using Word = typename std::conditional<CIN == 4, uint2, uint32_t>::type;
};

// The B table of the products, built once a block from w (7, 7, CIN, COUT)
// as it lies: word e (< 32 WORDS) is lane l = e % 32's register r = (e /
// 32) % 2 of step u = (e / 64) % U at row offset d = e / (64 U). Lane (gid,
// tig) holds column n = gid and, in register r, k = 2 tig + 8 r + {0, 1}:
// staged pixel (slot) 4 u + tig, channels 2 r + {0, 1} at CIN 4; slot tig
// + 4 r, channels {0, 1} at CIN 2; slots 2 tig + 8 r + {0, 1} at CIN 1.
// Column n is output co = n % COUT of the tile pixel dy rows down and s
// columns right, n / COUT = dy SC + s. The value is w[kh][kw][ci][co] at kh
// = d - dy, kw = slot - s - (LEAD - 3), 0 outside the kernel. Gives the
// offsets into w of the word's two bf16 halves (k even, k odd), -1 for a 0.
template <int CIN, int COUT>
__device__ __forceinline__ void mma_b_taps(int e, int& lo, int& hi) {
  using M = MmaClass<CIN, COUT>;
  const int l = e & 31, r = (e >> 5) & 1, su = e >> 6, u = su % M::U, d = su / M::U;
  const int n = l >> 2, t = l & 3, co = n % COUT, q = n / COUT;
  const int s = q % M::SC, kh = d - q / M::SC;
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = CIN == 4 ? 4 * u + t : CIN == 2 ? t + 4 * r : 2 * t + 8 * r + h;
    const int ci = CIN == 4 ? 2 * r + h : CIN == 2 ? h : 0;
    const int kw = slot - s - (M::LEAD - 3);
    off[h] = kh >= 0 && kh < 7 && kw >= 0 && kw < 7 ? ((kh * 7 + kw) * CIN + ci) * COUT + co
                                                    : -1;
  }
  lo = off[0];
  hi = off[1];
}

// The conv of a staged tile on tensor cores (class (7, CIN, COUT), see
// MmaClass), shared by the fused gate and the conv entry: map holds th + 6
// rows of `pitch` words, row i image row h0 - 3 + i, from LEAD columns left
// of the tile, zero outside the image; bf is the lane's WORDS B registers
// (the table's words l, l + 32, ...). One warp a task: SPAN tile columns of
// RB tile rows (RB / SR groups). The task walks the RB + 6 staged rows under
// them once, loading each row's A fragments (4 loads a step) and applying
// them to every group it reaches (0 <= d < D): a staged word leaves shared
// memory (RB + 6) / RB times a task. A load's 16 M rows x 4 threads read
// consecutive words: no bank conflict. Consecutive products go to
// different groups' sums. M rows past cmax (the tile's last column, or its
// last product column) are computed on it and dropped by the epilogue;
// rows past the map on its last row, feeding only tile rows past the tile.
// epi(r, c, acc) takes each group's sums: tile row r (the group's first),
// the lane's M row gid at tile column c and gid + 8 at c + 8 SC; acc[0],
// acc[1] are its columns n = 2 tig + {0, 1} of row gid, acc[2], acc[3] of
// row gid + 8.
template <int CIN, int COUT, int RB, typename Epi>
__device__ __forceinline__ void mma_conv(
    const typename MmaClass<CIN, COUT>::Word* __restrict__ map, int pitch, int th, int tw,
    int cmax, const uint32_t (&bf)[MmaClass<CIN, COUT>::WORDS], int warp, int nwarps,
    int lane, Epi&& epi) {
  using M = MmaClass<CIN, COUT>;
  static_assert(RB % M::SR == 0, "a task holds whole groups");
  constexpr int NG = RB / M::SR;
  const int gid = lane >> 2, tig = lane & 3;
  const int nct = (tw + M::SPAN - 1) / M::SPAN, tasks = nct * ((th + RB - 1) / RB);
  for (int task = warp; task < tasks; task += nwarps) {
    const int q = task / nct, c0 = (task - q * nct) * M::SPAN + M::SC * gid, r0 = q * RB;
    const int ca = min(c0, cmax) / M::PX, cb = min(c0 + 8 * M::SC, cmax) / M::PX;
    float acc[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < RB + 6; ++i) {
      const typename M::Word* p = map + min(r0 + i, th + 5) * pitch + tig;
      uint32_t a[M::U][4];
      if constexpr (CIN == 4) {
        // a pixel's channels (0, 1) and (2, 3) are a thread's k = 2 tig +
        // {0, 1} and 2 tig + 8 + {0, 1}
        const uint2 a0 = p[ca], a1 = p[cb], a2 = p[ca + 4], a3 = p[cb + 4];
        a[0][0] = a0.x, a[0][1] = a1.x, a[0][2] = a0.y, a[0][3] = a1.y;
        a[M::U - 1][0] = a2.x, a[M::U - 1][1] = a3.x, a[M::U - 1][2] = a2.y;
        a[M::U - 1][3] = a3.y;
      } else {
        a[0][0] = p[ca], a[0][1] = p[cb], a[0][2] = p[ca + 4], a[0][3] = p[cb + 4];
      }
#pragma unroll
      for (int u = 0; u < M::U; ++u)
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int d = i - M::SR * j;
          if (d >= 0 && d < M::D)
            mma_16816(acc[j], a[u][0], a[u][1], a[u][2], a[u][3], bf[(d * M::U + u) * 2],
                      bf[(d * M::U + u) * 2 + 1]);
        }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) epi(r0 + M::SR * j, c0, acc[j]);
  }
}

// cp.async of BYTES (4 or 8) from device memory to shared memory; where !in,
// BYTES zeros and src is not read
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(BYTES), "r"(in ? BYTES : 0)
               : "memory");
}

// One launch of the conv entry's bf16 class (ops/cuda_conv.py:mma_geometry
// states the same rule): a block a tile of th x tw pixels of one image at
// (blockIdx.y th, blockIdx.x tw), tw a multiple of SPAN; its staged tile th
// + 6 rows of pitch = (tw + WIN - SC) / PX words.
struct MGeo {
  int H, W;
  int th, tw;
  int pitch;
};

// y = bias + conv(x, w) at class (7, CIN, COUT): x (B, H, W, CIN), w (7, 7,
// CIN, COUT) and y bf16, bias float32; the products in float32 on tensor
// cores (mma_conv), the bias added in float32, each output rounded once.
// The block: every staging copy of its tile in flight at once (cp.async,
// one word a copy, zeros outside the image by a zero source size; at CIN 1
// a pair that the image's edge splits, or that lies off 4 bytes at odd W,
// by two loads); the B table built from w while they fly; the products, RB
// tile rows a warp's task; the epilogue from registers: a lane's two sums
// of an M row are a bf16 pair, one 4-byte store (a whole pixel at COUT 2,
// half of one at COUT 4, two neighbouring pixels at COUT 1), a warp's
// stores covering whole runs of a tile row.
template <int CIN, int COUT, int RB>
__global__ void __launch_bounds__(NT)
conv7_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                 const MGeo g) {
  using M = MmaClass<CIN, COUT>;
  using Word = typename M::Word;
  constexpr int TABLE = M::WORDS * 32, PER = (TABLE + NT - 1) / NT;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  uint32_t* bt = reinterpret_cast<uint32_t*>(mma_smem);
  Word* map = reinterpret_cast<Word*>(mma_smem + TABLE * 4);
  const int b = blockIdx.z, h0 = blockIdx.y * g.th, w0 = blockIdx.x * g.tw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, tig = lane & 3;

  const __nv_bfloat16* xb = x + (long long)b * g.H * g.W * CIN;
  const int nwords = (g.th + 6) * g.pitch;
  for (int e = tid; e < nwords; e += NT) {
    const int i = e / g.pitch, j = e - i * g.pitch;
    const int hh = h0 - 3 + i, ww = w0 - M::LEAD + j * M::PX;
    const bool row_in = hh >= 0 && hh < g.H;
    const long long p = (long long)hh * g.W + ww;
    const uint32_t dst = smem_u32(map + e);
    if constexpr (CIN != 1) {
      const bool in = row_in && ww >= 0 && ww < g.W;
      cp_async_zfill<sizeof(Word)>(dst, in ? xb + p * CIN : x, in);
    } else {
      const bool in0 = row_in && ww >= 0 && ww < g.W;
      const bool in1 = row_in && ww + 1 >= 0 && ww + 1 < g.W;
      if (in0 == in1 && (!in0 || (reinterpret_cast<uintptr_t>(xb + p) & 3) == 0)) {
        cp_async_zfill<4>(dst, in0 ? xb + p : x, in0);
      } else {
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
        map[e] = (in0 ? xs[p] : 0u) | (static_cast<uint32_t>(in1 ? xs[p + 1] : 0u) << 16);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // the B table's halves, every load in flight before the first store
  const unsigned short* wh = reinterpret_cast<const unsigned short*>(w);
  unsigned short wlo[PER], whi[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    int lo = -1, hi = -1;
    if (tid + q * NT < TABLE) mma_b_taps<CIN, COUT>(tid + q * NT, lo, hi);
    wlo[q] = lo >= 0 ? wh[lo] : 0;
    whi[q] = hi >= 0 ? wh[hi] : 0;
  }
  float bv[4];
#pragma unroll
  for (int co = 0; co < 4; ++co) bv[co] = co < COUT ? bias[co] : 0.f;
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if (tid + q * NT < TABLE) bt[tid + q * NT] = wlo[q] | (static_cast<uint32_t>(whi[q]) << 16);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  uint32_t bf[M::WORDS];
#pragma unroll
  for (int i = 0; i < M::WORDS; ++i) bf[i] = bt[i * 32 + lane];
  const int rows_v = min(g.th, g.H - h0), cols_v = min(g.tw, g.W - w0);
  __nv_bfloat16* yb = y + ((long long)b * g.H + h0) * g.W * COUT;
  // the lane's columns n = 2 tig + {0, 1}: at COUT 2 tile pixel (dy, s) =
  // divmod(tig, SC), outputs 0 and 1; at COUT 4 pixel (0, tig / 2), outputs
  // 2 (tig % 2) + {0, 1}; at COUT 1 pixels (tig, 0) and (tig, 1), output 0
  const int dy = COUT == 1 ? tig : COUT == 2 ? tig / M::SC : 0;
  const int s = COUT == 2 ? tig % M::SC : COUT == 4 ? tig >> 1 : 0;
  const int ch = COUT == 4 ? 2 * (tig & 1) : 0;
  const float b0 = COUT == 1 ? bv[0] : (tig & 1) && COUT == 4 ? bv[2] : bv[0];
  const float b1 = COUT == 1 ? bv[0] : (tig & 1) && COUT == 4 ? bv[3] : bv[1];
  mma_conv<CIN, COUT, RB>(
      map, g.pitch, g.th, g.tw, g.tw - M::SC, bf, warp, NT / 32, lane,
      [&](int r, int c, const float (&acc)[4]) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r + dy, col = c + half * 8 * M::SC + s;
          if (row >= rows_v || col >= cols_v) continue;
          __nv_bfloat16* dst = yb + ((long long)row * g.W + w0 + col) * COUT + ch;
          const float v0 = acc[2 * half] + b0, v1 = acc[2 * half + 1] + b1;
          if (COUT > 1 ||
              (col + 1 < cols_v && (reinterpret_cast<uintptr_t>(dst) & 3) == 0)) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (col + 1 < cols_v) dst[1] = __float2bfloat16_rn(v1);
          }
        }
      });
}

// shared memory of one block: the B table, then the staged tile
template <int CIN, int COUT>
int mma_smem_bytes(const MGeo& g) {
  using M = MmaClass<CIN, COUT>;
  return M::WORDS * 32 * 4 + (g.th + 6) * g.pitch * static_cast<int>(sizeof(typename M::Word));
}

// the conv entry's bf16 class at (7, CIN, COUT) on a tile of th x tw, RB
// tile rows a task: tw a positive multiple of SPAN, RB in {2, 4, 8} and a
// multiple of SR, a block's shared memory within 227 KB. The dynamic
// shared-memory attribute is set at every launch.
template <int CIN, int COUT>
int launch_conv_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                    __nv_bfloat16* y, int B, int H, int W, int th, int tw, int rb,
                    cudaStream_t s) {
  using M = MmaClass<CIN, COUT>;
  if (th < 1 || tw < M::SPAN || tw % M::SPAN || rb % M::SR ||
      (rb != 2 && rb != 4 && rb != 8) || (H + th - 1) / th > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const MGeo g{H, W, th, tw, (tw + M::WIN - M::SC) / M::PX};
  const int smem = mma_smem_bytes<CIN, COUT>(g);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const float*, __nv_bfloat16*,
                 const MGeo) = conv7_mma_kernel<CIN, COUT, 8>;
  if (rb == 4) kernel = conv7_mma_kernel<CIN, COUT, 4>;
  if constexpr (M::SR <= 2)
    if (rb == 2) kernel = conv7_mma_kernel<CIN, COUT, 2>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  kernel<<<grid, NT, smem, s>>>(x, w, bias, y, g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the fused bf16 gate: pool, the conv on tensor cores, sigmoid and product,
// one launch a site
// ---------------------------------------------------------------------------

constexpr int FT = 256;                    // threads of a fused-gate block
constexpr int FUSED_BT = MmaClass<4, 2>::WORDS * 32;   // the conv's B table: words a block

// One launch's geometry (ops/cuda_conv.py:fused_geometry states the same
// rule). A block owns a tile of th x tw pixels of one image at (h0, w0) =
// (blockIdx.y th, blockIdx.x tw). Its two tensor copies bring a box of br x
// bc pixels, all C channels, of each plane: br = min(th + 6, H), bc =
// min(tw + 6, W), the corner clamped into the image, so that the box lies in
// the image and holds every image pixel of the tile and of its 3-pixel halo.
// Where a box row is at most 256 channels (bc C <= 256: the C = 8 and 16
// sites' tiles) the copy sees a plane as (W C, H, B) and moves rows of bc C
// channels, up to 512 bytes (flat); else as (C, W, H, B), rows of C. Either
// way the box lands in shared memory as [br][bc][C]. The pooled map has th
// + 6 rows of pp = tw + 8 pixels: map pixel (i, j) is image pixel (h0 - 3 +
// i, w0 - 3 + j), 0 outside the image (the conv's zero padding, which is
// also what pooling a zero-filled pixel gives) and in its last two columns
// (read only by the 8th tap, whose weight is 0). vshift is log2(C / 8)
// where that is a power of two, else -1.
struct FGeo {
  int H, W, C;
  int th, tw;
  int br, bc;
  int pp;
  int vshift;
  int flat;
};

// one plane's box in shared memory, rounded up to the 128 bytes a tensor
// copy's destination is aligned to
__host__ __device__ inline int fused_box_bytes(const FGeo& g) {
  return (g.br * g.bc * g.C * 2 + 127) / 128 * 128;
}

__host__ __device__ inline int fused_pooled_bytes(const FGeo& g) {
  return (g.th + 6) * g.pp * 8;
}

// both boxes, the pooled map (4 bf16 a pixel), the attention map (a float2
// a tile pixel), the conv's B fragments and the mbarrier
__host__ __device__ inline int fused_smem_bytes(const FGeo& g) {
  return 2 * fused_box_bytes(g) + fused_pooled_bytes(g) + g.th * g.tw * 8 + FUSED_BT * 4 +
         8;
}

// out = x * sigmoid(conv(pool(x))) for x = re + i im (B, H, W, C) bf16, w
// (7, 7, 4, 2) bf16: the pair sa_pool_kernel<2, bf16> + sa_gate_kernel<R,
// bf16> in one launch, x read from device memory once. The block: the
// copies; the conv's B words into shared memory while they fly; the pooled
// map from the boxes; the conv (mma_conv) and the sigmoid into the
// attention map; the product from the boxes, stored 16 bytes a thread. RB:
// tile rows a conv task.
template <int RB>
__global__ void __launch_bounds__(FT, 2)
sa_fused_bf16_kernel(const __grid_constant__ CUtensorMap re_map,
                     const __grid_constant__ CUtensorMap im_map,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out_re,
                     __nv_bfloat16* __restrict__ out_im, const FGeo g) {
  extern __shared__ __align__(128) unsigned char fused_smem[];
  const int b = blockIdx.z, h0 = blockIdx.y * g.th, w0 = blockIdx.x * g.tw;
  const int sh = min(max(h0 - 3, 0), g.H - g.br), sw = min(max(w0 - 3, 0), g.W - g.bc);
  const int box = fused_box_bytes(g);
  const uint4* xs[2] = {reinterpret_cast<const uint4*>(fused_smem),
                        reinterpret_cast<const uint4*>(fused_smem + box)};
  uint2* pooled = reinterpret_cast<uint2*>(fused_smem + 2 * box);
  float2* att = reinterpret_cast<float2*>(fused_smem + 2 * box + fused_pooled_bytes(g));
  uint32_t* bt = reinterpret_cast<uint32_t*>(att + g.th * g.tw);
  const uint32_t bar = smem_u32(bt + FUSED_BT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    mbar_init_count(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 4u * g.br * g.bc * g.C);
    for (int q = 0; q < 2; ++q) {
      const CUtensorMap* map = q ? &im_map : &re_map;
      if (g.flat)
        tma_load_3d(smem_u32(xs[q]), map, sw * g.C, sh, b, bar);
      else
        tma_load_4d(smem_u32(xs[q]), map, 0, sw, sh, b, bar);
    }
  }
  // The conv's B table (mma_b_taps), its halves loaded while the copies
  // fly and stored to the table after the pool, so that neither waits for
  // the other
  constexpr int PER = FUSED_BT / FT;
  const unsigned short* wh = reinterpret_cast<const unsigned short*>(w);
  unsigned short wlo[PER], whi[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    int lo, hi;
    mma_b_taps<4, 2>(tid + q * FT, lo, hi);
    wlo[q] = lo >= 0 ? wh[lo] : 0;
    whi[q] = hi >= 0 ? wh[hi] : 0;
  }

  // the pooled map: 0 outside the image and in the pad columns; the image's
  // pixels [ilo, ihi) x [jlo, jhi) pooled from the boxes
  const int npool = (g.th + 6) * g.pp;
  const int ilo = max(3 - h0, 0), ihi = min(g.H - h0 + 3, g.th + 6);
  const int jlo = max(3 - w0, 0), jhi = min(g.W - w0 + 3, g.tw + 6);
  for (int e = tid; e < npool; e += FT) {
    const int i = e / g.pp, j = e - i * g.pp;
    if (i < ilo || i >= ihi || j < jlo || j >= jhi) pooled[e] = make_uint2(0u, 0u);
  }
  mbar_wait(bar, 0);

  // NG lanes a pixel, the least power of two that leaves a lane at most 4
  // of its 16-byte words a plane, all loaded before the first sum; lane part
  // takes words part + NG k. A pixel's first word is staggered by NG times
  // its index in the quarter-warp so that the 8 lanes of a 16-byte load fall
  // on different banks; a shuffle tree over the NG lanes combines them. The
  // sums in float32 (sa_pool_kernel's order within a word), the mean
  // rounded once to bf16, the maxima exact, as bf16 pairs. (The sums as
  // mma products with a ones column ran slower at every site on the H100.)
  const int nv = g.C >> 3;
  int lg = 0;
  while ((4 << lg) < nv) ++lg;
  const int NG = 1 << lg, part = tid & (NG - 1), per = (nv + NG - 1) >> lg;
  const int nc = jhi - jlo, n = (ihi - ilo) * nc;
  const int rot = nv % NG ? 0 : (NG * ((tid >> lg) & 7)) % nv;
  for (int e0 = 0; e0 < n; e0 += FT >> lg) {
    const int e = e0 + (tid >> lg);
    const int i = e / nc, j = e - i * nc;
    float s[2] = {0.f, 0.f}, m[2] = {-INFINITY, -INFINITY};
    if (e < n) {
      const int px = ((h0 - 3 + ilo + i - sh) * g.bc + w0 - 3 + jlo + j - sw) * nv;
      __nv_bfloat162 m2[2] = {__float2bfloat162_rn(-INFINITY), __float2bfloat162_rn(-INFINITY)};
      uint4 v[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int word = part + NG * k + rot;
        word -= word >= nv ? nv : 0;
        if (k < per && part + NG * k < nv) {
          v[0][k] = xs[0][px + word];
          v[1][k] = xs[1][px + word];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < per && part + NG * k < nv) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float a[8];
            unpack8(v[q][k], a);
            s[q] += ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[q][k]);
            m2[q] = __hmax2(m2[q], __hmax2(__hmax2(h[0], h[1]), __hmax2(h[2], h[3])));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) m[q] = fmaxf(__low2float(m2[q]), __high2float(m2[q]));
    }
    for (int o = NG >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
      }
    }
    if (e < n && part == 0) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s[0] / (float)g.C, m[0]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[1] / (float)g.C, m[1]);
      pooled[(ilo + i) * g.pp + jlo + j] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                      *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q)
    bt[tid + q * FT] = wlo[q] | (static_cast<uint32_t>(whi[q]) << 16);
  __syncthreads();

  // the lane's 32 B words from the table, consecutive lanes on consecutive
  // words; the conv, the sigmoid of lane (gid, tig)'s n = 2 tig + {0, 1},
  // (dy, s) = (tig / 2, tig % 2) of tile columns c (M row gid) and c + 16
  // (gid + 8), both channels, into the attention map. Columns past the tile
  // are computed on its last column and dropped.
  uint32_t bf[FUSED_BT / 32];
#pragma unroll
  for (int i = 0; i < FUSED_BT / 32; ++i) bf[i] = bt[i * 32 + lane];
  mma_conv<4, 2, RB>(pooled, g.pp, g.th, g.tw, g.tw - 1, bf, warp, FT / 32, lane,
                     [&](int r0, int c0, const float (&acc)[4]) {
                       const int r = r0 + ((lane & 3) >> 1), c = c0 + (lane & 1);
                       if (r < g.th && c < g.tw)
                         att[r * g.tw + c] = make_float2(sigmoidf(acc[0]), sigmoidf(acc[1]));
                       if (r < g.th && c + 16 < g.tw)
                         att[r * g.tw + c + 16] =
                             make_float2(sigmoidf(acc[2]), sigmoidf(acc[3]));
                     });
  __syncthreads();

  // the product from the boxes: a tile row's pixels are contiguous in x, a
  // run of cols_v * nv 16-byte words; sa_gate_kernel's arithmetic
  const int rows_v = min(g.th, g.H - h0), cols_v = min(g.tw, g.W - w0);
  const int run = cols_v * nv;
  const long long row0 = (long long)b * g.H + h0;
#pragma unroll 2
  for (int e = tid; e < rows_v * run; e += FT) {
    const int r = e / run, i = e - r * run;
    const float2 a = att[r * g.tw + (g.vshift >= 0 ? i >> g.vshift : i / nv)];
    const int k = ((h0 + r - sh) * g.bc + w0 - sw) * nv + i;
    float xr[8], xi[8], yr[8], yi[8];
    unpack8(xs[0][k], xr);
    unpack8(xs[1][k], xi);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      yr[c] = xr[c] * a.x - xi[c] * a.y;
      yi[c] = xr[c] * a.y + xi[c] * a.x;
    }
    const long long o = ((row0 + r) * g.W + w0) * nv + i;
    reinterpret_cast<uint4*>(out_re)[o] = pack8(yr);
    reinterpret_cast<uint4*>(out_im)[o] = pack8(yi);
  }
}

// the fused bf16 gate over re, im (B, H, W, C) at a tile of th x tw: C a
// multiple of 8 up to 256 (a tensor copy's box is at most 256 elements a
// side), x and out 16-byte aligned, a block's shared
// memory within 227 KB. The tensor maps are encoded at every launch from
// the operands' addresses; the dynamic shared-memory attribute is set at
// every launch.
int launch_fused(const __nv_bfloat16* re, const __nv_bfloat16* im, const __nv_bfloat16* w,
                 __nv_bfloat16* out_re, __nv_bfloat16* out_im, int B, int H, int W,
                 int C, int th, int tw, cudaStream_t s) {
  if (!image_ok(B, H, W) || C < 8 || C > 256 || C % 8 || th < 1 || tw < 1 ||
      !aligned(re, 16) || !aligned(im, 16) || !aligned(out_re, 16) ||
      !aligned(out_im, 16) || !aligned(w, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int br = th + 6 < H ? th + 6 : H, bc = tw + 6 < W ? tw + 6 : W;
  const FGeo g{H, W, C, th, tw, br, bc, tw + 8, log2_exact(C / 8), bc * C <= 256};
  const int smem = fused_smem_bytes(g);
  if (br > 256 || bc > 256 || smem > SMEM_LIMIT || (H + th - 1) / th > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  // a plane (B, H, W, C) as (W C, H, B) with a box of bc C channels x br
  // rows (flat), or as (C, W, H, B) with a box of C x bc x br; strides in
  // bytes
  const cuuint64_t C64 = C, W64 = W, H64 = H, B64 = B;
  const cuuint64_t dims_flat[3] = {W64 * C64, H64, B64};
  const cuuint64_t strides_flat[2] = {W64 * C64 * 2, H64 * W64 * C64 * 2};
  const cuuint32_t box_flat[3] = {static_cast<cuuint32_t>(bc * C), static_cast<cuuint32_t>(br),
                                  1};
  const cuuint64_t dims[4] = {C64, W64, H64, B64};
  const cuuint64_t strides[3] = {C64 * 2, W64 * C64 * 2, H64 * W64 * C64 * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C), static_cast<cuuint32_t>(bc),
                             static_cast<cuuint32_t>(br), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const __nv_bfloat16* planes[2] = {re, im};
  CUtensorMap maps[2];
  for (int q = 0; q < 2; ++q)
    if (encode(&maps[q], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.flat ? 3 : 4,
               const_cast<__nv_bfloat16*>(planes[q]), g.flat ? dims_flat : dims,
               g.flat ? strides_flat : strides, g.flat ? box_flat : box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  // RB: tile rows a conv task, 8 or fewer (down to a pair) so that the 8
  // warps have a task each where the tile allows
  int rb = 8;
  while (rb > 2 && (tw + 31) / 32 * ((th + rb - 1) / rb) < FT / 32) rb /= 2;
  auto kernel = rb == 8   ? sa_fused_bf16_kernel<8>
                : rb == 4 ? sa_fused_bf16_kernel<4>
                          : sa_fused_bf16_kernel<2>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  kernel<<<grid, FT, smem, s>>>(maps[0], maps[1], w, out_re, out_im, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W, Cin), w (K, K, Cin, Cout), bias (Cout,), y (B, H, W, Cout); all
// f32 and contiguous. R = 0 takes the generic body; R in {2, 4} (and 8 at the
// real classes) with a tile of TY rows x R * TX columns takes the
// register-tiled body, for (K, Cin, Cout) = (7, 4, 2), (7, 2, 4), (7, 2, 1)
// and (7, 1, 2), with x aligned to a pixel's 4 Cin bytes, y to 4 Cout and w to
// the word of a tap's weights (16 bytes at the complex classes, 8 at the
// real). Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int dcs_conv_same_small_cout(const float* x, const float* w,
                                        const float* bias, float* y, int B,
                                        int H, int W, int Cin, int K, int Cout,
                                        int R, int TX, int TY, void* stream) {
  if (K % 2 == 0 || K < 1 || K > MAXK || Cout < 1 || Cout > MAXCOUT ||
      Cin < 1 || !image_ok(B, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) {
    dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH, B);
    dim3 block(BW, BH);
    kLaunch[Cout - 1](grid, block, s, x, w, bias, y, H, W, Cin, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (!tiled_class(K, Cin, Cout) || !tile_ok(R, TX, TY, Cin, Cout) ||
      !aligned(x, 4 * Cin) || !aligned(y, 4 * Cout) ||
      !aligned(w, tap_word_bytes(Cin, Cout)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = make_tile(R, TX, TY, Cin, Cout);
  const dim3 grid = tile_grid(t, B, H, W);
  const int smem = t.smem4() * 16;
  if (Cin == 4)
    launch_conv7<4, 2>(R, grid, smem, s, x, w, bias, y, t, H, W);
  else if (Cin == 2 && Cout == 4)
    launch_conv7<2, 4>(R, grid, smem, s, x, w, bias, y, t, H, W);
  else if (Cin == 2)
    launch_conv7<2, 1>(R, grid, smem, s, x, w, bias, y, t, H, W);
  else
    launch_conv7<1, 2>(R, grid, smem, s, x, w, bias, y, t, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The conv entry's bf16 class: x (B, H, W, Cin), w (7, 7, Cin, Cout) and y
// (B, H, W, Cout) bf16, bias (Cout,) f32; float32 sums of the bf16
// products, the bias added, y rounded once. The tensor-core body
// (conv7_mma_kernel) at the tiled classes, (7, 4, 2), (7, 2, 4), (7, 2, 1)
// and (7, 1, 2), on a tile of TH rows x TW columns with RB tile rows a
// warp's task (ops/cuda_conv.py:mma_tile); x aligned to a pixel's 2 Cin
// bytes, y to 4 bytes, w to a bf16. Any other class or tile is
// cudaErrorInvalidValue. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int dcs_conv_same_small_cout_bf16(const void* x, const void* w,
                                             const float* bias, void* y, int B, int H,
                                             int W, int Cin, int K, int Cout, int TH,
                                             int TW, int RB, void* stream) {
  if (!tiled_class(K, Cin, Cout) || !image_ok(B, H, W) || !aligned(x, 2 * Cin) ||
      !aligned(y, 4) || !aligned(w, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf* xb = static_cast<const bf*>(x);
  const bf* wb = static_cast<const bf*>(w);
  bf* yb = static_cast<bf*>(y);
  if (Cin == 4)
    return launch_conv_mma<4, 2>(xb, wb, bias, yb, B, H, W, TH, TW, RB, s);
  if (Cin == 2 && Cout == 4)
    return launch_conv_mma<2, 4>(xb, wb, bias, yb, B, H, W, TH, TW, RB, s);
  if (Cin == 2)
    return launch_conv_mma<2, 1>(xb, wb, bias, yb, B, H, W, TH, TW, RB, s);
  return launch_conv_mma<1, 2>(xb, wb, bias, yb, B, H, W, TH, TW, RB, s);
}

// re, im (B, H, W, C) -> pooled (B, H, W, 4) = [mean re, max re, mean im,
// max im] over C; pooled 16-byte aligned.
extern "C" int dcs_sa_pool(const float* re, const float* im, float* pooled,
                           int B, int H, int W, int C, void* stream) {
  return launch_pool<2, float>(re, im, pooled, B, H, W, C, stream);
}

// pooled (B, H, W, 4), w (7, 7, 4, 2), re, im (B, H, W, C) -> out_re, out_im
// = (re + i im) * sigmoid(conv_same(pooled, w)), the 2-channel map read as
// (a_re, a_im) and broadcast over C. Tile as for the conv entry; pooled and
// w 16-byte aligned.
extern "C" int dcs_sa_gate(const float* pooled, const float* w,
                           const float* re, const float* im, float* out_re,
                           float* out_im, int B, int H, int W, int C, int R,
                           int TX, int TY, void* stream) {
  return launch_gate(pooled, w, re, im, out_re, out_im, B, H, W, C, R, TX, TY,
                     stream);
}

// The bf16 class of the pooling pass: re, im (B, H, W, C) bf16 -> pooled
// (B, H, W, 4) bf16, the means rounded once from float32 sums, the maxima
// exact; pooled 8-byte aligned.
extern "C" int dcs_sa_pool_bf16(const void* re, const void* im, void* pooled,
                                int B, int H, int W, int C, void* stream) {
  return launch_pool<2>(static_cast<const __nv_bfloat16*>(re),
                        static_cast<const __nv_bfloat16*>(im),
                        static_cast<__nv_bfloat16*>(pooled), B, H, W, C, stream);
}

// The bf16 class of the gate: pooled (B, H, W, 4), w (7, 7, 4, 2), re, im,
// out_re, out_im (B, H, W, C), all bf16; the conv, sigmoid and product in
// float32, each output rounded once. Tile as dcs_sa_gate's; pooled and w
// 8-byte aligned.
extern "C" int dcs_sa_gate_bf16(const void* pooled, const void* w, const void* re,
                                const void* im, void* out_re, void* out_im, int B,
                                int H, int W, int C, int R, int TX, int TY,
                                void* stream) {
  using bf = __nv_bfloat16;
  return launch_gate(static_cast<const bf*>(pooled), static_cast<const bf*>(w),
                     static_cast<const bf*>(re), static_cast<const bf*>(im),
                     static_cast<bf*>(out_re), static_cast<bf*>(out_im), B, H, W, C,
                     R, TX, TY, stream);
}

// The fused bf16 gate: re, im (B, H, W, C) bf16, w (7, 7, 4, 2) bf16 ->
// out_re, out_im = what dcs_sa_gate_bf16 computes on dcs_sa_pool_bf16's map,
// in one launch, x read once. Tile TH x TW (ops/cuda_conv.py:fused_tile); C
// a multiple of 8 up to 256, TW a multiple of 8; re, im, out_re, out_im
// 16-byte aligned.
extern "C" int dcs_sa_fused_bf16(const void* re, const void* im, const void* w,
                                 void* out_re, void* out_im, int B, int H, int W, int C,
                                 int TH, int TW, void* stream) {
  using bf = __nv_bfloat16;
  return launch_fused(static_cast<const bf*>(re), static_cast<const bf*>(im),
                      static_cast<const bf*>(w), static_cast<bf*>(out_re),
                      static_cast<bf*>(out_im), B, H, W, C, TH, TW,
                      static_cast<cudaStream_t>(stream));
}

// x (B, H, W, C) -> pooled (B, H, W, 2) = [mean, max] over C; pooled 8-byte
// aligned.
extern "C" int dcs_sa_pool_real(const float* x, float* pooled, int B, int H,
                                int W, int C, void* stream) {
  return launch_pool<1, float>(x, nullptr, pooled, B, H, W, C, stream);
}

// pooled (B, H, W, 2), w (7, 7, 2, 1), x (B, H, W, C) -> out = x *
// sigmoid(conv_same(pooled, w)), the one-channel map broadcast over C. Tile
// as for the conv entry at class (7, 2, 1); pooled and w 8-byte aligned.
extern "C" int dcs_sa_gate_real(const float* pooled, const float* w,
                                const float* x, float* out, int B, int H,
                                int W, int C, int R, int TX, int TY,
                                void* stream) {
  return launch_gate_real(pooled, w, x, out, B, H, W, C, R, TX, TY, stream);
}

// The bf16 class of the real pooling pass: x (B, H, W, C) bf16 -> pooled
// (B, H, W, 2) bf16, the mean rounded once from float32 sums, the max exact;
// pooled 4-byte aligned.
extern "C" int dcs_sa_pool_real_bf16(const void* x, void* pooled, int B, int H, int W,
                                     int C, void* stream) {
  return launch_pool<1, __nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), nullptr,
                                       static_cast<__nv_bfloat16*>(pooled), B, H, W, C,
                                       stream);
}

// The bf16 class of the real gate: pooled (B, H, W, 2), w (7, 7, 2, 1), x and
// out (B, H, W, C), all bf16; the conv's float32 sums rounded to bf16, the
// sigmoid rounded to bf16, the product rounded once. Tile as dcs_sa_gate_real's;
// pooled and w 4-byte aligned.
extern "C" int dcs_sa_gate_real_bf16(const void* pooled, const void* w, const void* x,
                                     void* out, int B, int H, int W, int C, int R,
                                     int TX, int TY, void* stream) {
  using bf = __nv_bfloat16;
  return launch_gate_real(static_cast<const bf*>(pooled), static_cast<const bf*>(w),
                          static_cast<const bf*>(x), static_cast<bf*>(out), B, H, W, C,
                          R, TX, TY, stream);
}

// A kernel that does nothing: the device time of a launch, which is the
// floor under every small launch above. Used by the smoke test's timing.
extern "C" int dcs_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
