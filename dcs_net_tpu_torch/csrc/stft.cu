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
// Entry point dcs_stft_fft: an FFT inside the kernel, so the work is the
// FFT's and the kernel is bound by the output it writes. It takes every even
// n_fft from 16 to 2048 whose half N2 = n_fft/2 has no prime factor above 7,
// as a plan of 1-4 in-register stages of radix <= 16 chosen on the host
// (dsp/stft_cuda.py:fft_radices; 200 = 8 x 5 x 5, 1024 = 16 x 8 x 8; four
// stages only for 625 and 875). A block owns `ft` consecutive frames of one
// batch row and a group of ft lanes owns one row of the tile, one lane a
// frame, so every shared-memory access of a lane group is a row of ft
// consecutive float2 whatever the butterfly stride, and every twiddle and
// window value is the same for the group (read through the read-only
// cache, one broadcast). Steps:
//   1. the tile's contiguous sample span, hop*(ft-1) + n_fft samples, is
//      staged once in shared memory (frames overlap n_fft/hop-fold; reflect
//      padding is index math). Frames start `hop` words apart, which for
//      hop = 32 would put a warp's 32 frames in one bank: the span is stored
//      skewed by one word per 32;
//   2. the real frame of n_fft points is packed into N2 complex points
//      z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1]; stage 1 (radix R1, Q1 = N2/R1)
//      takes one residue q = n mod Q1, runs the radix-R1 DFT over r
//      (n = q + Q1 r) in registers, multiplies by the twiddles
//      exp(-2 pi i q k1 / N2) and writes the R1 results to rows k1 + R1 q of
//      an (N2, ft) complex tile in shared memory;
//   3. each later stage s (radix Rs, Qs the product of the radices after it)
//      is a decimation in frequency in place: one item reads rows
//      k1 + R1 (q + Qs r + Rs Qs h), r < Rs, runs the radix-Rs DFT, twiddles
//      output ks by exp(-2 pi i q ks / (Rs Qs)) (not after the last stage)
//      and writes it back to row k1 + R1 (q + Qs ks + Rs Qs h). Output
//      k = k1 + R1 k2 + R1 R2 k3 + ... then lies at row
//      k1 + R1 (Q2 k2 + ... + QS kS), a table on the host (`rows`);
//   4. the split step turns Z into the real signal's bins,
//      X[k] = E + exp(-2 pi i k / n_fft) O with E = (Z[k] + conj Z[N2-k]) / 2,
//      O = (Z[k] - conj Z[N2-k]) / 2i (indices mod N2; the halves are folded
//      into the window table), for the bins first_bin .. first_bin + F - 1
//      only, and writes (B, F, T) directly: a lane group writes ft
//      consecutive frames of one bin.
// No dense basis is read and no transpose pass runs. n_fft 512, the enhance
// and train paths' size (two stages of 16, ft = 32), runs the compiled
// stft_fft_kernel<16, 16>; every other size runs
// stft_fft_mixed_kernel, whose stages switch at run time over one codelet
// template a radix (12 radices, two stage forms: a bounded set of
// instantiations). The codelets: radix-2 decimation in time for powers of
// two (twiddles the 16th roots of unity), the symmetric direct DFT for 3, 5
// and 7, and one Cooley-Tukey step for 6, 9, 10, 12, 14 and 15, their
// constants immediates (root_entry, a switch on compile-time constants: no
// load and no constant bank of the module's own). The span and the tables are
// staged by cp.async, all in flight at once. The (N2, ft) tile takes 8 N2 ft
// bytes: 256 KB at N2 = 1024 and ft = 32, over the 227 KB a block may have,
// so the host halves ft (32, 16, 8) until the block fits, and also while
// the grid gives fewer than two blocks an SM (dsp/stft_cuda.py:
// fft_tile_frames). Blocks an SM (80 registers a thread, 256 threads; the
// occupancy calculator through dcs_stft_blocks_per_sm): 3 up to
// 73 KB of shared memory a block (N2 = 200 at ft = 8, hop 100: 23 KB; at
// ft = 32: 71 KB; N2 = 625 at ft = 8: 73 KB), 2 at 100 KB (N2 = 512, ft = 16,
// hop 256), 1 from 118 KB (N2 = 1024 at ft = 8, hop 511; N2 = 875 at hop
// 1750: 139 KB).
//
// Entry point dcs_stft_forward: the dense DFT for the sizes the FFT entry
// does not take (odd n_fft, a half with a prime factor >= 11, n_fft > 2048,
// hop > n_fft), an implicit GEMM on the tensor cores: frames (A, frames x
// n_fft, read from x with the reflect padding as index math) times the folded
// basis (B, n_fft x 2F: cos and sin of 32 bins a 64-column block), written
// straight to (B, F, T). float32 accuracy from TF32 tensor cores by 3xTF32:
// three products (lo*hi, hi*lo, hi*hi) into one float32 sum, the frames
// split into hi and lo in registers (truncation, two operations a value),
// the basis split on the host (rounded); one TF32 product would leave ~1e-3
// relative error. wgmma m64n64k8, A from registers, B from shared memory: a
// block is one warpgroup owning 64 frames x 64 columns; a chunk of 32
// samples is the frames' tile (pitch 36 words, so a fragment load hits 32
// banks) and the basis' hi and lo slabs, which dsp/stft_cuda.py:dense_basis
// packs as the shared-memory image of the K-major core-matrix layout (one
// contiguous copy a chunk), double-buffered by cp.async (50 KB; four blocks
// an SM). Where the grid leaves SMs idle, a cluster of S = 2, 4 or 8 blocks
// (dsp/stft_cuda.py:dense_split, from the blocks an SM that
// dcs_stft_blocks_per_sm reports) shares one output tile, each rank reducing
// its run of sample chunks; after a cluster barrier rank r adds the r-th
// slice of frames over ranks 0, 1, ..., S - 1 in that order through
// distributed shared memory: deterministic. It does 2 * 2 * B * T * F * n_fft
// operations three times over, where an FFT does ~2.5 n_fft log2 n_fft a
// frame.
//
// Entry point dcs_stft_forward_bf16: the bf16 class of the dense entry, the
// function the JAX package computes at dft_dtype = bfloat16
// (dcs_net_tpu/dsp/stft.py:168-176): the raw frames rounded to bf16 times
// the folded basis rounded to bf16 (float64 fold -> float32 -> bf16, packed
// once on the host), float32 accumulation and output. Every n_fft takes it
// at bf16: an FFT over the rounded samples would leave the basis unrounded,
// another function. Its work is the rounded basis's products, 2 * 2 * B * T
// * F * n_fft (4.2 GFLOP at the enhance shape, 4.2 us at 989 TFLOP/s),
// beside its ~17.4 MB (5.2 us): bytes and operations bound it about equally.
// Its body where hop is a multiple of 16 and a column block's basis fits
// shared memory (the model's 512 / 32) is the span body below
// (stft_span_kernel): each block stages its frames' sample span once, keeps
// its column block's basis resident and reads both through wgmma
// descriptors, all of its products issued back to back. The other sizes
// take the chunked body (dcs_stft_forward_bf16_chunked): the dense entry's
// kernel above with one wgmma m64n64k16 bf16 a k16 step where 3xTF32 takes
// three a k8 step, the frames staged in float32 a 32-sample chunk at a time
// and rounded to bf16 pairs in registers (round to nearest even, as torch's
// .to(bfloat16)), a chunk's basis one bf16 slab of the same K-major
// core-matrix layout (8 n x 8 k, 16 bytes a row). dsp/stft_cuda.py:
// choose_entry picks the body from the shape alone. The products of two
// bf16 values are exact in float32, so both differ from their plain version
// only by the order of the float32 sum.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__host__ __device__ __forceinline__ int skew(int s) { return s + (s >> 5); }


// asynchronous copies from device to shared memory (both entries)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


// ---- the dense entry point: 3xTF32 wgmma ------------------------------------

constexpr int DM = 64;         // frames per block: one warpgroup's m64
constexpr int DB = 32;         // bins per block: 64 basis columns, cos then sin
constexpr int DN = 2 * DB;
constexpr int DK = 32;         // samples (basis rows) per reduction chunk
constexpr int DNT = 128;       // one warpgroup
constexpr int DAP = DK + 4;    // A row pitch: a fragment load hits 32 banks
constexpr int DPP = DN + 1;    // partial tile pitch (the cluster split)
constexpr int DBF = DK * DN;   // words of a chunk's hi (or lo) B slab
// the un-swizzled K-major core-matrix layout of a slab: [k/4][n][k%4], so
// the two core matrices of a k8 step are DN * 16 bytes apart and 8-row
// groups of n 128 bytes apart
constexpr uint32_t DLBO = DN * 16, DSBO = 128;
// 4-byte words of a chunk's basis: the hi and lo TF32 slabs, or one bf16 slab
template <bool BF16>
constexpr int kSlabWords = BF16 ? DBF / 2 : 2 * DBF;
// two stages of a chunk's basis and frames
template <bool BF16>
constexpr size_t kDenseSmem = sizeof(float) * 2 * (kSlabWords<BF16> + DM * DAP);

// orders generic-proxy shared-memory writes before wgmma's async-proxy reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The split of an A value, by truncation: hi keeps the top 19 bits, as the
// tensor cores read a float32 operand, and lo = v - hi is exact; the tensor
// cores drop lo's low 13 bits. Two operations a value; v = hi + lo' up to
// ~2^-20 |v|. (The basis comes split already, each part rounded to TF32.)
__device__ __forceinline__ void split_trunc(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// shared-memory matrix descriptor, no swizzle, K-major: 8-row x 16-byte core
// matrices; lbo = bytes between the two core matrices of a k8 step, sbo =
// bytes between 8-row groups
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 64, float32, 32 registers a thread) += a (64 x 8 TF32, registers)
// * b (8 x 64 TF32, shared memory, through desc)
__device__ __forceinline__ void wgmma_64(float (&d)[32], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64, float32) += a (64 x 16 bf16, registers: 4 of 2 values a
// thread) * b (16 x 64 bf16, shared memory, K-major, through desc)
__device__ __forceinline__ void wgmma_64_bf16(float (&d)[32], const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// two float32 values rounded to bf16 (nearest even), lo in the low half: the
// register layout of a bf16 A fragment pair
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (frame tiles, Fp / 32, B * split); basis (Fp / 32, Kp / 32, ...): for
// column block jb and chunk c the kSlabWords<BF16> words of the chunk, each
// the shared-memory image of the K-major core-matrix layout: (2, 8, 64, 4)
// f32, the hi then the lo slab; at BF16 (4, 64, 8) bf16.
// blockIdx.z = b * split + rank; rank reduces chunks [rank per, (rank+1) per)
template <bool BF16>
__global__ void __launch_bounds__(DNT)
stft_dense_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                  float* __restrict__ re, float* __restrict__ im, int n, int hop,
                  int F, int T, int pad, int chunks, int split) {
  constexpr int SLAB = kSlabWords<BF16>;
  extern __shared__ __align__(128) float dense_smem[];
  float* Bs = dense_smem;                                      // 2 stages
  auto As = reinterpret_cast<float (*)[DM][DAP]>(dense_smem + 2 * SLAB);  // 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mrow = 16 * warp + (lane >> 2), tg = lane & 3;
  const int t0 = blockIdx.x * DM, jb = blockIdx.y;
  const int rank = blockIdx.z % split, b = blockIdx.z / split;
  const int per = (chunks + split - 1) / split;
  const int c0 = rank * per, c1 = min(chunks, c0 + per);
  const float* xb = x + static_cast<long long>(b) * n;
  const float* bslab = basis + static_cast<long long>(jb) * chunks * SLAB;

  // A: frame t, samples c*DK .. c*DK + 31 (a warp a frame, consecutive
  // samples); zeros past the signal and for frames past T. B: the chunk's
  // hi and lo slabs, contiguous, in 16-byte copies (rows past n_fft are zero
  // in the packing).
  auto load = [&](int c, int st) {
    for (int e = tid; e < DM * DK; e += DNT) {
      const int t = e / DK, kk = e % DK;
      int i = (t0 + t) * hop - pad + c * DK + kk;
      if (pad > 0) {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * (n - 1) - i;
      }
      const bool ok = t0 + t < T && i >= 0 && i < n;
      cp_async4(smem_u32(&As[st][t][kk]), ok ? xb + i : xb, ok ? 4 : 0);
    }
    const float* src = bslab + static_cast<long long>(c) * SLAB;
    for (int e = tid; e < SLAB / 4; e += DNT)
      cp_async16(smem_u32(Bs + st * SLAB + 4 * e), src + 4 * e);
  };

  // accumulator i of a thread: row mrow + 8 * ((i / 2) % 2), column
  // 8 * (i / 4) + 2 * tg + i % 2
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // chunk c + 1 lands while chunk c is multiplied; one barrier a chunk both
  // publishes chunk c and frees the stage of chunk c - 1 for chunk c + 1
  if (c0 < c1) load(c0, 0);
  cp_async_commit();
  for (int c = c0; c < c1; ++c) {
    const int st = (c - c0) & 1;
    cp_async_wait<0>();  // chunk c has landed
    fence_proxy_async();
    __syncthreads();
    if (c + 1 < c1) load(c + 1, st ^ 1);
    cp_async_commit();
    const uint32_t bh = smem_u32(Bs + st * SLAB);
    if constexpr (BF16) {
      // a k16 step's fragment: rows mrow and mrow + 8, sample pairs (k, k + 1)
      // and (k + 8, k + 9) with k = 16 s + 2 tg; the B slab of the step
      // starts two core matrices (2 LBO) after the step before
      uint32_t a[4 * DK / 16];
#pragma unroll
      for (int s = 0; s < DK / 16; ++s) {
        const int k = 16 * s + 2 * tg;
        a[4 * s] = bf16x2(As[st][mrow][k], As[st][mrow][k + 1]);
        a[4 * s + 1] = bf16x2(As[st][mrow + 8][k], As[st][mrow + 8][k + 1]);
        a[4 * s + 2] = bf16x2(As[st][mrow][k + 8], As[st][mrow][k + 9]);
        a[4 * s + 3] = bf16x2(As[st][mrow + 8][k + 8], As[st][mrow + 8][k + 9]);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < DK / 16; ++s)
        wgmma_64_bf16(acc, a + 4 * s, make_desc(bh + s * 2 * DLBO, DLBO, DSBO));
    } else {
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int s = 0; s < DK / 8; ++s) {
        const int k = 8 * s + tg;
        split_trunc(As[st][mrow][k], hi[4 * s], lo[4 * s]);
        split_trunc(As[st][mrow + 8][k], hi[4 * s + 1], lo[4 * s + 1]);
        split_trunc(As[st][mrow][k + 4], hi[4 * s + 2], lo[4 * s + 2]);
        split_trunc(As[st][mrow + 8][k + 4], hi[4 * s + 3], lo[4 * s + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < DK / 8; ++s) {
        const uint64_t dhi = make_desc(bh + s * 2 * DLBO, DLBO, DSBO);
        const uint64_t dlo = make_desc(bh + DBF * 4 + s * 2 * DLBO, DLBO, DSBO);
        wgmma_64(acc, lo + 4 * s, dhi);
        wgmma_64(acc, hi + 4 * s, dlo);
        wgmma_64(acc, hi + 4 * s, dhi);
      }
    }
    wgmma_commit();
    wgmma_wait_all();  // the registers and the stage are free again
  }

  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = t0 + mrow + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
      const int f = jb * DB + (col & (DB - 1));
      if (t < T && f < F)
        (col < DB ? re : im)[(static_cast<long long>(b) * F + f) * T + t] = acc[i];
    }
    return;
  }

  // the split: every rank writes its partial tile (DM frames x DN columns)
  // into its own shared memory, then rank r adds frames
  // [r DM / S, (r + 1) DM / S) over ranks 0, 1, ..., S - 1 in that order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* part = dense_smem;
  __syncthreads();  // every thread is done with the stages
#pragma unroll
  for (int i = 0; i < 32; ++i)
    part[(mrow + 8 * ((i >> 1) & 1)) * DPP + 8 * (i >> 2) + 2 * tg + (i & 1)] = acc[i];
  cluster.sync();  // every rank's partial tile is written
  const int nr = DM / split, r0 = rank * nr;
  for (int e = tid; e < nr * DN; e += DNT) {
    const int col = e / nr, r = r0 + e % nr;
    float* src = part + r * DPP + col;
    float v = *cluster.map_shared_rank(src, 0);
    for (int k = 1; k < split; ++k) v += *cluster.map_shared_rank(src, k);
    const int t = t0 + r, f = jb * DB + (col & (DB - 1));
    if (t < T && f < F)
      (col < DB ? re : im)[(static_cast<long long>(b) * F + f) * T + t] = v;
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// lets a kernel take `smem` bytes of dynamic shared memory and asks for the
// largest shared-memory carveout, so that as many blocks co-reside as
// registers and shared memory allow (the default carveout may hold fewer)
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool BF16>
int launch_dense(cudaStream_t s, const float* x, const void* basis, float* re,
                 float* im, int B, int n, int n_fft, int hop, int F, int T, int pad,
                 int split) {
  if (split < 1 || split > 8 || (split & (split - 1)) ||
      static_cast<long long>(B) * split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fp = (F + DB - 1) / DB * DB, chunks = (n_fft + DK - 1) / DK;
  const dim3 grid((T + DM - 1) / DM, fp / DB, B * split);
  constexpr size_t smem = kDenseSmem<BF16>;
  const float* b = static_cast<const float*>(basis);
  cudaError_t e = set_smem(stft_dense_kernel<BF16>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (split == 1) {
    stft_dense_kernel<BF16><<<grid, DNT, smem, s>>>(x, b, re, im, n, hop, F, T, pad,
                                                    chunks, split);
    return static_cast<int>(cudaGetLastError());
  }
  // the `split` blocks of one output tile form a cluster along z
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(DNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, stft_dense_kernel<BF16>, x, b, re, im, n, hop, F, T, pad,
                         chunks, split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}


// ---- the dense entry's bf16 class: the span body ----------------------------
//
// The frames of a block overlap n_fft / hop-fold, so its sample span is
// staged once: rounded to bf16 in shared memory as rows of hop samples,
// (hop / 8, rows, 8) bf16, sample r * hop + j at [j / 8][r][j % 8]. Frame t
// is then rows t .. t + taps - 1 of that image, and the STFT a taps-tap
// VALID correlation over hop channels: a tap's 8-channel group of 8
// consecutive frames is 8 consecutive 16-byte rows, a K-major core matrix,
// at any row shift, so wgmma reads the frames (its B operand, N = frames)
// through a descriptor whose start moves by 16 bytes a tap. Its A operand (M
// = the 64 basis columns of 32 bins) is the column block's bf16 basis,
// resident for the whole block: one bulk copy a tap, each reporting to its
// own mbarrier, issued before the span is staged. A sub-tile of NS frames is
// taps * hop / 16 wgmma m64nNFk16 issued back to back with one wait at the
// end; a block walks several tiles in a pipeline of three warpgroups (the
// span staged, the products, the output stored). The accumulator rows are basis columns and its column pairs
// consecutive frames, so each (b, f) row of the (B, F, T) output is written
// in 32-byte runs, whole sectors.

// mbarrier in shared memory: a phase completes when its `count` arrivals
// have come and the bytes announced by expect_tx have been written
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// waits for the phase of parity `parity` to complete; a wait that outlasts
// any copy (about a second) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#pragma unroll 1
  for (int spin = 0; spin < (1 << 25); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// one thread copies `bytes` (a multiple of 16) of contiguous global memory to
// shared memory through the TMA unit; completion is counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d (64 x N, float32, N / 2 registers a thread) = a (64 x 16 bf16) * b (16 x
// N bf16) + (scale_d ? d : 0), both from shared memory, K-major, through
// their descriptors
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};




// words a row of a span block's output tile takes in shared memory
__host__ __device__ __forceinline__ int span_out_pitch(int nf) { return nf + 8; }

// shared memory of a span block: the column block's basis (taps * hop rows
// of 64 bf16), two span images of nf + taps - 1 rows, two float32 output
// tiles (64 rows), two float32 raw spans and the mbarriers (one a tap, ten
// for the rings)
__host__ __device__ __forceinline__ size_t span_smem_bytes(int nf, int hop, int taps) {
  return static_cast<size_t>(taps) * hop * 128 +
         2 * static_cast<size_t>(nf + taps - 1) * hop * 2 +
         2 * static_cast<size_t>(64) * span_out_pitch(nf) * 4 +
         2 * static_cast<size_t>(nf + taps - 1) * hop * 4 + 8 * static_cast<size_t>(taps + 10);
}

// sample groups a thread of a span block loads before it stores any (the
// tiles at the signal's ends, read sample by sample)
constexpr int SPAN_BATCH = 6;
// the mma warpgroup, two store warpgroups and the staging warpgroup
constexpr int SPAN_NT = 4 * DNT;

// grid (G, Fp / 32, B): block x of the grid owns the frame tiles x, x + G, x
// + 2 G, ... of NF frames of batch row b and column block jb. basis (Fp /
// 32, taps * hop / 8, 64, 8) bf16 as dsp/stft_cuda.py:span_basis_bf16 packs
// it: row k of column c of column block jb at [jb][k / 8][c][k % 8], zero
// past n_fft and past the bins. hop % 16 == 0 (a k16 step within one tap).
// The warpgroups are the stages of a pipeline over the block's tiles: the
// staging warpgroup has the TMA unit bring a tile's float32 samples (a
// contiguous run, two tiles ahead) and rounds them into one of two span
// images (the tiles at the signal's ends it reads sample by sample, with
// the reflect padding); the mma warpgroup runs a tile's products from an
// image and writes the float32 result into one of two output tiles; two
// store warpgroups write an output tile's (b, f) rows of frames to device
// memory. Full and empty mbarriers hand each buffer on, so a tile's
// products, the next tile's span and the last tile's output overlap, and
// the basis is loaded once a block.
// TAPS and STEPS (hop / 16), where not 0, are the shape's, fixed at compile
// time: the products are then one unrolled run of TAPS * STEPS wgmma (ptxas
// issues a run whose trip count is known only at run time far more slowly:
// it fences the wgmma of every trip).
template <int NF, int TAPS, int STEPS>
__global__ void __launch_bounds__(SPAN_NT)
stft_span_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ basis,
                 float* __restrict__ re, float* __restrict__ im, int n, int hop, int F,
                 int T, int pad, int taps) {
  extern __shared__ __align__(128) unsigned char span_smem[];
  constexpr int YP = NF + 8;                             // span_out_pitch
  const int kp = taps * hop, rows = NF + taps - 1, image = rows * hop * 2;
  unsigned char* Bs = span_smem;                         // (kp / 8, 64, 8) bf16
  unsigned char* Xs = span_smem + kp * 128;              // two span images
  float* Ys = reinterpret_cast<float*>(Xs + 2 * image);  // two output tiles
  float* Rs = Ys + 2 * 64 * YP;                          // two raw spans
  const uint32_t bars = smem_u32(Rs + 2 * rows * hop);   // a tap's basis, then:
  const uint32_t img_full = bars + 8 * taps, img_empty = img_full + 16;
  const uint32_t out_full = img_empty + 16, out_empty = out_full + 16;
  const uint32_t raw_full = out_empty + 16;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & (DNT - 1);
  const int lane = tid & 31, warp = wtid >> 5;
  const int jb = blockIdx.y, b = blockIdx.z, tiles = (T + NF - 1) / NF;
  const int nk = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (tid == 0) {
    for (int i = 0; i < taps; ++i) mbar_init(bars + 8 * i, 1);
    for (int i = 0; i < 6; ++i) mbar_init(img_full + 8 * i, DNT);
    for (int i = 0; i < 2; ++i) mbar_init(out_empty + 8 * i, 2 * DNT);
    for (int i = 0; i < 2; ++i) mbar_init(raw_full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 3) {
    // staging: the span of each tile as rows of hop samples, (hop / 8, rows,
    // 8) bf16, sample r * hop + j at [j / 8][r][j % 8]: 8 samples a group,
    // rows fastest (consecutive threads write consecutive 16-byte rows). A
    // tile inside the signal is one contiguous run of x, which the TMA unit
    // brings into raw span k % 2 two tiles ahead; a tile at an end is read
    // from device memory a sample at a time with the reflect padding, zeros
    // past the signal, SPAN_BATCH groups a thread in flight together.
    const float* xb = x + static_cast<long long>(b) * n;
    const int total = rows * (hop >> 3), span = rows * hop;
    auto inside = [&](int k) {
      const int i0 = (blockIdx.x + k * gridDim.x) * NF * hop - pad;
      return i0 >= 0 && i0 + span <= n && (reinterpret_cast<uintptr_t>(xb + i0) & 15) == 0;
    };
    auto fetch = [&](int k) {  // one thread: tile k's samples into raw span k % 2
      if (k < nk && inside(k)) {
        const int i0 = (blockIdx.x + k * gridDim.x) * NF * hop - pad;
        mbar_expect_tx(raw_full + 8 * (k & 1), span * 4);
        bulk_copy(smem_u32(Rs + (k & 1) * span), xb + i0, span * 4, raw_full + 8 * (k & 1));
      }
    };
    if (wtid == 0) {  // the basis, a tap a copy, and the first two tiles' samples
      const unsigned char* src = reinterpret_cast<const unsigned char*>(basis) +
                                 static_cast<long long>(jb) * kp * 128;
      for (int i = 0; i < taps; ++i) {
        mbar_expect_tx(bars + 8 * i, hop * 128);
        bulk_copy(smem_u32(Bs + i * hop * 128), src + i * hop * 128, hop * 128, bars + 8 * i);
      }
      fetch(0);
      fetch(1);
    }
    int fetched = 0;  // bit i: the parity of raw span i's next copy
    for (int k = 0; k < nk; ++k) {
      const int buf = k & 1, t0 = (blockIdx.x + k * gridDim.x) * NF;
      if (k >= 2) mbar_wait(img_empty + 8 * buf, ((k >> 1) - 1) & 1);
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(Xs + buf * image);
      if (inside(k)) {
        mbar_wait(raw_full + 8 * buf, (fetched >> buf) & 1);
        fetched ^= 1 << buf;
        const float* raw = Rs + buf * span;
        const int groups = hop >> 3;
        for (int e = wtid; e < total; e += DNT) {  // groups fastest: no bank conflicts
          const int r = e / groups, g = e - r * groups;
          const float4 lo = *reinterpret_cast<const float4*>(raw + r * hop + 8 * g);
          const float4 hi = *reinterpret_cast<const float4*>(raw + r * hop + 8 * g + 4);
          *reinterpret_cast<uint4*>(dst + (static_cast<long long>(g) * rows + r) * 8) =
              make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w), bf16x2(hi.x, hi.y),
                         bf16x2(hi.z, hi.w));
        }
        named_sync(1, DNT);  // every thread is done with raw span k % 2
        if (wtid == 0) fetch(k + 2);
      } else {
        for (int e0 = wtid; e0 < total; e0 += DNT * SPAN_BATCH) {
          float v[SPAN_BATCH][8];
#pragma unroll
          for (int q = 0; q < SPAN_BATCH; ++q) {
            const int e = e0 + q * DNT;
            if (e >= total) break;
            const int g = e / rows, r = e - g * rows;
            const int i0 = (t0 + r) * hop - pad + 8 * g;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              int i = i0 + c;
              if (pad > 0) {
                if (i < 0) i = -i;
                if (i >= n) i = 2 * (n - 1) - i;
              }
              v[q][c] = i >= 0 && i < n ? __ldg(xb + i) : 0.f;
            }
          }
#pragma unroll
          for (int q = 0; q < SPAN_BATCH; ++q) {
            const int e = e0 + q * DNT;
            if (e >= total) break;
            const int g = e / rows, r = e - g * rows;
            *reinterpret_cast<uint4*>(dst + (static_cast<long long>(g) * rows + r) * 8) =
                make_uint4(bf16x2(v[q][0], v[q][1]), bf16x2(v[q][2], v[q][3]),
                           bf16x2(v[q][4], v[q][5]), bf16x2(v[q][6], v[q][7]));
          }
        }
        named_sync(1, DNT);
        if (wtid == 0) fetch(k + 2);
      }
      fence_proxy_async();  // these generic writes, for the mma warpgroup's wgmma
      mbar_arrive(img_full + 8 * buf);
    }
  } else if (wg == 0) {
    // the products. Accumulator i of a thread: basis column 16 warp + lane /
    // 4 + 8 ((i / 2) % 2) of the block (32 cos then 32 sin), frame 8 (i / 4)
    // + 2 (lane % 4) + i % 2 of the tile. Only wgmma writes it (the first
    // with its scale-d input off): a plain write between wgmma would
    // serialize them.
    float acc[NF / 2];
    const uint64_t da0 = make_desc(smem_u32(Bs), DLBO, DSBO);
    const uint32_t lbo_x = rows * 16;   // between the 8-sample groups of a row
    const int steps = hop >> 4, row0 = 16 * warp + (lane >> 2);
    for (int tap = 0; tap < taps; ++tap) mbar_wait(bars + 8 * tap, 0);
    for (int k = 0; k < nk; ++k) {
      const int buf = k & 1;
      mbar_wait(img_full + 8 * buf, (k >> 1) & 1);
      // descriptors advance in their 16-byte address field: k16 step kk of
      // the basis starts 2 DLBO bytes after step kk - 1, a tap's frames one
      // 16-byte row of the image after the tap before
      const uint64_t db0 = make_desc(smem_u32(Xs + buf * image), lbo_x, 128);
      wgmma_fence();
      if constexpr (TAPS > 0) {
#pragma unroll
        for (int kk = 0; kk < TAPS * STEPS; ++kk)
          WgmmaSS<NF>::mma(acc, da0 + static_cast<uint64_t>(kk * (2 * DLBO / 16)),
                           db0 + static_cast<uint64_t>(2 * (kk % STEPS) * rows + kk / STEPS),
                           kk > 0);
      } else {
        for (int tap = 0; tap < taps; ++tap) {
          for (int s = 0; s < steps; ++s) {
            const int kk = tap * steps + s;
            WgmmaSS<NF>::mma(acc, da0 + static_cast<uint64_t>(kk * (2 * DLBO / 16)),
                             db0 + static_cast<uint64_t>(2 * s * rows + tap), kk > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(img_empty + 8 * buf);
      if (k >= 2) mbar_wait(out_empty + 8 * buf, ((k >> 1) - 1) & 1);
      float* y = Ys + buf * 64 * YP;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NF / 8; ++j)
          *reinterpret_cast<float2*>(y + (row0 + 8 * h) * YP + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      mbar_arrive(out_full + 8 * buf);
    }
  } else {
    // the stores (warpgroups 1 and 2): a warp writes a (b, f) row's frames of
    // the tile in runs of 32 consecutive words (T is odd at the model's
    // sizes, so a row's frames have no 8-byte alignment to count on)
    const int swarp = (tid - DNT) >> 5;
    for (int k = 0; k < nk; ++k) {
      const int buf = k & 1, t0 = (blockIdx.x + k * gridDim.x) * NF;
      const int nt = min(NF, T - t0);
      mbar_wait(out_full + 8 * buf, (k >> 1) & 1);
      const float* y = Ys + buf * 64 * YP;
      for (int row = swarp; row < 2 * DB; row += 2 * DNT / 32) {
        const int f = jb * DB + (row & (DB - 1));
        if (f >= F) continue;
        float* out = (row < DB ? re : im) + (static_cast<long long>(b) * F + f) * T + t0;
        for (int t = lane; t < nt; t += 32) out[t] = y[row * YP + t];
      }
      mbar_arrive(out_empty + 8 * buf);
    }
  }
}

constexpr size_t kSpanSmemLimit = 227 * 1024;

template <int NF, int TAPS, int STEPS>
int launch_span_at(cudaStream_t s, const float* x, const void* basis, float* re, float* im,
                   int B, int n, int hop, int F, int T, int pad, int taps, int groups) {
  const size_t smem = span_smem_bytes(NF, hop, taps);
  const int tiles = (T + NF - 1) / NF;
  if (smem > kSpanSmemLimit || groups < 1 || groups > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stft_span_kernel<NF, TAPS, STEPS>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(groups, (F + DB - 1) / DB, B);
  kernel<<<grid, SPAN_NT, smem, s>>>(x, static_cast<const __nv_bfloat16*>(basis), re, im, n,
                                     hop, F, T, pad, taps);
  return static_cast<int>(cudaGetLastError());
}

// the model's size (n_fft 512, hop 32: 16 taps of 2 k16 steps) unrolled at
// compile time, every other size through the run-time loop
template <int NF>
int launch_span(cudaStream_t s, const float* x, const void* basis, float* re, float* im,
                int B, int n, int hop, int F, int T, int pad, int taps, int groups) {
  if (taps == 16 && hop == 32)
    return launch_span_at<NF, 16, 2>(s, x, basis, re, im, B, n, hop, F, T, pad, taps, groups);
  return launch_span_at<NF, 0, 0>(s, x, basis, re, im, B, n, hop, F, T, pad, taps, groups);
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

// instantiated for <16, 16> only (n_fft 512)
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



// ---- the mixed-radix FFT: every other 7-smooth half ------------------------

constexpr int MX_NT = 256;  // threads per block of stft_fft_mixed_kernel

// cos and sin of 2 pi m / R, m < R, for the codelet sizes that are no power
// of two, rounded once from float64, entry root_offset(R) + m: a switch, as
// cos_pi8, that folds to an immediate where the index is a compile-time
// constant after unrolling. (A table in constant memory here gave the
// module a user constant bank, which made every launch of its kernels, row
// 1's unchanged code among them, ~0.2 us longer on the H100: PERF.md
// section 6.) dsp/stft_cuda.py:root_cases_source() prints the cases
// (tests/test_torch_stft.py holds them to that output).
__device__ __forceinline__ float2 root_entry(int i) {
  switch (i) {
    /* 3 */ case 0: return {1.f, 0.f}; case 1: return {-0.5f, 0.8660254f}; case 2: return {-0.5f, -0.8660254f};
    /* 5 */ case 3: return {1.f, 0.f}; case 4: return {0.309017f, 0.95105654f}; case 5: return {-0.809017f, 0.58778524f}; case 6: return {-0.809017f, -0.58778524f}; case 7: return {0.309017f, -0.95105654f};
    /* 6 */ case 8: return {1.f, 0.f}; case 9: return {0.5f, 0.8660254f}; case 10: return {-0.5f, 0.8660254f}; case 11: return {-1.f, 0.f}; case 12: return {-0.5f, -0.8660254f}; case 13: return {0.5f, -0.8660254f};
    /* 7 */ case 14: return {1.f, 0.f}; case 15: return {0.6234898f, 0.7818315f}; case 16: return {-0.22252093f, 0.9749279f}; case 17: return {-0.90096885f, 0.43388373f}; case 18: return {-0.90096885f, -0.43388373f}; case 19: return {-0.22252093f, -0.9749279f}; case 20: return {0.6234898f, -0.7818315f};
    /* 9 */ case 21: return {1.f, 0.f}; case 22: return {0.76604444f, 0.64278764f}; case 23: return {0.17364818f, 0.9848077f}; case 24: return {-0.5f, 0.8660254f}; case 25: return {-0.9396926f, 0.34202015f}; case 26: return {-0.9396926f, -0.34202015f}; case 27: return {-0.5f, -0.8660254f}; case 28: return {0.17364818f, -0.9848077f}; case 29: return {0.76604444f, -0.64278764f};
    /* 10 */ case 30: return {1.f, 0.f}; case 31: return {0.809017f, 0.58778524f}; case 32: return {0.309017f, 0.95105654f}; case 33: return {-0.309017f, 0.95105654f}; case 34: return {-0.809017f, 0.58778524f}; case 35: return {-1.f, 0.f}; case 36: return {-0.809017f, -0.58778524f}; case 37: return {-0.309017f, -0.95105654f}; case 38: return {0.309017f, -0.95105654f}; case 39: return {0.809017f, -0.58778524f};
    /* 12 */ case 40: return {1.f, 0.f}; case 41: return {0.8660254f, 0.5f}; case 42: return {0.5f, 0.8660254f}; case 43: return {0.f, 1.f}; case 44: return {-0.5f, 0.8660254f}; case 45: return {-0.8660254f, 0.5f}; case 46: return {-1.f, 0.f}; case 47: return {-0.8660254f, -0.5f}; case 48: return {-0.5f, -0.8660254f}; case 49: return {0.f, -1.f}; case 50: return {0.5f, -0.8660254f}; case 51: return {0.8660254f, -0.5f};
    /* 14 */ case 52: return {1.f, 0.f}; case 53: return {0.90096885f, 0.43388373f}; case 54: return {0.6234898f, 0.7818315f}; case 55: return {0.22252093f, 0.9749279f}; case 56: return {-0.22252093f, 0.9749279f}; case 57: return {-0.6234898f, 0.7818315f}; case 58: return {-0.90096885f, 0.43388373f}; case 59: return {-1.f, 0.f}; case 60: return {-0.90096885f, -0.43388373f}; case 61: return {-0.6234898f, -0.7818315f}; case 62: return {-0.22252093f, -0.9749279f}; case 63: return {0.22252093f, -0.9749279f}; case 64: return {0.6234898f, -0.7818315f}; case 65: return {0.90096885f, -0.43388373f};
    /* 15 */ case 66: return {1.f, 0.f}; case 67: return {0.9135454f, 0.40673664f}; case 68: return {0.6691306f, 0.7431448f}; case 69: return {0.309017f, 0.95105654f}; case 70: return {-0.104528464f, 0.9945219f}; case 71: return {-0.5f, 0.8660254f}; case 72: return {-0.809017f, 0.58778524f}; case 73: return {-0.9781476f, 0.20791169f}; case 74: return {-0.9781476f, -0.20791169f}; case 75: return {-0.809017f, -0.58778524f}; case 76: return {-0.5f, -0.8660254f}; case 77: return {-0.104528464f, -0.9945219f}; case 78: return {0.309017f, -0.95105654f}; case 79: return {0.6691306f, -0.7431448f}; case 80: return {0.9135454f, -0.40673664f};
  }
  return {0.f, 0.f};
}

__host__ __device__ constexpr int root_offset(int r) {
  return r == 3 ? 0 : r == 5 ? 3 : r == 6 ? 8 : r == 7 ? 14 : r == 9 ? 21
       : r == 10 ? 30 : r == 12 ? 40 : r == 14 ? 52 : 66;
}

// exp(+2 pi i m / R) as (cos, sin); m is a compile-time constant after
// unrolling, so the value is an immediate
template <int R>
__device__ __forceinline__ float2 root(int m) {
  return root_entry(root_offset(R) + m % R);
}

template <int R>
__device__ __forceinline__ void dft_any(float (&re)[R], float (&im)[R]);

// In-register DFT of a prime P (3, 5, 7): X[0] = sum x; for k <= (P-1)/2,
// with s_j = x_j + x_{P-j} and d_j = x_j - x_{P-j},
// X[k] = a - i b and X[P-k] = a + i b, a = x_0 + sum s_j cos(2 pi jk/P),
// b = sum d_j sin(2 pi jk/P).
template <int P>
__device__ __forceinline__ void dft_prime(float (&re)[P], float (&im)[P]) {
  constexpr int H = (P - 1) / 2;
  float sr[H], si[H], dr[H], di[H];
  float s0r = re[0], s0i = im[0];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    sr[j] = re[j + 1] + re[P - 1 - j];
    si[j] = im[j + 1] + im[P - 1 - j];
    dr[j] = re[j + 1] - re[P - 1 - j];
    di[j] = im[j + 1] - im[P - 1 - j];
    s0r += sr[j];
    s0i += si[j];
  }
  const float x0r = re[0], x0i = im[0];
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float ar = x0r, ai = x0i, br = 0.f, bi = 0.f;
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const float2 w = root<P>(j * k);
      ar = fmaf(sr[j - 1], w.x, ar);
      ai = fmaf(si[j - 1], w.x, ai);
      br = fmaf(dr[j - 1], w.y, br);
      bi = fmaf(di[j - 1], w.y, bi);
    }
    re[k] = ar + bi;
    im[k] = ai - br;
    re[P - k] = ar - bi;
    im[P - k] = ai + br;
  }
  re[0] = s0r;
  im[0] = s0i;
}

// the first factor of a composite codelet size that is no power of two
__host__ __device__ constexpr int ct_first(int r) {
  return r == 12 ? 4 : (r % 2 == 0 ? 2 : 3);
}

// In-register DFT of R = A * B by one Cooley-Tukey step, the same
// decimation in frequency as the kernel's stages: for each q < B the
// radix-A DFT over r of x[q + B r], twiddled by exp(-2 pi i q k1 / R), then
// for each k1 the radix-B DFT over q, giving X[k1 + A k2].
template <int R>
__device__ __forceinline__ void dft_ct(float (&re)[R], float (&im)[R]) {
  constexpr int A = ct_first(R), Bq = R / A;
  float tr[A][Bq], ti[A][Bq];
#pragma unroll
  for (int q = 0; q < Bq; ++q) {
    float ur[A], ui[A];
#pragma unroll
    for (int r = 0; r < A; ++r) {
      ur[r] = re[q + Bq * r];
      ui[r] = im[q + Bq * r];
    }
    dft_any<A>(ur, ui);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      if ((q * k) % R == 0) {
        tr[k][q] = ur[k];
        ti[k][q] = ui[k];
      } else {
        const float2 w = root<R>(q * k);
        tr[k][q] = ur[k] * w.x + ui[k] * w.y;
        ti[k][q] = ui[k] * w.x - ur[k] * w.y;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < A; ++k) {
    dft_any<Bq>(tr[k], ti[k]);
#pragma unroll
    for (int j = 0; j < Bq; ++j) {
      re[k + A * j] = tr[k][j];
      im[k + A * j] = ti[k][j];
    }
  }
}

template <int R>
__device__ __forceinline__ void dft_any(float (&re)[R], float (&im)[R]) {
  if constexpr ((R & (R - 1)) == 0)
    dft<R>(re, im);
  else if constexpr (R == 3 || R == 5 || R == 7)
    dft_prime<R>(re, im);
  else
    dft_ct<R>(re, im);
}

#define DCS_STFT_RADICES(X) \
  X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(12) X(14) X(15) X(16)

__host__ __device__ constexpr bool is_codelet(int r) {
  return r == 3 || r == 4 || r == 5 || r == 6 || r == 7 || r == 8 ||
         r == 9 || r == 10 || r == 12 || r == 14 || r == 15 || r == 16;
}

struct MixedPlan {
  int n2;         // complex points, the product of the radices
  int stages;     // 1..4
  int radix[4];   // Rs
  int later[4];   // Qs: the product of the radices after stage s
  int tw_off[4];  // stage s's (Qs, Rs) twiddle block in tw
  int n_tw;       // twiddles in tw, all stages
};

// stage 1, radix R: from the staged span to rows k1 + R q
template <int R>
__device__ __forceinline__ void mixed_first(const float* fxs, float2* zs,
                                            const float2* win2, const float2* tw, int Q,
                                            bool twiddle, int slot, int units,
                                            int fr, int ft, int hop) {
  for (int q = slot; q < Q; q += units) {
    float zr[R], zi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int nn = q + Q * r;
      // both words skewed on their own (an odd hop puts a pair across a step)
      const int s = fr * hop + 2 * nn;
      const float2 w = win2[nn];
      zr[r] = fxs[skew(s)] * w.x;
      zi[r] = fxs[skew(s + 1)] * w.y;
    }
    dft_any<R>(zr, zi);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float vr = zr[k], vi = zi[k];
      if (twiddle && k > 0) {
        const float2 t = tw[q * R + k];
        const float a = vr * t.x - vi * t.y;
        vi = vr * t.y + vi * t.x;
        vr = a;
      }
      zs[(k + R * q) * ft + fr] = make_float2(vr, vi);
    }
  }
}

// a later stage, radix R, in place: item (k1, q, h) reads and writes rows
// k1 + R1 (q + Q r + R Q h), r < R
template <int R>
__device__ __forceinline__ void mixed_later(float2* zs, const float2* tw,
                                            int R1, int Q, bool twiddle, int items,
                                            int slot, int units, int fr, int ft) {
  for (int g = slot; g < items; g += units) {
    const int k1 = g % R1, t = g / R1, q = t % Q, h = t / Q;
    const int base = k1 + R1 * (q + R * Q * h), stride = R1 * Q;
    float yr[R], yi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = zs[(base + stride * r) * ft + fr];
      yr[r] = v.x;
      yi[r] = v.y;
    }
    dft_any<R>(yr, yi);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float vr = yr[k], vi = yi[k];
      if (twiddle && k > 0) {
        const float2 t = tw[q * R + k];
        const float a = vr * t.x - vi * t.y;
        vi = vr * t.y + vi * t.x;
        vr = a;
      }
      zs[(base + stride * k) * ft + fr] = make_float2(vr, vi);
    }
  }
}

// win2, sp as for stft_fft_kernel; tw the stages' twiddle blocks; rows (N2)
// the tile row of each FFT output. A lane group of ft lanes owns one row.
// The span and the tables are copied to shared memory by cp.async, all in
// flight at once: one wait on device memory a block, not one a loop
// iteration, a stage and a bin.
__global__ void __launch_bounds__(MX_NT, 2)
stft_fft_mixed_kernel(const float* __restrict__ x, const float2* __restrict__ win2,
                      const float2* __restrict__ tw, const float2* __restrict__ sp,
                      const int* __restrict__ rows, float* __restrict__ re,
                      float* __restrict__ im, int n, int hop, int first_bin, int F,
                      int T, int pad, int span, int ft, MixedPlan p) {
  extern __shared__ float2 fft_smem[];
  const int N2 = p.n2;
  float2* zs = fft_smem;                                  // (N2, ft)
  float2* win2s = zs + N2 * ft;                           // (N2)
  float2* tws = win2s + N2;                               // (n_tw)
  float2* sps = tws + p.n_tw;                             // (N2 + 1)
  int* rowss = reinterpret_cast<int*>(sps + N2 + 1);      // (N2)
  float* fxs = reinterpret_cast<float*>(rowss + N2);      // skewed span

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ft;
  const int tid = threadIdx.x;
  const int fr = tid & (ft - 1), slot = tid / ft, units = MX_NT / ft;
  const float* xb = x + static_cast<long long>(b) * n;

  const int s0 = t0 * hop - pad;
  for (int s = tid; s < span; s += MX_NT) {
    int i = s0 + s;
    if (pad > 0) {
      if (i < 0) i = -i;
      if (i >= n) i = 2 * (n - 1) - i;
    }
    const bool ok = i >= 0 && i < n;  // zeros past the signal
    cp_async4(smem_u32(&fxs[skew(s)]), ok ? xb + i : xb, ok ? 4 : 0);
  }
  for (int i = tid; i <= N2; i += MX_NT) {
    cp_async8(smem_u32(&sps[i]), &sp[i]);
    if (i < N2) {
      cp_async8(smem_u32(&win2s[i]), &win2[i]);
      cp_async4(smem_u32(&rowss[i]), &rows[i], 4);
    }
  }
  for (int i = tid; i < p.n_tw; i += MX_NT) cp_async8(smem_u32(&tws[i]), &tw[i]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int R1 = p.radix[0];
  switch (R1) {
#define DCS_FIRST(R)                                                          \
  case R:                                                                     \
    mixed_first<R>(fxs, zs, win2s, tws, p.later[0], p.stages > 1, slot, units, \
                   fr, ft, hop);                                              \
    break;
    DCS_STFT_RADICES(DCS_FIRST)
#undef DCS_FIRST
  }
  __syncthreads();
  for (int st = 1; st < p.stages; ++st) {
    const float2* tws_s = tws + p.tw_off[st];
    const bool twiddle = st + 1 < p.stages;
    switch (p.radix[st]) {
#define DCS_LATER(R)                                                             \
  case R:                                                                        \
    mixed_later<R>(zs, tws_s, R1, p.later[st], twiddle, N2 / R, slot, units, fr, ft); \
    break;
      DCS_STFT_RADICES(DCS_LATER)
#undef DCS_LATER
    }
    __syncthreads();
  }

  // split step and store: a lane group writes ft consecutive frames of a bin
  const int t = t0 + fr;
  for (int f = slot; f < F; f += units) {
    const int k = first_bin + f;
    const float2 a = zs[rowss[k == N2 ? 0 : k] * ft + fr];
    const float2 c = zs[rowss[k == 0 ? 0 : N2 - k] * ft + fr];
    const float2 w = sps[k];
    const float er = a.x + c.x, ei = a.y - c.y;   // E (halves in the window)
    const float orr = a.y + c.y, oi = c.x - a.x;  // O
    if (t < T) {
      const long long o = (static_cast<long long>(b) * F + f) * T + t;
      re[o] = er + orr * w.x - oi * w.y;
      im[o] = ei + orr * w.y + oi * w.x;
    }
  }
}

int launch_mixed(cudaStream_t s, const float* x, const float* win2, const float* tw,
                 const float* sp, const int* rows, float* re, float* im, int B,
                 int n, int n_fft, int hop, int first_bin, int F, int T, int pad,
                 const int* radix, int stages, int ft) {
  if (rows == nullptr || (ft != 8 && ft != 16 && ft != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  MixedPlan p = {};
  p.n2 = n_fft / 2;
  p.stages = stages;
  for (int st = stages - 1, later = 1; st >= 0; --st) {
    p.radix[st] = radix[st];
    p.later[st] = later;
    later *= radix[st];
  }
  for (int st = 1; st < stages; ++st)
    p.tw_off[st] = p.tw_off[st - 1] + p.radix[st - 1] * p.later[st - 1];
  p.n_tw = stages > 1 ? p.tw_off[stages - 1] : 0;
  const int span = hop * (ft - 1) + n_fft;
  const size_t smem = sizeof(float2) * (p.n2 * ft + 2 * p.n2 + 1 + p.n_tw) +
                      sizeof(int) * p.n2 + sizeof(float) * (skew(span - 1) + 1);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_smem(stft_fft_mixed_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + ft - 1) / ft, B);
  stft_fft_mixed_kernel<<<grid, MX_NT, smem, s>>>(
      x, reinterpret_cast<const float2*>(win2), reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const float2*>(sp), rows, re, im, n, hop, first_bin, F, T, pad,
      span, ft, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of the mixed FFT kernel (dense = 0), of the dense kernel (dense =
// 1) or of its bf16 class's chunked body (dense = 2) an SM holds at once with `smem` bytes
// of dynamic shared memory each, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the attributes a
// launch sets): the dense entries' cluster split is planned from it. A
// query: launches nothing.
extern "C" int dcs_stft_blocks_per_sm(int dense, int smem, int* blocks) {
  cudaError_t e;
  switch (dense) {
    case 0:
      e = set_smem(stft_fft_mixed_kernel, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, stft_fft_mixed_kernel, MX_NT, smem));
    case 1:
      e = set_smem(stft_dense_kernel<false>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, stft_dense_kernel<false>, DNT, smem));
    case 2:
      e = set_smem(stft_dense_kernel<true>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, stft_dense_kernel<true>, DNT, smem));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dense entry point. x (B, n) f32; basis (Kp, 2 Fp) f32 as
// dsp/stft_cuda.py:dense_basis packs it (Kp = n_fft, Fp = F, each rounded up
// to 32), 16-byte aligned; re, im (B, F, T) f32; split the cluster size
// (1, 2, 4 or 8). Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int dcs_stft_forward(const float* x, const float* basis, float* re,
                                float* im, int B, int n, int n_fft, int hop, int F,
                                int T, int pad, int split, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || hop <= 0 || n_fft <= 0 || n <= 0 ||
      (reinterpret_cast<uintptr_t>(basis) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dense<false>(static_cast<cudaStream_t>(stream), x, basis, re, im, B, n,
                             n_fft, hop, F, T, pad, split);
}

// The dense entry's bf16 class, its span body: x (B, n) f32, rounded to
// bf16 in the kernel; basis (Fp / 32, taps * hop / 8, 64, 8) bf16 as
// dsp/stft_cuda.py:span_basis_bf16 packs it (taps = ceil(n_fft / hop)),
// 16-byte aligned; re, im (B, F, T) f32; hop a multiple of 16; frames the
// frames of a tile (128, 64 or 32), groups the blocks a (batch row, column
// block) has, each walking every groups-th tile (1 to the tiles). Launches
// on `stream`, allocates nothing, returns cudaGetLastError(); a block over
// the shared memory a block may take is cudaErrorInvalidValue.
extern "C" int dcs_stft_forward_bf16(const float* x, const void* basis, float* re,
                                     float* im, int B, int n, int n_fft, int hop,
                                     int F, int T, int pad, int frames, int groups,
                                     void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || F <= 0 || hop <= 0 || (hop & 15) || n_fft <= 0 ||
      n <= 0 || (reinterpret_cast<uintptr_t>(basis) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int taps = (n_fft + hop - 1) / hop;
  switch (frames) {
    case 128:
      return launch_span<128>(s, x, basis, re, im, B, n, hop, F, T, pad, taps, groups);
    case 64:
      return launch_span<64>(s, x, basis, re, im, B, n, hop, F, T, pad, taps, groups);
    case 32:
      return launch_span<32>(s, x, basis, re, im, B, n, hop, F, T, pad, taps, groups);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dense entry's bf16 class, its chunked body (the sizes the span body
// does not take): x (B, n) f32, rounded to bf16 in the kernel; basis (Kp, 2
// Fp) bf16 as dsp/stft_cuda.py:dense_basis_bf16 packs it, 16-byte aligned;
// re, im (B, F, T) f32; split as above. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int dcs_stft_forward_bf16_chunked(const float* x, const void* basis, float* re,
                                             float* im, int B, int n, int n_fft, int hop,
                                             int F, int T, int pad, int split,
                                             void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || hop <= 0 || n_fft <= 0 || n <= 0 ||
      (reinterpret_cast<uintptr_t>(basis) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dense<true>(static_cast<cudaStream_t>(stream), x, basis, re, im, B, n,
                            n_fft, hop, F, T, pad, split);
}

// The FFT entry point. x (B, n) f32; win2 (n_fft/2, 2), tw (the stages'
// blocks, 2), sp (n_fft/2 + 1, 2) f32 and rows (n_fft/2) int32 tables as
// described above stft_fft_kernel and stft_fft_mixed_kernel; re, im (B, F, T)
// f32 hold the bins first_bin .. first_bin + F - 1. r1..r4 the stage radices
// (0 past the last), their product n_fft/2; ft the frames a block owns (8,
// 16 or 32). n_fft 512 as (16, 16) at ft = 32 runs the compiled kernel,
// which reads no rows (null). Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int dcs_stft_fft(const float* x, const float* win2, const float* tw,
                            const float* sp, const int* rows, float* re, float* im,
                            int B, int n, int n_fft, int hop, int first_bin, int F,
                            int T, int pad, int r1, int r2, int r3, int r4, int ft,
                            void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || hop <= 0 || B > 65535 || first_bin < 0 ||
      first_bin + F > n_fft / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int radix[4] = {r1, r2, r3, r4};
  int stages = 0, prod = 1;
  while (stages < 4 && radix[stages] > 0) {
    if (!is_codelet(radix[stages])) return static_cast<int>(cudaErrorInvalidValue);
    prod *= radix[stages++];
  }
  for (int st = stages; st < 4; ++st)
    if (radix[st] != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (stages == 0 || 2 * prod != n_fft) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_fft == 512 && stages == 2 && r1 == 16 && r2 == 16 && ft == 32)
    return launch_fft<16, 16>(s, x, win2, tw, sp, re, im, B, n, hop, first_bin, F, T, pad);
  return launch_mixed(s, x, win2, tw, sp, rows, re, im, B, n, n_fft, hop, first_bin, F,
                      T, pad, radix, stages, ft);
}
