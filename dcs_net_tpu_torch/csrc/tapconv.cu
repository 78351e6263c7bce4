// Kernel 3: stride-1 VALID tap correlation, an implicit GEMM on the tensor
// cores at float32 accuracy (3xTF32, wgmma).
//
// Replaces the Pallas kernel dcs_net_tpu/ops/pallas_tapconv.py:tapconv_valid
// (kernel _kernel):
//
//   y[b, h, w, n] = sum_{dh < Dh, dw < Dw, ci} x[b, h+dh, w+dw, ci]
//                                              * w[dh*Dw + dw, ci, n]
//
// x (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N), y (B, Hp-Dh+1, Wp-Dw+1, N), float32.
// Every decoder stage of the DCS U-Net reduces to this op (the fused
// skip-concat + nearest-upsample + 3x3 conv in its unified form, Dh = Dw = 3),
// with Cin from 32 to 512 and N from 8 to 512.
//
// What bounds it on the H100: operations. The decoder stages run 2*M*9*Cin*N
// FLOPs on M output pixels while moving x, w and y once, hundreds of FLOP per
// byte at Cin, N >= 64 (about 78 GFLOP per enhance call at batch 4 of 4 s).
// Float32 accuracy on the tensor cores costs three TF32 passes, so the rate
// to hold the kernel against is the dense TF32 rate over three. The last
// stage (N = 8, Cin = 32, half a million pixels) is different in kind: its
// bytes and its operations bound are close, and what matters there is that
// each input byte leaves device memory once.
//
// Design.
// * 3xTF32: each float32 operand is split as hi = tf32(v), lo = tf32(v - hi)
//   and the product accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in float32;
//   the dropped lo*lo term is ~2^-22 relative. The weights are rounded to
//   nearest once, by the packing kernel; the pixels, split by every thread
//   at every tap, are truncated, which costs two operations a value.
// * wgmma.mma_async m64nNk8 TF32, A from registers, B from shared memory. A
//   GEMM of M = output pixels by N channels over K = taps * Cin. TF32 wgmma
//   takes B K-major only, so a small kernel in this file (dcs_tapconv_pack)
//   first rewrites w into tiles (n tile, channel chunk, tap, hi | lo,
//   4-channel group, n, 4 channels): exactly the shared-memory image of the
//   un-swizzled K-major core-matrix layout (8 n x 16 bytes contiguous), split
//   into hi and lo once, so staging a B tile is one contiguous bulk copy.
// * An M tile is a run of 64 or 128 output pixels of one output row, so the
//   block's input is a Dh-row x (pixels + Dw - 1) x 32-channel halo tile,
//   staged once per channel chunk with 16-byte cp.async (zero fill past the
//   row end and past Cin); all Dh*Dw taps read it at shifted pixel offsets.
//   A tap shift is not a multiple of the 8-row core matrix, which is why A
//   goes through registers: each thread loads its 4 fragment values per k8
//   step from the halo tile (pixel pitch 36 words: conflict-free), splits
//   them in registers and starts the three wgmma.
// * Rings: A has 2 stages (one per channel chunk, cp.async from every
//   thread; 1 stage, refilled between chunks, for a window so large that two
//   halo tiles do not fit shared memory), B has 3 stages (one per tap and
//   channel chunk; all taps at once for N <= 8), each filled one step ahead by one thread with one TMA bulk
//   copy that reports to an mbarrier (16-byte cp.async copies of B from every
//   thread stall the threads that must start the wgmma). One __syncthreads
//   per step frees the oldest B stage.
//   The wgmma groups are not waited for where they are started: a thread
//   keeps two register sets of split A values (one per 16-channel half), so
//   the tensor cores run one half while the thread waits at the barrier and
//   splits the other half. A wait on an mbarrier that outlasts any copy
//   traps instead of hanging the card.
// * The tensor cores truncate when they add into an accumulator, an error
//   that grows with the length of the chain, so a chain runs over one channel
//   chunk only and the chunks are added with float32 adds.
// * Tiles: 128 pixels x 128 channels (two warpgroups sharing B), 64 pixels
//   when that still fills the card's SMs in one wave (dec0), 64-wide N tiles
//   for N <= 64 (two taps a B stage, so a step does as much work between
//   barriers), and an m64n8 instantiation for N <= 8 whose B stage holds
//   every tap, so a block runs one step per channel chunk and several blocks
//   share an SM. Ragged row ends are masked at the store. Any window whose
//   64-pixel halo tile fits shared memory beside the B ring is taken (up to
//   12 x 12 at every N); a larger one is refused, never computed otherwise.
// The structural zeros of the unified decoder weights are not skipped: the
// function stays the dense tap correlation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 32;           // input channels per reduction chunk
constexpr int APITCH = BK + 4;   // words per staged pixel (bank skew)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier in shared memory: one phase completes when its one arrival has
// come and the bytes it announced (expect_tx) have been written
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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

// waits until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps a register that an in-flight wgmma reads allocated up to this point
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// round to TF32 (10 mantissa bits), nearest with ties away from zero, as
// cvt.rna.tf32.f32 does for finite values, in two full-rate integer ops
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo up to ~2^-22 |v|, both TF32 (low 13 mantissa bits zero)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// The same split by truncation, for the A values a thread splits at every
// tap: hi keeps the top 19 bits, as the tensor cores themselves read a
// float32 operand, and lo = v - hi is exact; the tensor cores drop lo's low
// 13 bits. Two operations a value in place of five; v = hi + lo' up to
// ~2^-20 |v|.
__device__ __forceinline__ void split_trunc(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// shared-memory matrix descriptor, no swizzle, K-major: 8-row x 16-byte core
// matrices; lbo = bytes between the two core matrices of a k8 step, sbo =
// bytes between 8-row groups
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x N, float32, N/2 registers a thread) = a (64 x 8 TF32, registers)
// * b (8 x N TF32, shared memory, through desc) + (scale_d ? d : 0)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
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
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
  }
};

// w (taps, Cin, N) -> wp tiles [n tile][chunk][tap][hi | lo][BK/4][BN][4],
// zero beyond Cin and N; one thread per (n, 4-channel group).
template <int BN>
__global__ void pack_kernel(const float* __restrict__ w, float* __restrict__ wp,
                            int taps, int Cin, int N, int nchunks,
                            long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % BN);
  long long rest = idx / BN;
  const int j = static_cast<int>(rest % (BK / 4));
  rest /= BK / 4;
  const int tap = static_cast<int>(rest % taps);
  rest /= taps;
  const int chunk = static_cast<int>(rest % nchunks);
  const long long ntile = rest / nchunks;
  const long long gn = ntile * BN + n;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = chunk * BK + 4 * j + i;
    const float v = (c < Cin && gn < N)
                        ? w[(static_cast<long long>(tap) * Cin + c) * N + gn]
                        : 0.f;
    split_tf32(v, hi[i], lo[i]);
  }
  float* dst = wp + (((ntile * nchunks + chunk) * taps + tap) * 2) * (BK * BN) +
               (j * BN + n) * 4;
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + BK * BN) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// WGS warpgroups of 64 pixels each; BN channels; TPS taps per B stage; VEC
// floats per cp.async of x (4 when Cin % 4 == 0, else 1); RING_A: two A
// stages, else one, refilled between chunks.
template <int WGS, int BN, int TPS, int VEC, bool RING_A>
__global__ void __launch_bounds__(128 * WGS)
tapconv_kernel(const float* __restrict__ x, const float* __restrict__ wp,
               float* __restrict__ y, int Hp, int Wp, int Cin, int Dh, int Dw,
               int N, int HO, int WO, int nchunks, int wtiles) {
  constexpr int NT = 128 * WGS, BM = 64 * WGS;
  constexpr int TAPF = 2 * BK * BN;  // words of one tap's hi and lo slabs
  constexpr uint32_t LBO = BN * 16, SBO = 128;
  extern __shared__ __align__(128) float smem[];

  const int taps = Dh * Dw;
  const int tps = min(TPS, taps);
  const int ngroups = (taps + tps - 1) / tps;
  const int nit = nchunks * ngroups;
  const int nsb = min(3, nit), nsa = RING_A ? min(2, nchunks) : 1;
  const int PW = BM + Dw - 1;
  const int bstage = tps * TAPF, astage = Dh * PW * APITCH;
  float* Bs = smem;
  float* As = smem + nsb * bstage;
  // one mbarrier per B stage, behind the tiles
  const uint32_t bars = smem_u32(As + nsa * astage);

  const int tid = threadIdx.x, lane = tid & 31;
  const int wt = blockIdx.x % wtiles;
  const int row = blockIdx.x / wtiles;  // b * HO + ho
  const int ho = row % HO, b = row / HO;
  const int wo0 = wt * BM;
  const int n0 = blockIdx.y * BN;
  const float* xrow =
      x + ((static_cast<long long>(b) * Hp + ho) * Wp + wo0) * Cin;

  // copy e of a halo tile: channel group e % VPP of pixel e / VPP (rows of
  // PW pixels); a thread's copies are NT apart, walked without divisions
  constexpr int VPP = BK / VEC;
  static_assert(NT % VPP == 0, "a thread keeps its channel group");
  const int a_v = tid % VPP;
  const int a_r0 = (tid / VPP) / PW, a_p0 = (tid / VPP) % PW;
  auto load_a = [&](int chunk) {
    float* dst = As + (chunk % nsa) * astage + a_v * VEC;
    const int c = chunk * BK + a_v * VEC;
    const int total = Dh * PW;
    int r = a_r0, p = a_p0;
    for (int rp = tid / VPP; rp < total; rp += NT / VPP) {
      const bool ok = wo0 + p < Wp && c < Cin;
      const float* src =
          ok ? xrow + (static_cast<long long>(r) * Wp + p) * Cin + c : x;
      cp_async<VEC * 4>(smem_u32(dst + rp * APITCH), src, ok ? VEC * 4 : 0);
      p += NT / VPP;
      while (p >= PW) {
        p -= PW;
        ++r;
      }
    }
  };
  // thread 0 alone: one bulk copy brings the B stage of step `it`
  auto load_b = [&](int it) {
    const int chunk = it / ngroups, grp = it - chunk * ngroups;
    const int tap0 = grp * tps;
    const uint32_t bytes = min(tps, taps - tap0) * TAPF * 4;
    const float* src =
        wp + ((static_cast<long long>(blockIdx.y) * nchunks + chunk) * taps +
              tap0) * TAPF;
    const uint32_t bar = bars + 8 * (it % nsb);
    mbar_expect_tx(bar, bytes);
    bulk_copy(smem_u32(Bs + (it % nsb) * bstage), src, bytes, bar);
  };

  // acc: the tensor cores' running sum over one channel chunk; sum: the
  // chunks added up by float32 adds. The tensor cores truncate when they
  // add into an accumulator, an error that grows with the length of the
  // chain, so the chain is cut at every chunk. Only wgmma ever writes acc
  // inside the loop (a chunk's first one with its scale-d input off): a
  // plain write there would make the compiler drain the tensor cores at the
  // end of every step.
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < nsb; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) load_b(0);
  load_a(0);
  cp_async_commit();

  // this thread's fragment rows are pixels mrow and mrow + 8 of the tile
  const int mrow = (tid >> 5) * 16 + (lane >> 2);
  // Two register sets of split A values, one per 16-channel half of a tap's
  // chunk: while the tensor cores run the wgmma group of one half, the thread
  // loads and splits the other, here and across steps; at most two groups
  // are in flight.
  uint32_t hi[2][BK / 4] = {}, lo[2][BK / 4] = {};
  int chunk = 0, grp = 0, dh = 0, dw = 0;
  for (int it = 0; it < nit; ++it) {
    mbar_wait(bars + 8 * (it % nsb), (it / nsb) & 1);  // B of step `it`
    if (grp == 0) {       // this thread's part of the chunk's halo tile
      if (!RING_A && chunk > 0) {
        __syncthreads();  // every thread has read the last chunk's tile
        load_a(chunk);
        cp_async_commit();
      }
      cp_async_wait<0>();
      fence_proxy_async();
    }
    __syncthreads();      // everyone's part; the groups of step it - 2,
                          // whose B stage is refilled next, have retired
    if (tid == 0 && it + 1 < nit) load_b(it + 1);
    if (grp == 0 && RING_A && chunk + 1 < nchunks) {
      load_a(chunk + 1);
      cp_async_commit();
    }

    const float* Ab = As + (chunk % nsa) * astage;
    const uint32_t Bb = smem_u32(Bs + (it % nsb) * bstage);
    const int ntap = min(tps, taps - grp * tps);
    for (int tt = 0; tt < ntap; ++tt) {   // tap (dh, dw) of the window
      const float* ar = Ab + (dh * PW + dw + mrow) * APITCH + (lane & 3);
      const uint64_t bd = make_desc(Bb + tt * TAPF * 4, LBO, SBO);
      // the chunk's first wgmma starts a new sum: it drops what acc held
      const bool fresh = grp == 0 && tt == 0;
      if (++dw == Dw) {
        dw = 0;
        ++dh;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float raw[BK / 4];
#pragma unroll
        for (int s = 0; s < BK / 16; ++s) {
          const int k = 16 * h + 8 * s;
          raw[4 * s] = ar[k];
          raw[4 * s + 1] = ar[8 * APITCH + k];
          raw[4 * s + 2] = ar[k + 4];
          raw[4 * s + 3] = ar[8 * APITCH + k + 4];
        }
        wgmma_wait<1>();  // the group that last read this register set
#pragma unroll
        for (int i = 0; i < BK / 4; ++i) {
          keep(hi[h][i]);
          keep(lo[h][i]);
          split_trunc(raw[i], hi[h][i], lo[h][i]);
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < BK / 16; ++s) {
          // the descriptor's low bits are the address in 16-byte units
          const uint64_t dhi = bd + (((2 * h + s) * 2 * LBO) >> 4);
          const uint64_t dlo = dhi + ((BK * BN * 4) >> 4);
          Wgmma<BN>::mma(acc, lo[h][4 * s], lo[h][4 * s + 1], lo[h][4 * s + 2],
                         lo[h][4 * s + 3], dhi, h + s > 0 || !fresh);
          Wgmma<BN>::mma(acc, hi[h][4 * s], hi[h][4 * s + 1], hi[h][4 * s + 2],
                         hi[h][4 * s + 3], dlo, 1);
          Wgmma<BN>::mma(acc, hi[h][4 * s], hi[h][4 * s + 1], hi[h][4 * s + 2],
                         hi[h][4 * s + 3], dhi, 1);
        }
        wgmma_commit();
      }
    }
    if (++grp == ngroups) {
      grp = dh = dw = 0;
      ++chunk;
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
    }
  }
  wgmma_wait<0>();  // nothing is in flight here; this lets the compiler see it

  // accumulator i of a thread: row mrow + 8 * ((i / 2) % 2), column
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int wo = wo0 + mrow + 8 * half;
    if (wo >= WO) continue;
    float* yr = y + (static_cast<long long>(row) * WO + wo) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = sum[4 * j + 2 * half], v1 = sum[4 * j + 2 * half + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
      } else {
        if (n < N) yr[n] = v0;
        if (n + 1 < N) yr[n + 1] = v1;
      }
    }
  }
}

// taps per B stage: a stage of about 32 KB whatever the tile's width
template <int BN>
constexpr int kTapsPerStage = BN == 8 ? 9 : BN == 64 ? 2 : 1;

constexpr size_t kSmemLimit = 227 * 1024;

// shared memory of a block of `wgs` warpgroups with `nsa` A stages: the B
// ring, the A stages and the mbarriers
template <int BN>
size_t smem_bytes(int wgs, int nsa, int Cin, int Dh, int Dw) {
  const int taps = Dh * Dw;
  const int tps = taps < kTapsPerStage<BN> ? taps : kTapsPerStage<BN>;
  const int nchunks = (Cin + BK - 1) / BK;
  const int nit = nchunks * ((taps + tps - 1) / tps);
  const size_t words =
      static_cast<size_t>(nit < 3 ? nit : 3) * tps * 2 * BK * BN +
      static_cast<size_t>(nchunks < nsa ? nchunks : nsa) * Dh *
          (64 * wgs + Dw - 1) * APITCH;
  return words * sizeof(float) + 3 * 8;
}

template <int WGS, int BN, int VEC, bool RING_A>
int launch(cudaStream_t s, const float* x, const float* wp, float* y, int B,
           int Hp, int Wp, int Cin, int Dh, int Dw, int N, int HO, int WO) {
  constexpr int BM = 64 * WGS, nsa = RING_A ? 2 : 1;
  const int nchunks = (Cin + BK - 1) / BK;
  const size_t smem = smem_bytes<BN>(WGS, nsa, Cin, Dh, Dw);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tapconv_kernel<WGS, BN, kTapsPerStage<BN>, VEC, RING_A>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int wtiles = (WO + BM - 1) / BM;
  const long long mtiles = static_cast<long long>(B) * HO * wtiles;
  if (mtiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(mtiles), (N + BN - 1) / BN);
  kernel<<<grid, 128 * WGS, smem, s>>>(x, wp, y, Hp, Wp, Cin, Dh, Dw, N, HO, WO,
                                       nchunks, wtiles);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bn(cudaStream_t s, const float* x, const float* wp, float* y, int B,
              int Hp, int Wp, int Cin, int Dh, int Dw, int N, int HO, int WO) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return static_cast<int>(cudaGetLastError());
  }
  // The tile is chosen from the shape alone. 64-pixel tiles when the row is
  // that short, when 128-pixel tiles would leave half of the card's SMs
  // without a block, or when the window is so tall or wide that the halo
  // tiles of 128 pixels do not fit shared memory; one A stage in place of
  // two when two do not fit even then (the copy of a chunk's tile then
  // waits for the chunk before it).
  const long long blocks128 = static_cast<long long>(B) * HO *
                              ((WO + 127) / 128) * ((N + BN - 1) / BN);
  const bool narrow = WO <= 64 || 2 * blocks128 <= sms ||
                      smem_bytes<BN>(2, 2, Cin, Dh, Dw) > kSmemLimit;
  const bool ring =
      !narrow || smem_bytes<BN>(1, 2, Cin, Dh, Dw) <= kSmemLimit;
  const bool vec = Cin % 4 == 0;
#define DCS_LAUNCH(WGS, VEC, RING) \
  launch<WGS, BN, VEC, RING>(s, x, wp, y, B, Hp, Wp, Cin, Dh, Dw, N, HO, WO)
  if (!ring) return vec ? DCS_LAUNCH(1, 4, false) : DCS_LAUNCH(1, 1, false);
  if (narrow) return vec ? DCS_LAUNCH(1, 4, true) : DCS_LAUNCH(1, 1, true);
  return vec ? DCS_LAUNCH(2, 4, true) : DCS_LAUNCH(2, 1, true);
#undef DCS_LAUNCH
}

}  // namespace

extern "C" const char* dcs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w (taps, Cin, N) f32 -> wp, the hi/lo-split K-major tiles of width bn (8, 64
// or 128) described above pack_kernel: ceil(N/bn) * ceil(Cin/32) * taps * 2 *
// 32 * bn floats. Launches on `stream`, returns cudaGetLastError().
extern "C" int dcs_tapconv_pack(const float* w, float* wp, int taps, int Cin,
                                int N, int bn, void* stream) {
  if (taps < 1 || Cin < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (Cin + BK - 1) / BK;
  const long long total = static_cast<long long>((N + bn - 1) / bn) * nchunks *
                          taps * (BK / 4) * bn;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8:
      pack_kernel<8><<<blocks, 256, 0, s>>>(w, wp, taps, Cin, N, nchunks, total);
      break;
    case 64:
      pack_kernel<64><<<blocks, 256, 0, s>>>(w, wp, taps, Cin, N, nchunks, total);
      break;
    case 128:
      pack_kernel<128><<<blocks, 256, 0, s>>>(w, wp, taps, Cin, N, nchunks, total);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, Hp, Wp, Cin) f32, wp the packed weights of dcs_tapconv_pack at the
// same bn, y (B, Hp-Dh+1, Wp-Dw+1, N) f32; all contiguous and 16-byte
// aligned. Launches on `stream`, allocates nothing, returns
// cudaGetLastError(); a window whose 64-pixel halo tile does not fit shared
// memory beside the B ring (Dh * (63 + Dw) > 931 pixels at N > 8) is
// cudaErrorInvalidValue.
extern "C" int dcs_tapconv_valid(const float* x, const float* wp, float* y,
                                 int B, int Hp, int Wp, int Cin, int Dh, int Dw,
                                 int N, int bn, void* stream) {
  const int HO = Hp - Dh + 1, WO = Wp - Dw + 1;
  if (B < 1 || Cin < 1 || N < 1 || Dh < 1 || Dw < 1 || HO < 1 || WO < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8:
      return launch_bn<8>(s, x, wp, y, B, Hp, Wp, Cin, Dh, Dw, N, HO, WO);
    case 64:
      return launch_bn<64>(s, x, wp, y, B, Hp, Wp, Cin, Dh, Dw, N, HO, WO);
    case 128:
      return launch_bn<128>(s, x, wp, y, B, Hp, Wp, Cin, Dh, Dw, N, HO, WO);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
