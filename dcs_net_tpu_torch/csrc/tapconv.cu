// Kernel 3: stride-1 VALID tap correlation, an implicit GEMM on the tensor
// cores at float32 accuracy (3xTF32, wgmma).
//
// Replaces the Pallas kernel dcs_net_tpu/ops/pallas_tapconv.py:tapconv_valid
// (kernel _kernel):
//
//   y[b, h, w, n] = sum_{dh < Dh, dw < Dw, ci} xp[b, h+dh, w+dw, ci]
//                                              * w[dh*Dw + dw, ci, n]
//
// xp = x (B, H, W, Cin) zero-padded by (top, bottom, left, right) to
// (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N), y (B, Hp-Dh+1, Wp-Dw+1, N), float32;
// the kernel reads x itself, never a padded copy.
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
// * An M tile is 64 or 128 output pixels: a run of one output row, or, where
//   the output is narrower than 128 columns, a "flat" run of consecutive
//   pixels of one image over several rows (32-column decoder images would
//   fill 32 of a row tile's 64 wgmma rows). The block's input is the halo
//   tile of those pixels (their rows plus Dh - 1, their columns plus Dw - 1)
//   in 32-channel chunks, staged once per chunk with 16-byte cp.async; all
//   Dh*Dw taps read it at shifted pixel offsets, each thread finding its two
//   fragment rows in it on its own.
// * The input is read in place: the zero padding of the decoder's unified
//   conv is the halo's rows and columns outside x, zero-filled at staging
//   (cp.async with source size 0), and a tap row that reads only zeros for
//   every pixel of the tile is skipped, B stages and all.
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
//   where 128 would fill the tile's rows worse or leave half of the card's
//   SMs without a block, 64-wide N tiles for N <= 64 (two taps a B stage,
//   so a step does as much work between barriers), and an m64n8
//   instantiation for N <= 8 whose B stage holds every tap, so a block runs
//   one step per channel chunk and several blocks share an SM. Ragged tile
//   ends are masked at the store. Any window whose 64-pixel halo tile fits
//   shared memory beside the B ring is taken (up to 12 x 12 at every N); a
//   larger one is refused, never computed otherwise.
// * A split of the reduction where the grid leaves the card idle (batch 1,
//   a single request, a streaming chunk group: a few tiles at Cin = 512): the
//   channel chunks are divided among S <= 8 blocks of one output tile, a
//   thread-block cluster along gridDim.z. Each runs its chunks as above;
//   then each writes its partial tile into its own shared memory (the rings
//   are idle by then), and after a cluster barrier rank r adds the r-th
//   slice of rows over ranks 0..S-1, in that order, from the ranks' shared
//   memory (distributed shared memory) and stores it. No atomics: the sum
//   has one order, so two runs, and a CUDA graph replay against eager
//   launches, give the same bits.
// The tiling and S are chosen by the wrapper from the shape alone
// (ops/cuda_tapconv.py:forward_plan).
// The structural zeros of the unified decoder weights are not skipped: the
// function stays the dense tap correlation.
//
// The input gradient (dcs_tapconv_dgrad) runs the same kernel on the
// upstream gradient g (B, HO, WO, N) with the taps reversed and the channel
// axes swapped (Cin' = N reduced, N' = Cin out), as the JAX package's
// _updot_bwd (dcs_net_tpu/ops/conv_engine.py:879) computes it in XLA. Where
// the forward's input was x zero-padded, it writes dx (B, H, W, Cin), the
// pixels the caller keeps, and nothing of the padding. It reads g in place
// and takes flat tiles as the forward does; its weights are packed once,
// flipped and transposed, straight from w (dcs_tapconv_pack_dgrad). Small
// K: at dec6 Cin' = 8 and N' = 32, so that class has 8-channel chunks (one
// k8 step a tap, a register set per tap, all 9 taps in one B stage) and
// 32-wide N tiles (m64n32k8).
// The tiling (flat or one row, 64 or 128 pixels) is chosen by the wrapper
// (ops/cuda_tapconv.py:dgrad_plan) from the shape alone; it has no split.
//
// The forward's bf16 class computes what pallas_tapconv.tapconv_valid
// computes at bf16 operands (dcs_net_tpu/ops/pallas_tapconv.py:83-108): x
// and w bf16, float32 sums, y bf16 (its output type is x's), the weights
// packed by dcs_tapconv_pack_bf16 in K-major bf16 slabs ([KB/8][BN][8], 8
// channels a 16-byte core-matrix row). Its work is operations (78 GFLOP an
// enhance call, 0.079 ms at 989 TFLOP/s). Two bodies, the wrapper choosing
// from the shape alone (ops/cuda_tapconv.py:bf16_body):
// * the staged body (dcs_tapconv_valid_bf16, tapconv_staged_kernel below),
//   every 3 x 3 stage of the model with N > 8: both wgmma operands from
//   shared memory through descriptors, a 16-channel chunk's halo tile and
//   its 9 taps' weights a stage of a TMA-fed ring, one accumulator chain
//   over the whole reduction (see its notes);
// * the tap body (dcs_tapconv_valid_bf16_tap), every other shape (dec6's N
//   = 8, Cin no multiple of 8, other windows): the float32 kernel above,
//   templated, one wgmma m64nNk16 bf16 a 16-channel step where 3xTF32 takes
//   three m64nNk8 a 8-channel step, a register set (one 16-channel half of
//   a tap's 32-channel chunk) 4 registers of bf16 pairs read from the halo
//   tile (40 bf16 a pixel: a fragment load's 8 pixels x 4 words on 32
//   banks), staged 16 bytes a copy where Cin % 8 == 0 and one element at a
//   time otherwise, channels past Cin zero filled; its chain is cut at
//   every chunk.
// The products of bf16 values are exact in float32, so both differ from
// their plain version only by the order of the float32 sum; a split adds
// its float32 partial tiles in rank order and rounds once, at the store.
//
// The input gradient's bf16 class (training at bf16; the JAX _updot_bwd at
// bf16: g bf16, g K^T summed in float32, the overlap-add over taps in
// float32, dx rounded once to bf16) is the same VALID correlation on g with
// the flipped, transposed weights: g read in place, zero-padded by Dh - 1 -
// pad_top rows before it (and so on each side). Three bodies, the wrapper
// choosing from the shape alone (ops/cuda_tapconv.py:dgrad_body_bf16):
// * the narrow-reduction body (dcs_tapconv_dgrad_narrow_bf16, see its notes)
//   where the reduction is at most 8 channels and the output at most 32
//   (dec6), bound by bytes;
// * the staged body (dcs_tapconv_dgrad_bf16) reading the forward's packing
//   of w as it is, MN-major through wgmma's transpose bit, the taps
//   reversed by index: no packing launch of its own;
// * the tap body on weights packed flipped from w by
//   dcs_tapconv_pack_dgrad_bf16 (pack_bf16_kernel's FLIP), for the shapes
//   neither takes.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int BK = 32;           // input channels per reduction chunk (8 in
                                 // the input gradient's small-K class)

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
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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


// d (64 x N, float32) = a (64 x 16 bf16, registers: 4 of 2 values a thread)
// * b (16 x N bf16, shared memory, K-major, through desc) + (scale_d ? d : 0):
// the forward's bf16 class
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
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
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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

// a float32 sum as the output's type, rounded to nearest (even, for bf16)
template <typename E>
__device__ __forceinline__ E from_float(float v) {
  if constexpr (sizeof(E) == 2)
    return __float2bfloat16_rn(v);
  else
    return v;
}


// w (taps, Cin, N) -> wp tiles [n tile][chunk][tap][hi | lo][KB/4][BN][4] of
// the KB-channel chunks of the reduction, zero beyond K and N; one thread per
// (n, 4-channel group). The forward packs w as it is (K = Cin reduced, N
// out). FLIP packs the input gradient's weights straight from the forward's
// w (taps, N, K): taps in reverse order, the two channel axes swapped, so
// that reduction channel c of output n at tap t is w[taps - 1 - t][n][c].
template <int KB, int BN, bool FLIP>
__global__ void pack_kernel(const float* __restrict__ w, float* __restrict__ wp,
                            int taps, int K, int N, int nchunks,
                            long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % BN);
  long long rest = idx / BN;
  const int j = static_cast<int>(rest % (KB / 4));
  rest /= KB / 4;
  const int tap = static_cast<int>(rest % taps);
  rest /= taps;
  const int chunk = static_cast<int>(rest % nchunks);
  const long long ntile = rest / nchunks;
  const long long gn = ntile * BN + n;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = chunk * KB + 4 * j + i;
    float v = 0.f;
    if (c < K && gn < N)
      v = FLIP ? w[(static_cast<long long>(taps - 1 - tap) * N + gn) * K + c]
               : w[(static_cast<long long>(tap) * K + c) * N + gn];
    split_tf32(v, hi[i], lo[i]);
  }
  float* dst = wp + (((ntile * nchunks + chunk) * taps + tap) * 2) * (KB * BN) +
               (j * BN + n) * 4;
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + KB * BN) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// The forward's bf16 class: w (taps, Cin, N) bf16 -> wp tiles [n tile][chunk]
// [tap][KB/8][BN][8] bf16, one slab a tap (nothing to split), zero beyond K
// and N; one thread per (n, 8-channel group), one 16-byte store. FLIP packs
// the input gradient's weights from the forward's w (taps, N, K) as
// pack_kernel's FLIP does: taps reversed, the channel axes swapped.
template <int KB, int BN, bool FLIP = false>
__global__ void pack_bf16_kernel(const __nv_bfloat16* __restrict__ w,
                                 __nv_bfloat16* __restrict__ wp, int taps, int K,
                                 int N, int nchunks, long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % BN);
  long long rest = idx / BN;
  const int j = static_cast<int>(rest % (KB / 8));
  rest /= KB / 8;
  const int tap = static_cast<int>(rest % taps);
  rest /= taps;
  const int chunk = static_cast<int>(rest % nchunks);
  const long long ntile = rest / nchunks;
  const long long gn = ntile * BN + n;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = chunk * KB + 8 * j + i;
    v[i] = !(c < K && gn < N) ? __ushort_as_bfloat16(0)
           : FLIP ? w[(static_cast<long long>(taps - 1 - tap) * N + gn) * K + c]
                  : w[(static_cast<long long>(tap) * K + c) * N + gn];
  }
  __nv_bfloat16* dst = wp + ((ntile * nchunks + chunk) * taps + tap) * (KB * BN) +
                       (j * BN + n) * 8;
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// How a block's M tile maps to output pixels, and what it stages.
struct Geo {
  int Hg, Wg, Cg;  // the tensor read, (B, Hg, Wg, Cg): x, or the gradient g
  int H, W, N;     // the output (B, H, W, N)
  int oh, ow;      // output pixel (h, w) at tap (dh, dw) reads (h + oh + dh,
                   // w + ow + dw) of the tensor read; outside it reads zero
  int Dh, Dw;
  int flat;        // 1: a tile is BM consecutive pixels of one image's H x W
                   // (several rows); 0: BM pixels of one output row
  int tiles;       // M tiles per image (flat) or per output row
  int arows, apw;  // staged rows and pixels a row of the largest halo tile
  int nchunks;     // KB-channel chunks of Cg
};

// words a row of a block's partial tile takes in a split (BN + 8: the
// float2 stores of a half warp fall on 32 different banks)
template <int BN>
constexpr int kPartPitch = BN + 8;

// The element type of the tensor read, of the packed weights and of the
// output: float, or bf16 in the forward's bf16 class
template <bool BF16>
using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// one 32-bit register of an A fragment from the staged tile: a float32 value
// (split into TF32 parts later), or a pair of consecutive bf16 channels
template <bool BF16>
__device__ __forceinline__ uint32_t a_word(const Elem<BF16>* p) {
  if constexpr (BF16)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return __float_as_uint(*p);
}

// WGS warpgroups of 64 pixels each; KB reduction channels per chunk (32, or
// 8 for the input gradient's small-K class); BN channels; TPS taps per B
// stage; VEC elements per copy of the tensor read (16 bytes: 4 floats when
// Cg % 4 == 0, 8 bf16 when Cg % 8 == 0; else 1); RING_A: two A stages, else
// one, refilled between chunks; BF16: the forward's bf16 class (x, the
// weights and y bf16, one bf16 wgmma a k16 step in place of three TF32 ones
// a k8 step, float32 sums rounded once at the store). The grid is (M tiles,
// N tiles, S): with S > 1 a cluster of the S blocks of one output tile
// splits its channel chunks.
template <int WGS, int KB, int BN, int TPS, int VEC, bool RING_A, bool BF16>
__global__ void __launch_bounds__(128 * WGS)
tapconv_kernel(const Elem<BF16>* __restrict__ x, const Elem<BF16>* __restrict__ wp,
               Elem<BF16>* __restrict__ y, const Geo g) {
  using E = Elem<BF16>;
  constexpr int NT = 128 * WGS, BM = 64 * WGS;
  // elements per staged pixel: 36 or 12 floats, 40 bf16, so that the 8
  // pixels x 4 words of a fragment load fall on 32 different banks
  constexpr int APITCH = BF16 ? KB + 8 : KB + 4;
  // elements of one tap's B: the hi and lo TF32 slabs, or one bf16 slab
  constexpr int TAPF = BF16 ? KB * BN : 2 * KB * BN;
  // the k steps a register set holds (16 channels: two k8 or one k16 step)
  // and the channels of a step
  constexpr int KSTEP = BF16 ? 16 : 8;
  constexpr int KS = BF16 ? 1 : (KB / 16 > 0 ? KB / 16 : 1);
  constexpr uint32_t LBO = BN * 16, SBO = 128;
  static_assert(!BF16 || KB == 32, "the bf16 class reduces 32-channel chunks");
  extern __shared__ __align__(128) float smem[];

  // the tile: `count` output pixels from pix0 on, read through a halo tile
  // of nr rows x PW pixels whose (0, 0) is (r0, c0) of the tensor read
  int b, h_a, h_b, q0, count, PW;
  long long pix0;
  if (g.flat) {
    b = blockIdx.x / g.tiles;
    q0 = (blockIdx.x - b * g.tiles) * BM;
    count = min(BM, g.H * g.W - q0);
    h_a = q0 / g.W;
    h_b = (q0 + count - 1) / g.W;
    PW = g.W + g.Dw - 1;
    pix0 = static_cast<long long>(b) * g.H * g.W + q0;
  } else {
    const int row = blockIdx.x / g.tiles;  // b * H + h
    q0 = (blockIdx.x - row * g.tiles) * BM;  // the tile's first column
    b = row / g.H;
    h_a = h_b = row - b * g.H;
    count = min(BM, g.W - q0);
    PW = BM + g.Dw - 1;
    pix0 = static_cast<long long>(row) * g.W + q0;
  }
  const int nr = h_b - h_a + g.Dh;
  const int r0 = h_a + g.oh, c0 = (g.flat ? 0 : q0) + g.ow;
  // the tap rows that read inside the tensor for some pixel of the tile: a
  // row that reads only zero padding is skipped, B stages and all
  const int dh_lo = max(0, -(h_b + g.oh)), dh_hi = min(g.Dh - 1, g.Hg - 1 - r0);
  const int taps = g.Dh * g.Dw;
  const int live = dh_hi >= dh_lo ? (dh_hi - dh_lo + 1) * g.Dw : 0;
  const int tps = min(TPS, taps);
  const int ngroups = (live + tps - 1) / tps;
  // this block's share of the reduction: chunks [c_lo, c_hi) of rank
  // blockIdx.z of the split (every chunk without one)
  const int S = gridDim.z, rank = blockIdx.z;
  const int c_lo = rank * g.nchunks / S, c_hi = (rank + 1) * g.nchunks / S;
  const int nit = (c_hi - c_lo) * ngroups;
  // the ring sizes follow the whole window, as the host sized shared memory
  const int nsb = min(3, g.nchunks * ((taps + tps - 1) / tps));
  const int nsa = RING_A ? min(2, g.nchunks) : 1;
  const int bstage = tps * TAPF, astage = g.arows * g.apw * APITCH;
  E* Bs = reinterpret_cast<E*>(smem);
  E* As = Bs + nsb * bstage;
  // one mbarrier per B stage, behind the tiles and behind the partial tile
  // of a split (float32), which reuses the rings' bytes after the main loop
  const int ring = (nsb * bstage + nsa * astage) * static_cast<int>(sizeof(E));
  const int part = BM * kPartPitch<BN> * static_cast<int>(sizeof(float));
  const uint32_t bars =
      smem_u32(reinterpret_cast<char*>(smem) + (S > 1 && part > ring ? part : ring));

  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.y * BN;
  const E* xb = x + static_cast<long long>(b) * g.Hg * g.Wg * g.Cg;

  // copy e of a halo tile: channel group e % VPP of pixel e / VPP (rows of
  // PW pixels); a thread's copies are NT apart, walked without divisions
  constexpr int VPP = KB / VEC;
  static_assert(NT % VPP == 0, "a thread keeps its channel group");
  const int a_v = tid % VPP;
  const int a_r0 = (tid / VPP) / PW, a_p0 = (tid / VPP) % PW;
  auto load_a = [&](int chunk) {
    E* dst = As + (chunk % nsa) * astage + a_v * VEC;
    const int c = chunk * KB + a_v * VEC;
    const int total = nr * PW;
    int r = a_r0, p = a_p0;
    for (int rp = tid / VPP; rp < total; rp += NT / VPP) {
      const int rr = r0 + r, cc = c0 + p;
      const bool ok = rr >= 0 && rr < g.Hg && cc >= 0 && cc < g.Wg && c < g.Cg;
      const E* src =
          ok ? xb + (static_cast<long long>(rr) * g.Wg + cc) * g.Cg + c : x;
      if constexpr (BF16 && VEC == 1) {
        // a bf16 channel count that is no multiple of 8: one element at a
        // time, by plain loads (cp.async copies 4, 8 or 16 bytes)
        dst[rp * APITCH] = ok ? *src : __ushort_as_bfloat16(0);
      } else {
        constexpr int BYTES = VEC * static_cast<int>(sizeof(E));
        cp_async<BYTES>(smem_u32(dst + rp * APITCH), src, ok ? BYTES : 0);
      }
      p += NT / VPP;
      while (p >= PW) {
        p -= PW;
        ++r;
      }
    }
  };
  // thread 0 alone: one bulk copy brings the B stage of step `it`
  const int tap_lo = dh_lo * g.Dw;
  auto load_b = [&](int it) {
    const int k = it / ngroups, grp = it - k * ngroups, chunk = c_lo + k;
    const int tap0 = tap_lo + grp * tps;
    const uint32_t bytes = min(tps, tap_lo + live - tap0) * TAPF * sizeof(E);
    const E* src =
        wp + ((static_cast<long long>(blockIdx.y) * g.nchunks + chunk) * taps +
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
  if (nit > 0) {
    if (tid == 0) load_b(0);
    load_a(c_lo);
    cp_async_commit();
  }

  // this thread's fragment rows are pixels mrow and mrow + 8 of the tile;
  // where each sits in the halo tile (a pixel past the tile's end reads
  // pixel 0 and is not stored); its column is lane % 4, in bf16 the pair of
  // channels 2 (lane % 4), 2 (lane % 4) + 1
  const int mrow = (tid >> 5) * 16 + (lane >> 2);
  auto staged = [&](int m) {
    if (m >= count) return 0;
    if (!g.flat) return m;
    const int q = q0 + m, hh = q / g.W;
    return (hh - h_a) * PW + (q - hh * g.W);
  };
  const int col = (lane & 3) * (BF16 ? 2 : 1);
  const int base0 = staged(mrow) * APITCH + col;
  const int base1 = staged(mrow + 8) * APITCH + col;
  // Two register sets of A values (split into TF32 parts, or bf16 pairs as
  // they are): while the tensor cores run the wgmma group of one set, the
  // thread loads the other, here and across steps; at most two groups are
  // in flight. At KB = 32 a set is one 16-channel half of a tap's chunk, at
  // KB = 8 one whole tap.
  uint32_t hi[2][4 * KS] = {}, lo[2][4 * KS] = {};
  // toff: the halo-tile pixel offset of the current tap, dh * PW + dw
  int chunk = c_lo, grp = 0, dw = 0, toff = dh_lo * PW;
  for (int it = 0; it < nit; ++it) {
    mbar_wait(bars + 8 * (it % nsb), (it / nsb) & 1);  // B of step `it`
    if (grp == 0) {       // this thread's part of the chunk's halo tile
      if (!RING_A && chunk > c_lo) {
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
    if (grp == 0 && RING_A && chunk + 1 < c_hi) {
      load_a(chunk + 1);
      cp_async_commit();
    }

    const E* Ab = As + (chunk % nsa) * astage;
    const uint32_t Bb = smem_u32(Bs + (it % nsb) * bstage);
    const int ntap = min(tps, live - grp * tps);
    for (int tt = 0; tt < ntap; tt += (KB == 8 ? 2 : 1)) {
#pragma unroll
      for (int set = 0; set < 2; ++set) {
        const int t = KB == 8 ? tt + set : tt;   // the set's tap in the stage
        if (t >= ntap) break;
        const int half = KB == 8 ? 0 : set;      // its 16-channel half
        const E* a0 = Ab + base0 + toff * APITCH;
        const E* a1 = Ab + base1 + toff * APITCH;
        const uint64_t bd = make_desc(Bb + t * TAPF * sizeof(E), LBO, SBO);
        // the chunk's first wgmma starts a new sum: it drops what acc held
        const bool fresh = grp == 0 && t == 0;
        if (KB == 8 || set == 1) {  // the next tap (dh, dw) of the window
          if (++dw == g.Dw) {
            dw = 0;
            toff += PW - g.Dw + 1;
          } else {
            ++toff;
          }
        }
        // a step's fragment: rows mrow and mrow + 8, channels k (+ 1 in
        // bf16) and k + KSTEP / 2
        uint32_t raw[4 * KS];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int k = KSTEP * (KS * half + s);
          raw[4 * s] = a_word<BF16>(a0 + k);
          raw[4 * s + 1] = a_word<BF16>(a1 + k);
          raw[4 * s + 2] = a_word<BF16>(a0 + k + KSTEP / 2);
          raw[4 * s + 3] = a_word<BF16>(a1 + k + KSTEP / 2);
        }
        wgmma_wait<1>();  // the group that last read this register set
#pragma unroll
        for (int i = 0; i < 4 * KS; ++i) {
          keep(hi[set][i]);
          if constexpr (BF16) {
            hi[set][i] = raw[i];
          } else {
            keep(lo[set][i]);
            split_trunc(__uint_as_float(raw[i]), hi[set][i], lo[set][i]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          // the descriptor's low bits are the address in 16-byte units; a
          // step's B starts two core matrices (2 LBO) after the step before
          const uint64_t dhi = bd + (((KS * half + s) * 2 * LBO) >> 4);
          const int scale = half + s > 0 || !fresh;
          if constexpr (BF16) {
            WgmmaBf16<BN>::mma(acc, hi[set][4 * s], hi[set][4 * s + 1],
                               hi[set][4 * s + 2], hi[set][4 * s + 3], dhi, scale);
          } else {
            const uint64_t dlo = dhi + ((KB * BN * 4) >> 4);
            Wgmma<BN>::mma(acc, lo[set][4 * s], lo[set][4 * s + 1], lo[set][4 * s + 2],
                           lo[set][4 * s + 3], dhi, scale);
            Wgmma<BN>::mma(acc, hi[set][4 * s], hi[set][4 * s + 1], hi[set][4 * s + 2],
                           hi[set][4 * s + 3], dlo, 1);
            Wgmma<BN>::mma(acc, hi[set][4 * s], hi[set][4 * s + 1], hi[set][4 * s + 2],
                           hi[set][4 * s + 3], dhi, 1);
          }
        }
        wgmma_commit();
      }
    }
    // a step of an odd number of one-tap sets ends on set 0, which the next
    // step's first tap loads again
    if (KB == 8 && (ntap & 1)) wgmma_wait<0>();
    if (++grp == ngroups) {
      grp = dw = 0;
      toff = dh_lo * PW;
      ++chunk;
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
    }
  }
  wgmma_wait<0>();  // nothing is in flight here; this lets the compiler see it

  // accumulator i of a thread: row mrow + 8 * ((i / 2) % 2), column
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const int N = g.N;
  if (S == 1) {
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mrow + 8 * half;
      if (m >= count) continue;
      E* yr = y + (pix0 + m) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        const float v0 = sum[4 * j + 2 * half], v1 = sum[4 * j + 2 * half + 1];
        if (pairs && n + 1 < N) {
          if constexpr (BF16)
            *reinterpret_cast<__nv_bfloat162*>(yr + n) = __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
        } else {
          if (n < N) yr[n] = from_float<E>(v0);
          if (n + 1 < N) yr[n + 1] = from_float<E>(v1);
        }
      }
    }
    return;
  }

  // The split: every rank writes its partial tile (BM rows, pitch PP, float32)
  // into its own shared memory, then rank r adds rows [r BM / S, (r + 1) BM / S)
  // over the ranks 0, 1, ..., S - 1 in that order and stores them, rounded
  // once to the output's type after the whole sum.
  constexpr int PP = kPartPitch<BN>, Q = BN / 4;  // Q: float4s a row
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // both warpgroups' wgmma have read their last B stage
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* pr = smem + (mrow + 8 * half) * PP + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(pr + 8 * j) =
          make_float2(sum[4 * j + 2 * half], sum[4 * j + 2 * half + 1]);
  }
  cluster.sync();  // every rank's partial tile is written
  const int m_lo = rank * BM / S, m_hi = min((rank + 1) * BM / S, count);
  const bool quads = (N & 3) == 0;
  for (int e = tid; e < (m_hi - m_lo) * Q; e += NT) {
    const int r = e / Q, c = 4 * (e - r * Q), m = m_lo + r;
    float4* src = reinterpret_cast<float4*>(smem + m * PP + c);
    float4 v = *cluster.map_shared_rank(src, 0);
    for (int k = 1; k < S; ++k) {
      const float4 p = *cluster.map_shared_rank(src, k);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    E* yr = y + (pix0 + m) * N;
    const int n = n0 + c;
    if (quads && n + 3 < N) {
      if constexpr (BF16) {
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(yr + n) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                       *reinterpret_cast<const uint32_t*>(&hi2));
      } else {
        *reinterpret_cast<float4*>(yr + n) = v;
      }
    } else {
      if (n < N) yr[n] = from_float<E>(v.x);
      if (n + 1 < N) yr[n + 1] = from_float<E>(v.y);
      if (n + 2 < N) yr[n + 2] = from_float<E>(v.z);
      if (n + 3 < N) yr[n + 3] = from_float<E>(v.w);
    }
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// taps per B stage: a stage of about 32 KB whatever the tile's width, every
// tap of a 3 x 3 window at N <= 8 and in the small-K class (the bf16 class
// keeps the float32 stages' taps, a quarter of their bytes)
template <int KB, int BN>
constexpr int kTapsPerStage = BN == 8 || KB == 8 ? 9 : 128 / BN;

constexpr size_t kSmemLimit = 227 * 1024;

// shared memory of a block with `nsa` A stages of arows x apw pixels: the B
// ring, the A stages (or, where larger, the float32 partial tile of
// `part_rows` rows of a split) and the mbarriers
template <int KB, int BN, bool BF16>
size_t smem_bytes(int nsa, int Cg, int taps, int arows, int apw, int part_rows) {
  constexpr size_t E = BF16 ? 2 : 4;
  constexpr int TAPF = BF16 ? KB * BN : 2 * KB * BN;
  constexpr int APITCH = BF16 ? KB + 8 : KB + 4;
  const int tps = taps < kTapsPerStage<KB, BN> ? taps : kTapsPerStage<KB, BN>;
  const int nchunks = (Cg + KB - 1) / KB;
  const int nit = nchunks * ((taps + tps - 1) / tps);
  const size_t ring =
      (static_cast<size_t>(nit < 3 ? nit : 3) * tps * TAPF +
       static_cast<size_t>(nchunks < nsa ? nchunks : nsa) * arows * apw * APITCH) * E;
  const size_t part = static_cast<size_t>(part_rows) * kPartPitch<BN> * sizeof(float);
  return (ring > part ? ring : part) + 3 * 8;
}

template <int WGS, int KB, int BN, int VEC, bool RING_A, bool BF16>
int launch(cudaStream_t s, const Elem<BF16>* x, const Elem<BF16>* wp, Elem<BF16>* y,
           int B, const Geo& geo, int split) {
  const size_t smem =
      smem_bytes<KB, BN, BF16>(RING_A ? 2 : 1, geo.Cg, geo.Dh * geo.Dw, geo.arows,
                               geo.apw, split > 1 ? 64 * WGS : 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tapconv_kernel<WGS, KB, BN, kTapsPerStage<KB, BN>, VEC, RING_A, BF16>;
  // at every launch, under 48 KB too: the cluster query (clusters_at) sets
  // this attribute to the size it asks about, which may be less
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long mtiles = static_cast<long long>(B) * geo.tiles *
                           (geo.flat ? 1 : geo.H);
  if (mtiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mtiles), (geo.N + BN - 1) / BN, split);
  if (split == 1) {
    kernel<<<grid, 128 * WGS, smem, s>>>(x, wp, y, geo);
    return static_cast<int>(cudaGetLastError());
  }
  // the S blocks of one output tile form a cluster along z
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(128 * WGS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, wp, y, geo);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The tiling of `geo` at `wgs` warpgroups: tiles per image or row and the
// largest halo tile. A flat tile of BM pixels covers at most
// (BM + W - 2) / W + 1 output rows, BM / W where rows divide it.
void set_tiles(Geo& geo, int wgs) {
  const int BM = 64 * wgs;
  if (geo.flat) {
    const int HW = geo.H * geo.W;
    geo.tiles = (HW + BM - 1) / BM;
    int span = BM % geo.W == 0 ? BM / geo.W : (BM + geo.W - 2) / geo.W + 1;
    geo.arows = (span < geo.H ? span : geo.H) + geo.Dh - 1;
    geo.apw = geo.W + geo.Dw - 1;
  } else {
    geo.tiles = (geo.W + BM - 1) / BM;
    geo.arows = geo.Dh;
    geo.apw = BM + geo.Dw - 1;
  }
}

// the instantiation for a tiling: one A stage in place of two when two do
// not fit shared memory (the copy of a chunk's tile then waits for the chunk
// before it); refused when one does not fit either. A pixel's channels are
// copied 16 bytes at a time where their count allows (4 floats, 8 bf16).
template <int KB, int BN, bool BF16>
int launch_tiled(cudaStream_t s, const Elem<BF16>* x, const Elem<BF16>* wp,
                 Elem<BF16>* y, int B, Geo geo, int wgs, int split) {
  set_tiles(geo, wgs);
  const int taps = geo.Dh * geo.Dw;
  const bool ring = smem_bytes<KB, BN, BF16>(2, geo.Cg, taps, geo.arows, geo.apw,
                                             split > 1 ? 64 * wgs : 0) <= kSmemLimit;
  constexpr int V = BF16 ? 8 : 4;
  const bool vec = geo.Cg % V == 0;
#define DCS_LAUNCH(WGS, VEC, RING) \
  launch<WGS, KB, BN, VEC, RING, BF16>(s, x, wp, y, B, geo, split)
  if (wgs == 2) {
    if (!ring) return static_cast<int>(cudaErrorInvalidValue);
    return vec ? DCS_LAUNCH(2, V, true) : DCS_LAUNCH(2, 1, true);
  }
  if (!ring) return vec ? DCS_LAUNCH(1, V, false) : DCS_LAUNCH(1, 1, false);
  return vec ? DCS_LAUNCH(1, V, true) : DCS_LAUNCH(1, 1, true);
#undef DCS_LAUNCH
}

template <int KB, int BN>
int pack(const float* w, float* wp, int taps, int K, int N, bool flip,
         cudaStream_t s) {
  const int nchunks = (K + KB - 1) / KB;
  const long long total = static_cast<long long>((N + BN - 1) / BN) * nchunks *
                          taps * (KB / 4) * BN;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (flip)
    pack_kernel<KB, BN, true><<<blocks, 256, 0, s>>>(w, wp, taps, K, N, nchunks,
                                                     total);
  else
    pack_kernel<KB, BN, false><<<blocks, 256, 0, s>>>(w, wp, taps, K, N, nchunks,
                                                      total);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, int BN, bool FLIP = false>
int pack_bf16(const __nv_bfloat16* w, __nv_bfloat16* wp, int taps, int K, int N,
              cudaStream_t s) {
  const int nchunks = (K + KB - 1) / KB;
  const long long total = static_cast<long long>((N + BN - 1) / BN) * nchunks *
                          taps * (KB / 8) * BN;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  pack_bf16_kernel<KB, BN, FLIP><<<blocks, 256, 0, s>>>(w, wp, taps, K, N, nchunks,
                                                         total);
  return static_cast<int>(cudaGetLastError());
}

bool forward_args_ok(int B, int H, int W, int Cin, int HO, int WO, int N, int Dh,
                     int Dw, int pad_top, int pad_left, int flat, int wgs, int split) {
  return B >= 1 && H >= 1 && W >= 1 && Cin >= 1 && HO >= 1 && WO >= 1 && N >= 1 &&
         Dh >= 1 && Dw >= 1 && pad_top >= 0 && pad_left >= 0 &&
         (flat == 0 || flat == 1) && (wgs == 1 || wgs == 2) && split >= 1 &&
         split <= 8 && static_cast<long long>(HO) * WO <= 2147483647LL;
}

// ---- the forward's bf16 class: the staged body ------------------------------
//
// Both operands of every wgmma come from shared memory through descriptors,
// so no thread loads fragments. A stage is one 16-channel chunk (one k16
// step a tap): its halo tile as the no-swizzle K-major core-matrix image
// (2, npix, 8) bf16 (channel c of halo pixel p at [c / 8][p][c % 8], 16
// bytes a pixel an 8-channel group), and the chunk's packed weights for
// every tap (the pack_bf16_kernel layout at 16-channel chunks, whose taps of
// a chunk are contiguous); the body takes the 3 x 3 window of every stage of
// the model. M rows are consecutive halo pixels: tap
// (dh, dw) is the descriptor's start moved by (dh * pw + dw) * 16 bytes,
// and 8 consecutive halo pixels are a core matrix at any shift. A row
// tile's M rows are its output columns; a flat tile's are consecutive
// positions of the image's H x pw halo grid (pw = W + Dw - 1), whose Dw - 1
// extra columns a row are computed and not stored. One producer thread
// fills a ring of stages through the TMA unit, each stage two tensor copies
// of the halo tile's 8-channel planes (x read in place, its zero padding
// and everything past Cin filled with zeros by the copy) and one bulk copy
// of the weights, on a full mbarrier; the consumer warpgroups (64 M rows
// each) wait on it, issue a chunk's products back to back, and free the
// stage before (empty mbarrier) once the group that read it has retired: no
// __syncthreads in the main loop. (A stage's halo tile went through 16-byte
// cp.async from a producer warpgroup first, hundreds of copies a stage:
// issuing them took the producer longer than the consumers took for the
// stage's products.)
// bf16 products are exact in float32, so one accumulator chain runs over
// the whole reduction (its float32 adds are the only rounding before the
// store). The output is staged in shared memory as bf16 and written in
// 16-byte stores; the split (clusters, S ranks over the chunks) adds its
// float32 partial tiles in rank order as the tap body does.

constexpr int SKB = 16;            // channels a stage: one k16 step a tap
constexpr int kMaxStages = 6;

// The staged body's tiling of one launch, as the host plans it
struct SGeo {
  int Hg, Wg, Cg;  // x (B, Hg, Wg, Cg)
  int H, W, N;     // y (B, H, W, N)
  int oh, ow;      // output (h, w) at tap (dh, dw) reads x (h + oh + dh, w + ow + dw)
  int Dh, Dw;
  int flat;        // 1: a tile is BM consecutive positions of an image's H x pw
                   // halo grid; 0: BM output columns of one row
  int tiles;       // M tiles per image (flat) or per output row
  int pw;          // halo pixels a row
  int arows;       // halo rows a stage's copy brings
  int npix;        // halo pixels an 8-channel plane of a stage holds: every
                   // tap of every M row (rows past arows are not written)
  int nchunks;     // 16-channel chunks of Cg
  int nst;         // stages of the ring
  // the input gradient (TB): the forward's packing of w that it reads, its N
  // tile (the forward's N, Cg here, in fbn-wide tiles), its chunk (the
  // forward's Cin, N here, in fkb-channel chunks) and its chunks a tile
  int fbn, fkb, fchunks;
  // planes of a stage's halo tile an 8-channel group: 1, or, for the input
  // gradient's flat tiles in planes (flat = 2), Dw: one a column shift, each
  // W pixels a row, so that M rows are output pixels (no halo columns
  // among them)
  int nplanes;
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x N, float32) = a (64 x 16 bf16) * b (16 x N bf16) + (scale_d ? d :
// 0), both from shared memory through their descriptors, a K-major; b
// K-major, or MN-major where TB = 1 (the transpose bit: 8 consecutive
// columns of a k row contiguous, a core matrix 8 k rows of 16 bytes)
template <int N, int TB = 0>
struct WgmmaSS;

template <int TB>
struct WgmmaSS<8, TB> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, "
        "%4, %5, p, 1, 1, 0, %7;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct WgmmaSS<64, TB> {
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
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct WgmmaSS<128, TB> {
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
        "%64, %65, p, 1, 1, 0, %67;\n"
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
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};


// bytes of the staged body's stage, and of its block: nst stages, or where
// larger the output's staging (bf16, or a split's float32 partial tile),
// then 2 nst mbarriers
__host__ __device__ __forceinline__ int staged_stage_bytes(int bn, int taps, int npix) {
  return taps * SKB * bn * 2 + npix * SKB * 2;
}

__host__ __device__ __forceinline__ int staged_out_bytes(int bn, int wgs, int split) {
  return 64 * wgs * (bn + 8) * (split > 1 ? 4 : 2);
}

__host__ __device__ __forceinline__ int staged_bars_offset(int bn, int wgs, int taps,
                                                           int npix, int split, int nst) {
  const int ring = nst * staged_stage_bytes(bn, taps, npix);
  const int out = staged_out_bytes(bn, wgs, split);
  return ((ring > out ? ring : out) + 7) / 8 * 8;
}

// WGS consumer warpgroups of 64 M rows and one producer warp; BN output
// channels; a DH x DW window, fixed at compile time so that a stage's DH *
// DW wgmma are one unrolled run (ptxas issues a run whose trip count is
// known only at run time far more slowly: it fences the wgmma of every
// trip). Every tap runs: a tap row outside x reads the zeros the tensor
// copy fills in. x is read through `xmap`, a 5-d tensor map over x (B, Hg,
// Wg, Cg) as (8 channels, Cg / 8 channel groups, Wg, Hg, B) whose box is
// one 8-channel group of a halo tile: (8, 1, pw, arows, 1). Grid (M tiles, N
// tiles, S).
// TB: the input gradient, on the forward's packed weights as they are (no
// flipped packing): `wmap` is a 4-d tensor map over them as (its N tile's
// fbn x 8 (N, 8 channels of Cin) elements, fkb / 8 channel groups, the
// chunks of every tile, the taps), whose box (16 x 8: 256-byte rows, fkb /
// 8, BN / fkb, taps) lands as [tap][BN / 8 groups of 8 Cin][16 N][8 Cin]:
// for a tap, B (K = 16 of the forward's N, BN of its Cin) MN-major, core
// matrices 128 bytes apart along K and 256 along Cin, read with the
// transpose bit, the taps in reverse order by index. (A box of 16-byte
// rows, (8, 16, ...), took the stage's copies past its products.)
template <int WGS, int BN, int DH, int DW, bool TB = false>
__global__ void __launch_bounds__(128 * WGS + 32, 1)
tapconv_staged_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __nv_bfloat16* __restrict__ wp, __nv_bfloat16* __restrict__ y,
                      const SGeo g) {
  constexpr int BM = 64 * WGS, NT = 128 * WGS + 32;
  constexpr int TAPB = SKB * BN * 2;  // bytes of one tap's weights in a stage
  extern __shared__ __align__(128) unsigned char staged_smem[];
  unsigned char* smem = staged_smem;
  constexpr int taps = DH * DW;
  const int apix = TB ? g.npix * g.nplanes : g.npix;  // a stage's halo pixels a group
  const int bstage = taps * TAPB, stage = staged_stage_bytes(BN, taps, apix);
  const int S = gridDim.z, rank = blockIdx.z;
  const uint32_t bars =
      smem_u32(smem + staged_bars_offset(BN, WGS, taps, apix, S, g.nst));
  const uint32_t full = bars, empty = bars + 8 * g.nst;

  // the tile: M row m is halo position s0 + m of a halo tile of pw pixels a
  // row whose (0, 0) is x's (r0, c0)
  int b, h_a, s0, c0, q0 = 0, count = BM;
  long long row = 0;
  if (g.flat) {
    b = blockIdx.x / g.tiles;
    const int P0 = (blockIdx.x - b * g.tiles) * BM;
    h_a = P0 / g.pw;
    s0 = P0 - h_a * g.pw;
    c0 = g.ow;
  } else {
    row = blockIdx.x / g.tiles;  // b * H + h
    q0 = (static_cast<int>(blockIdx.x - row * g.tiles)) * BM;
    b = static_cast<int>(row / g.H);
    h_a = static_cast<int>(row - static_cast<long long>(b) * g.H);
    s0 = 0;
    c0 = q0 + g.ow;
    count = min(BM, g.W - q0);
  }
  const int r0 = h_a + g.oh;
  const int c_lo = rank * g.nchunks / S, c_hi = (rank + 1) * g.nchunks / S;
  const int nit = c_hi - c_lo;

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < g.nst; ++i) {
      mbar_init_count(full + 8 * i, 1);
      mbar_init_count(empty + 8 * i, 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Only wgmma writes acc (the first with its scale-d input off): a plain
  // write between wgmma would serialize them.
  float acc[BN / 2];

  if (wg == WGS) {
    // the producer: one thread issues a stage's copies, the taps' weights
    // (one contiguous run) and the halo tile's 8-channel planes
    if (tid == 128 * WGS) {
      constexpr uint32_t bbytes = taps * TAPB;
      const uint32_t abytes = 16 * g.pw * g.arows;
      for (int it = 0; it < nit; ++it) {
        const int s = it % g.nst, chunk = c_lo + it;
        if (it >= g.nst) mbar_wait(empty + 8 * s, ((it / g.nst) - 1) & 1);
        unsigned char* st = smem + s * stage;
        mbar_expect_tx(full + 8 * s, bbytes + (SKB / 8) * abytes * (TB ? g.nplanes : 1));
        if constexpr (TB) {
          const int k0 = chunk * SKB;  // the forward's output channel
          tma_load_4d(smem_u32(st), &wmap, (k0 % g.fbn) * 8, 0,
                      (k0 / g.fbn) * g.fchunks + blockIdx.y * (BN / g.fkb), 0, full + 8 * s);
        } else {
          const __nv_bfloat16* src =
              wp + (static_cast<long long>(blockIdx.y) * g.nchunks + chunk) * taps * (TAPB / 2);
          bulk_copy(smem_u32(st), src, bbytes, full + 8 * s);
        }
#pragma unroll
        for (int gi = 0; gi < SKB / 8; ++gi) {
          if constexpr (TB) {
            // plane p of group gi holds the halo's columns from c0 + p
            for (int p = 0; p < g.nplanes; ++p)
              tma_load_5d(smem_u32(st + bstage + (p * (SKB / 8) + gi) * g.npix * 16), &xmap,
                          0, chunk * (SKB / 8) + gi, c0 + p, r0, b, full + 8 * s);
          } else {
            tma_load_5d(smem_u32(st + bstage + gi * g.npix * 16), &xmap, 0,
                        chunk * (SKB / 8) + gi, c0, r0, b, full + 8 * s);
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: M rows 64 wg .. 64 wg + 63 of the tile
    static_assert(SKB == 16, "a stage is one k16 step a tap");
    const uint32_t lbo_a = g.npix * 16, lbo_b = BN * 16;
    const int arow = s0 + 64 * wg;
    // a tap's column shift: one pixel, or (planes) the next plane
    const int dstep = TB && g.nplanes > 1 ? (SKB / 8) * g.npix : 1;
    for (int it = 0; it < nit; ++it) {
      const int s = it % g.nst;
      mbar_wait(full + 8 * s, (it / g.nst) & 1);
      // descriptors advance in their 16-byte address field: tap (dh, dw) of
      // the halo tile starts dh * pw + dw pixels in, tap t's weights t TAPB
      // bytes into the stage
      const uint32_t bb = smem_u32(smem + s * stage);
      const uint64_t da0 = make_desc(bb + bstage + arow * 16, lbo_a, 128);
      const uint64_t db0 = TB ? make_desc(bb, 128, 256) : make_desc(bb, lbo_b, 128);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < taps; ++t)
        WgmmaSS<BN, TB>::mma(acc, da0 + static_cast<uint64_t>((t / DW) * g.pw + (t % DW) * dstep),
                             db0 + static_cast<uint64_t>((TB ? taps - 1 - t : t) * (TAPB / 16)),
                             it > 0 || t > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the group of the stage before has retired
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % g.nst));
    }
    wgmma_wait<0>();
  }

  // where M row m of the tile lands: its output pixel, or -1 (past the
  // tile, or a halo column of a flat tile)
  auto pixel = [&](int m) -> long long {
    if (g.flat) {
      const int P = (blockIdx.x - b * g.tiles) * BM + m, hh = P / g.pw, ww = P - hh * g.pw;
      if (hh >= g.H || ww >= g.W) return -1;
      return (static_cast<long long>(b) * g.H + hh) * g.W + ww;
    }
    return m < count ? row * g.W + q0 + m : -1;
  };

  const int lane = tid & 31, mrow = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int n0 = blockIdx.y * BN, N = g.N;
  __syncthreads();  // the ring is free
  if (S == 1) {
    if (wg == WGS) return;
    // accumulator i of a thread: row mrow + 8 ((i / 2) % 2), column 8 (i / 4)
    // + 2 (lane % 4) + i % 2
    constexpr int YP = BN + 8;
    __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(Ys + (mrow + 8 * h) * YP + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    named_sync(1 + wg, 128);
    const bool vec = (N & 7) == 0;
    for (int e = tid & 127; e < 64 * (BN / 8); e += 128) {
      const int r = e / (BN / 8), c8 = e - r * (BN / 8), m = 64 * wg + r;
      const long long pix = pixel(m);
      const int n = n0 + 8 * c8;
      if (pix < 0 || n >= N) continue;
      const __nv_bfloat16* src = Ys + m * YP + 8 * c8;
      __nv_bfloat16* dst = y + pix * N + n;
      if (vec && n + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && n + k < N; ++k) dst[k] = src[k];
      }
    }
    return;
  }

  // the split: every rank writes its float32 partial tile into its own
  // shared memory, then rank r adds rows [r BM / S, (r + 1) BM / S) over the
  // ranks 0, 1, ..., S - 1 in that order, rounds once and stores them
  constexpr int PP = kPartPitch<BN>, Q = BN / 4;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(smem);
  if (wg < WGS) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(part + (mrow + 8 * h) * PP + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  cluster.sync();  // every rank's partial tile is written
  const int m_lo = rank * BM / S, m_hi = (rank + 1) * BM / S;
  const bool quads = (N & 3) == 0;
  for (int e = tid; e < (m_hi - m_lo) * Q; e += NT) {
    const int r = e / Q, c = 4 * (e - r * Q), m = m_lo + r;
    const long long pix = pixel(m);
    const int n = n0 + c;
    if (pix < 0 || n >= N) continue;
    float4* src = reinterpret_cast<float4*>(part + m * PP + c);
    float4 v = *cluster.map_shared_rank(src, 0);
    for (int k = 1; k < S; ++k) {
      const float4 p = *cluster.map_shared_rank(src, k);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    __nv_bfloat16* yr = y + pix * N;
    if (quads && n + 3 < N) {
      const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(yr + n) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&lo2), *reinterpret_cast<const uint32_t*>(&hi2));
    } else {
      if (n < N) yr[n] = __float2bfloat16_rn(v.x);
      if (n + 1 < N) yr[n + 1] = __float2bfloat16_rn(v.y);
      if (n + 2 < N) yr[n + 2] = __float2bfloat16_rn(v.z);
      if (n + 3 < N) yr[n + 3] = __float2bfloat16_rn(v.w);
    }
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// The staged body's tiling at `wgs` warpgroups (ops/cuda_tapconv.py:
// staged_tiling): tiles per image or row, pw, the halo rows a stage's
// tensor copy brings (arows), and the pixels an 8-channel plane holds,
// rounded up to 8: the larger of the copy's arows * pw and what the M rows
// read. A flat tile starts at any column s0 < pw of its first row and its M
// rows read up to halo position s0 + BM - 1 + (Dh - 1) pw + Dw - 1 (rows
// past the copy's are not written: they feed only halo columns that are
// not stored).
void staged_tiles(SGeo& geo, int wgs) {
  const int BM = 64 * wgs;
  int reach;  // halo pixels the M rows read, at most
  geo.nplanes = 1;
  if (geo.flat == 2) {
    // the input gradient's flat tiles in planes: Dw planes of W pixels a
    // row, a tile BM consecutive output pixels from any column
    geo.nplanes = geo.Dw;
    geo.pw = geo.W;
    geo.tiles = (geo.H * geo.W + BM - 1) / BM;
    const int span = (BM + geo.pw - 2) / geo.pw + 1;
    geo.arows = (span < geo.H ? span : geo.H) + geo.Dh - 1;
    reach = geo.Dh * geo.pw + BM - 1;
  } else if (geo.flat) {
    geo.pw = geo.W + geo.Dw - 1;
    geo.tiles = ((geo.H - 1) * geo.pw + geo.W + BM - 1) / BM;
    const int span = (BM + geo.pw - 2) / geo.pw + 1;
    geo.arows = (span < geo.H ? span : geo.H) + geo.Dh - 1;
    reach = geo.Dh * geo.pw + BM + geo.Dw - 2;
  } else {
    geo.pw = BM + geo.Dw - 1;
    geo.tiles = (geo.W + BM - 1) / BM;
    geo.arows = geo.Dh;
    reach = geo.Dh * geo.pw;
  }
  const int copied = geo.arows * geo.pw;
  geo.npix = ((copied > reach ? copied : reach) + 7) / 8 * 8;
}

// stages of the ring (at most kMaxStages, at most a rank's chunks), or 0
// where fewer than two fit shared memory for a rank with more than one chunk
int staged_stages(int bn, int wgs, int taps, int npix, int nchunks, int split) {
  const int per = (nchunks + split - 1) / split;
  for (int nst = kMaxStages < per ? kMaxStages : per; nst >= 1; --nst) {
    const size_t smem = staged_bars_offset(bn, wgs, taps, npix, split, nst) + 16 * nst;
    if (smem <= kSmemLimit) return nst >= 2 || per == 1 ? nst : 0;
  }
  return 0;
}

// TB: the input gradient, wp the forward's packing, read through a tensor map
// (the kernel's notes)
template <int WGS, int BN, bool TB = false>
int launch_staged(cudaStream_t s, const __nv_bfloat16* x, const __nv_bfloat16* wp,
                  __nv_bfloat16* y, int B, SGeo geo, int split) {
  staged_tiles(geo, WGS);
  const int taps = geo.Dh * geo.Dw;
  geo.nst = staged_stages(BN, WGS, taps, geo.npix * geo.nplanes, geo.nchunks, split);
  if (geo.nst == 0 || geo.Dh != 3 || geo.Dw != 3 || geo.pw > 256 || geo.arows > 256 ||
      geo.Cg % 8 || (reinterpret_cast<uintptr_t>(x) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  // x (B, Hg, Wg, Cg) as (8 channels, Cg / 8 groups, Wg, Hg, B), strides in
  // bytes; a box is one 8-channel group of a halo tile
  CUtensorMap xmap;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(geo.Cg / 8),
                              static_cast<cuuint64_t>(geo.Wg),
                              static_cast<cuuint64_t>(geo.Hg), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {16, static_cast<cuuint64_t>(geo.Cg) * 2,
                                 static_cast<cuuint64_t>(geo.Wg) * geo.Cg * 2,
                                 static_cast<cuuint64_t>(geo.Hg) * geo.Wg * geo.Cg * 2};
  const cuuint32_t box[5] = {8, 1, static_cast<cuuint32_t>(geo.pw),
                             static_cast<cuuint32_t>(geo.arows), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<__nv_bfloat16*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap = {};
  if constexpr (TB) {
    // the forward's tiles [N tile][Cin chunk][tap][fkb / 8][fbn][8] as (8,
    // fbn, fkb / 8, N tiles x chunks, taps): a tile's chunks continue into
    // the next tile's, so a box past the last chunk of a tile reads weights
    // of columns past Cin, never stored
    const int ntiles = (geo.Cg + geo.fbn - 1) / geo.fbn;
    if (geo.fbn < SKB || geo.fbn % SKB || (geo.fkb != SKB && geo.fkb != BK) ||
        BN % geo.fkb || geo.fchunks != (geo.N + geo.fkb - 1) / geo.fkb ||
        (reinterpret_cast<uintptr_t>(wp) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t tap_bytes = static_cast<cuuint64_t>(geo.fkb) * geo.fbn * 2;
    const cuuint64_t wdims[4] = {static_cast<cuuint64_t>(geo.fbn) * 8,
                                 static_cast<cuuint64_t>(geo.fkb / 8),
                                 static_cast<cuuint64_t>(ntiles) * geo.fchunks,
                                 static_cast<cuuint64_t>(taps)};
    const cuuint64_t wstrides[3] = {static_cast<cuuint64_t>(geo.fbn) * 16, taps * tap_bytes,
                                    tap_bytes};
    const cuuint32_t wbox[4] = {SKB * 8, static_cast<cuuint32_t>(geo.fkb / 8),
                                static_cast<cuuint32_t>(BN / geo.fkb),
                                static_cast<cuuint32_t>(taps)};
    const cuuint32_t wunit[4] = {1, 1, 1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(wp),
               wdims, wstrides, wbox, wunit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      staged_bars_offset(BN, WGS, taps, geo.npix * geo.nplanes, split, geo.nst) +
      16 * geo.nst;
  auto kernel = tapconv_staged_kernel<WGS, BN, 3, 3, TB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long mtiles =
      static_cast<long long>(B) * geo.tiles * (geo.flat ? 1 : geo.H);
  if (mtiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mtiles), (geo.N + BN - 1) / BN, split);
  constexpr int NT = 128 * WGS + 32;
  if (split == 1) {
    kernel<<<grid, NT, smem, s>>>(xmap, wmap, wp, y, geo);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, wp, y, geo);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int forward_staged(const __nv_bfloat16* x, const __nv_bfloat16* wp, __nv_bfloat16* y,
                   int B, int H, int W, int Cin, int HO, int WO, int N, int Dh, int Dw,
                   int pad_top, int pad_left, int flat, int wgs, int bn, int split,
                   void* stream) {
  if (!forward_args_ok(B, H, W, Cin, HO, WO, N, Dh, Dw, pad_top, pad_left, flat, wgs,
                       split) ||
      (reinterpret_cast<uintptr_t>(wp) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SGeo geo{H, W, Cin, HO, WO, N, -pad_top, -pad_left, Dh, Dw,
           flat, 0, 0, 0, 0, (Cin + SKB - 1) / SKB, 0, 0, 0, 0, 1};
#define DCS_STAGED(BN) \
  (wgs == 2 ? launch_staged<2, BN>(s, x, wp, y, B, geo, split) \
            : launch_staged<1, BN>(s, x, wp, y, B, geo, split))
  switch (bn) {
    case 8:
      return DCS_STAGED(8);
    case 64:
      return DCS_STAGED(64);
    case 128:
      return DCS_STAGED(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DCS_STAGED
}

// The input gradient's bf16 class on the staged body (TB): g (B, HO, WO, N)
// read in place as zero-padded by gpad_top rows and gpad_left columns
// before it, the forward's packing wpf (bn_f, kb_f) read as it is.
int dgrad_staged(const __nv_bfloat16* g, const __nv_bfloat16* wpf, __nv_bfloat16* dx,
                 int B, int HO, int WO, int N, int H, int W, int Cin, int Dh, int Dw,
                 int gpad_top, int gpad_left, int flat, int wgs, int bn, int split, int bn_f,
                 int kb_f, void* stream) {
  if (!forward_args_ok(B, HO, WO, N, H, W, Cin, Dh, Dw, gpad_top, gpad_left, flat ? 1 : 0,
                       wgs, split) || flat < 0 || flat > 2 || kb_f < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SGeo geo{HO, WO, N, H, W, Cin, -gpad_top, -gpad_left, Dh, Dw,
           flat, 0, 0, 0, 0, (N + SKB - 1) / SKB, 0, bn_f, kb_f, (Cin + kb_f - 1) / kb_f, 1};
  switch (bn) {
    case 64:
      return wgs == 2 ? launch_staged<2, 64, true>(s, g, wpf, dx, B, geo, split)
                      : launch_staged<1, 64, true>(s, g, wpf, dx, B, geo, split);
    case 128:
      return wgs == 2 ? launch_staged<2, 128, true>(s, g, wpf, dx, B, geo, split)
                      : launch_staged<1, 128, true>(s, g, wpf, dx, B, geo, split);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the input gradient's bf16 class: the narrow-reduction body -----------
//
// Stands in for what the backward of pallas_tapconv.py:91 (tapconv_valid,
// whose backward JAX leaves to XLA: _updot_bwd, conv_engine.py:879-900)
// computes at bf16 where the reduction is narrow: a 3 x 3 input gradient
// whose reduction (the forward's N) is at most 8 channels and whose output
// (the forward's Cin) at most 32, dec6 of every variant (N = 4 for DR/DRS,
// 8 for DC/DCS; Cin = 32):
//   dx[b, h, w, c] = sum_{tap, n} g[b, h + oh + tap / 3, w + ow + tap % 3, n]
//                                 * w[8 - tap, c, n],
// g zero outside its extent, bf16 g and w, float32 sums, dx rounded once.
// What bounds it: bytes. At 32 x 128 x 128 it reads g (4.2 MB at N = 4)
// and writes dx (33.6 MB): 0.0113 ms at 3.35 TB/s, against 1.2 GFLOP of
// products, about a microsecond on the tensor cores. So the design keeps
// every byte moving once and the products out of the way:
// * g is read once, through a halo tile in shared memory: (4 + 2) rows x
//   (64 + 2) pixels of C = 4 or 8 channels (N padded to C with zeros), one
//   cp.async of 8 or 16 bytes a pixel, zero-filled outside g.
// * The taps are folded into the reduction: k = C tap + n, so a k16 step
//   carries 2 taps of 8 channels or 4 of 4; K = 72 -> 80 and 36 -> 48 (the
//   slots past tap 8 read tap 8's pixels against zero weights), in place of
//   9 steps of 16 or 32 channels.
// * mma.sync m16n8k16 (bf16, float32 sums), not wgmma: the N tile is
//   exactly 32 (4 n8 tiles), an A register is one 32-bit word of the halo
//   tile (two channels of one tap at one pixel; a fragment's 8 pixels x 4
//   words fall on 32 banks at C = 8), and the B fragments, 9 x C x 32
//   weights at most 4.6 KB, are read from w as it is (no packing launch)
//   into registers once a block: wgmma would need its B in shared memory
//   in core-matrix order and a 64-row M tile of consecutive halo pixels.
// * The columns of the N tile are permuted (column 2i + e of n8 tile j is
//   channel 8i + 2j + e), so a thread's accumulators of one pixel are 8
//   consecutive channels: dx goes out as whole 64-byte pixels, a 16-byte
//   store a thread, 512 contiguous bytes a warp instruction.
// * A block (4 warps, one output row each, four m16 tiles along it) walks
//   its tiles with a two-stage ring: the next tile's halo copy flies while
//   this tile's products and stores run; 4 blocks an SM.
constexpr int kNarrowRows = 4;                 // output rows a tile: one a warp
constexpr int kNarrowCols = 64;                // output columns a tile
constexpr int kNarrowHaloR = kNarrowRows + 2, kNarrowHaloW = kNarrowCols + 2;
constexpr int kNarrowBlocksPerSm = 4;

struct NGeo {
  int HO, WO, N;       // g (B, HO, WO, N)
  int H, W, Cin;       // dx (B, H, W, Cin)
  int oh, ow;          // dx (h, w) at tap (dh, dw) reads g (h + oh + dh, w + ow + dw)
  int rtiles, ctiles;  // tiles of an image: down its rows, along its columns
  long long ntiles;    // tiles of the batch
  int vec;             // 1: N == C and g 2 C-byte aligned (one copy a pixel)
};

// d (16 x 8, float32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// BYTES (4, 8 or 16) from global to shared memory, zero-filled past src_bytes
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(BYTES), "r"(src_bytes)
               : "memory");
}

// C channels a tap in the folded reduction (4 or 8). Grid: a few blocks an
// SM, each walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <int C>
__global__ void __launch_bounds__(32 * kNarrowRows)
dgrad_narrow_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ dx, const NGeo geo) {
  constexpr int S = (9 * C + 15) / 16;  // k16 steps of the folded reduction
  constexpr int HP = kNarrowHaloR * kNarrowHaloW, WP = C / 2;  // words a pixel
  __shared__ __align__(16) __nv_bfloat16 halo[2][HP * C];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & 3, gi = lane >> 2;

  // the halo tile of tile t into buffer `buf`
  auto stage = [&](long long t, int buf) {
    const int per_img = geo.rtiles * geo.ctiles;
    const int b = static_cast<int>(t / per_img), rest = static_cast<int>(t % per_img);
    const int r0 = (rest / geo.ctiles) * kNarrowRows + geo.oh;
    const int c0 = (rest % geo.ctiles) * kNarrowCols + geo.ow;
    for (int p = tid; p < HP; p += 32 * kNarrowRows) {
      const int r = p / kNarrowHaloW, gh = r0 + r, gw = c0 + p - r * kNarrowHaloW;
      const bool in = gh >= 0 && gh < geo.HO && gw >= 0 && gw < geo.WO;
      const long long off =
          in ? ((static_cast<long long>(b) * geo.HO + gh) * geo.WO + gw) * geo.N : 0;
      __nv_bfloat16* dst = halo[buf] + p * C;
      if (geo.vec) {
        cp_async_ca<2 * C>(smem_u32(dst), g + off, in ? 2 * C : 0);
      } else {
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          dst[ch] = in && ch < geo.N ? g[off + ch] : __ushort_as_bfloat16(0);
      }
    }
  };

  long long t = blockIdx.x;
  if (t < geo.ntiles) stage(t, 0);
  cp_async_commit();

  // B: register half e of k16 step s holds k = 16 s + 2 q + 8 e and k + 1,
  // tap k / C, channels k % C and k % C + 1, of column gi of each n8 tile j:
  // output channel 8 (gi / 2) + 2 j + gi % 2. A: the same k of the tile's
  // pixels gi and gi + 8, words aoff[s][e] past the pixel's tap-(0, 0) word
  // (a slot past tap 8 reads tap 8)
  uint32_t bw[S][4][2];
  int aoff[S][2];
#pragma unroll
  for (int st = 0; st < S; ++st)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 16 * st + 2 * q + 8 * e, tap = k / C, ch = k % C;
      const int tc = tap < 9 ? tap : 8;
      aoff[st][e] = ((tc / 3) * kNarrowHaloW + tc % 3) * WP + ch / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * (gi >> 1) + 2 * j + (gi & 1);
        const long long base = (static_cast<long long>(8 - tc) * geo.Cin + c) * geo.N + ch;
        const bool live = tap < 9 && c < geo.Cin;
        const __nv_bfloat16 lo =
            live && ch < geo.N ? w[base] : __ushort_as_bfloat16(0);
        const __nv_bfloat16 hi =
            live && ch + 1 < geo.N ? w[base + 1] : __ushort_as_bfloat16(0);
        bw[st][j][e] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
                       (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
      }
    }

  const bool vec_out = (geo.Cin & 7) == 0;
  for (int i = 0; t < geo.ntiles; ++i, t += gridDim.x) {
    if (t + gridDim.x < geo.ntiles) stage(t + gridDim.x, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(halo[i & 1]);
    const int per_img = geo.rtiles * geo.ctiles;
    const int b = static_cast<int>(t / per_img), rest = static_cast<int>(t % per_img);
    const int h = (rest / geo.ctiles) * kNarrowRows + warp;
    const int w0 = (rest % geo.ctiles) * kNarrowCols;
    if (h < geo.H) {
#pragma unroll
      for (int mt = 0; mt < kNarrowCols / 16; ++mt) {
        if (w0 + 16 * mt < geo.W) {
          float acc[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
          const int p0 = (warp * kNarrowHaloW + 16 * mt + gi) * WP, p1 = p0 + 8 * WP;
#pragma unroll
          for (int st = 0; st < S; ++st) {
            const uint32_t a0 = hw[p0 + aoff[st][0]], a1 = hw[p1 + aoff[st][0]];
            const uint32_t a2 = hw[p0 + aoff[st][1]], a3 = hw[p1 + aoff[st][1]];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_16816(acc[j], a0, a1, a2, a3, bw[st][j][0], bw[st][j][1]);
          }
          // pixels gi and gi + 8 of the m16 tile: channels 8 q .. 8 q + 7
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int wc = w0 + 16 * mt + gi + 8 * e;
            if (wc >= geo.W || 8 * q >= geo.Cin) continue;
            __align__(16) __nv_bfloat162 v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = __floats2bfloat162_rn(acc[j][2 * e], acc[j][2 * e + 1]);
            __nv_bfloat16* dst =
                dx + ((static_cast<long long>(b) * geo.H + h) * geo.W + wc) * geo.Cin + 8 * q;
            if (vec_out) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
            } else {
              const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(v);
              for (int k = 0; k < 8 && 8 * q + k < geo.Cin; ++k) dst[k] = vs[k];
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }
  cp_async_wait<0>();
}

int dgrad_narrow(const __nv_bfloat16* g, const __nv_bfloat16* w, __nv_bfloat16* dx, int B,
                 int HO, int WO, int N, int H, int W, int Cin, int Dh, int Dw, int pad_top,
                 int pad_left, void* stream) {
  const int pad_bottom = HO - H - pad_top + 2, pad_right = WO - W - pad_left + 2;
  if (B < 1 || HO < 1 || WO < 1 || N < 1 || N > 8 || H < 1 || W < 1 || Cin < 1 ||
      Cin > 32 || Dh != 3 || Dw != 3 || pad_top < 0 || pad_top > 2 || pad_left < 0 ||
      pad_left > 2 || pad_bottom < 0 || pad_bottom > 2 || pad_right < 0 || pad_right > 2 ||
      (reinterpret_cast<uintptr_t>(dx) & 15) || (reinterpret_cast<uintptr_t>(w) & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = N <= 4 ? 4 : 8;
  NGeo geo{HO, WO, N, H, W, Cin, pad_top - (Dh - 1), pad_left - (Dw - 1),
           (H + kNarrowRows - 1) / kNarrowRows, (W + kNarrowCols - 1) / kNarrowCols, 0,
           N == C && (reinterpret_cast<uintptr_t>(g) & (2 * C - 1)) == 0};
  geo.ntiles = static_cast<long long>(B) * geo.rtiles * geo.ctiles;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = geo.ntiles < static_cast<long long>(sms) * kNarrowBlocksPerSm
                             ? geo.ntiles
                             : static_cast<long long>(sms) * kNarrowBlocksPerSm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 4)
    dgrad_narrow_kernel<4><<<static_cast<unsigned>(grid), 32 * kNarrowRows, 0, s>>>(g, w, dx,
                                                                                   geo);
  else
    dgrad_narrow_kernel<8><<<static_cast<unsigned>(grid), 32 * kNarrowRows, 0, s>>>(g, w, dx,
                                                                                   geo);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int forward(const Elem<BF16>* x, const Elem<BF16>* wp, Elem<BF16>* y, int B, int H,
            int W, int Cin, int HO, int WO, int N, int Dh, int Dw, int pad_top,
            int pad_left, int flat, int wgs, int bn, int split, void* stream) {
  if (!forward_args_ok(B, H, W, Cin, HO, WO, N, Dh, Dw, pad_top, pad_left, flat, wgs,
                       split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo{H, W, Cin, HO, WO, N, -pad_top, -pad_left, Dh, Dw,
          flat, 0, 0, 0, (Cin + BK - 1) / BK};
  switch (bn) {
    case 8:
      return launch_tiled<BK, 8, BF16>(s, x, wp, y, B, geo, wgs, split);
    case 64:
      return launch_tiled<BK, 64, BF16>(s, x, wp, y, B, geo, wgs, split);
    case 128:
      return launch_tiled<BK, 128, BF16>(s, x, wp, y, B, geo, wgs, split);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool BF16>
int clusters_at(int wgs, int smem, int split, int* clusters) {
  constexpr int TPS = kTapsPerStage<BK, 128>, V = BF16 ? 8 : 4;
  auto kernel = wgs == 2 ? tapconv_kernel<2, BK, 128, TPS, V, true, BF16>
                         : tapconv_kernel<1, BK, 128, TPS, V, true, BF16>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split);
  cfg.blockDim = dim3(128 * wgs);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

int staged_clusters_at(int wgs, int smem, int split, int* clusters) {
  auto kernel = wgs == 2 ? tapconv_staged_kernel<2, 128, 3, 3>
                         : tapconv_staged_kernel<1, 128, 3, 3>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split);
  cfg.blockDim = dim3(128 * wgs + 32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8:
      return pack<BK, 8>(w, wp, taps, Cin, N, false, s);
    case 64:
      return pack<BK, 64>(w, wp, taps, Cin, N, false, s);
    case 128:
      return pack<BK, 128>(w, wp, taps, Cin, N, false, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 class's packing: w (taps, Cin, N) bf16 -> wp, the K-major bf16
// tiles of width bn (8, 64 or 128) in kb-channel chunks (16 for the staged
// body, 32 for the tap body) described above pack_bf16_kernel:
// ceil(N/bn) * ceil(Cin/kb) * taps * kb * bn bf16, 16-byte aligned.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int dcs_tapconv_pack_bf16(const void* w, void* wp, int taps, int Cin,
                                     int N, int bn, int kb, void* stream) {
  if (taps < 1 || Cin < 1 || N < 1 || (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (kb != SKB && kb != BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* out = static_cast<__nv_bfloat16*>(wp);
  if (kb == SKB) {
    switch (bn) {
      case 8:
        return pack_bf16<SKB, 8>(wb, out, taps, Cin, N, s);
      case 64:
        return pack_bf16<SKB, 64>(wb, out, taps, Cin, N, s);
      case 128:
        return pack_bf16<SKB, 128>(wb, out, taps, Cin, N, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (bn) {
    case 8:
      return pack_bf16<BK, 8>(wb, out, taps, Cin, N, s);
    case 64:
      return pack_bf16<BK, 64>(wb, out, taps, Cin, N, s);
    case 128:
      return pack_bf16<BK, 128>(wb, out, taps, Cin, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The input gradient's bf16 class, its packing: the tiles
// dcs_tapconv_pack_bf16 would write at the same bn and kb for w (taps, Cin,
// N) bf16 with its taps reversed and its channel axes swapped (reduction
// over N, Cin out): ceil(Cin/bn) * ceil(N/kb) * taps * kb * bn bf16. The
// forward's bf16 bodies then run the input gradient as the VALID tap
// correlation of g, zero-padded by Dh - 1 - pad_top rows before it (and so
// for the other sides), with these weights: the overlap-add of g K^T summed
// in float32 and rounded once. Launches on `stream`, returns
// cudaGetLastError().
extern "C" int dcs_tapconv_pack_dgrad_bf16(const void* w, void* wp, int taps, int Cin,
                                           int N, int bn, int kb, void* stream) {
  if (taps < 1 || Cin < 1 || N < 1 || (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (kb != SKB && kb != BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* out = static_cast<__nv_bfloat16*>(wp);
  if (kb == SKB) {
    switch (bn) {
      case 8:
        return pack_bf16<SKB, 8, true>(wb, out, taps, N, Cin, s);
      case 64:
        return pack_bf16<SKB, 64, true>(wb, out, taps, N, Cin, s);
      case 128:
        return pack_bf16<SKB, 128, true>(wb, out, taps, N, Cin, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (bn) {
    case 8:
      return pack_bf16<BK, 8, true>(wb, out, taps, N, Cin, s);
    case 64:
      return pack_bf16<BK, 64, true>(wb, out, taps, N, Cin, s);
    case 128:
      return pack_bf16<BK, 128, true>(wb, out, taps, N, Cin, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y = the tap correlation of x zero-padded by pad_top rows and pad_left
// columns before it (and by what HO and WO imply after it):
//   y[b, h, w, n] = sum_{dh, dw, c} x[b, h + dh - pad_top, w + dw - pad_left, c]
//                                   * w[dh * Dw + dw, c, n],
// x zero outside its extent. x (B, H, W, Cin) f32, read in place; wp the
// packed weights of dcs_tapconv_pack at the same bn (8, 64 or 128);
// y (B, HO, WO, N) f32. flat = 1 tiles BM = 64 * wgs consecutive output
// pixels of an image (several short rows), 0 one output row at a time; wgs
// is 1 or 2; split (1 to 8) blocks of one output tile divide the channel
// chunks among them, a cluster that adds their partial tiles in rank order.
// All contiguous and 16-byte aligned. Launches on `stream`, allocates
// nothing, returns cudaGetLastError(); a tiling whose halo tile does not
// fit shared memory beside the B ring (at 64 pixels, Dh * (63 + Dw) > 931
// at N > 8) is cudaErrorInvalidValue.
extern "C" int dcs_tapconv_valid(const float* x, const float* wp, float* y,
                                 int B, int H, int W, int Cin, int HO, int WO,
                                 int N, int Dh, int Dw, int pad_top,
                                 int pad_left, int flat, int wgs, int bn,
                                 int split, void* stream) {
  return forward<false>(x, wp, y, B, H, W, Cin, HO, WO, N, Dh, Dw, pad_top, pad_left,
                        flat, wgs, bn, split, stream);
}

// The forward's bf16 class, its staged body: the same function and
// arguments as dcs_tapconv_valid with x (B, H, W, Cin), wp
// (dcs_tapconv_pack_bf16's) and y (B, HO, WO, N) bf16, float32 sums (a
// split's partial tiles added in float32) rounded once to bf16 at the
// store; flat tiles in halo coordinates (staged_tiles). A tiling whose ring
// of two stages (every tap's weights and the halo tile of a 32-channel
// chunk) does not fit shared memory is cudaErrorInvalidValue: the wrapper
// routes such shapes to the tap body.
extern "C" int dcs_tapconv_valid_bf16(const void* x, const void* wp, void* y, int B,
                                      int H, int W, int Cin, int HO, int WO, int N,
                                      int Dh, int Dw, int pad_top, int pad_left,
                                      int flat, int wgs, int bn, int split,
                                      void* stream) {
  return forward_staged(static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(wp),
                        static_cast<__nv_bfloat16*>(y), B, H, W, Cin, HO, WO, N, Dh, Dw,
                        pad_top, pad_left, flat, wgs, bn, split, stream);
}

// The forward's bf16 class, its tap body (the shapes the staged body does
// not take): the float32 kernel's template at bf16, one wgmma m64nNk16 a
// 16-channel half of a tap's chunk, A fragments read by each thread.
extern "C" int dcs_tapconv_valid_bf16_tap(const void* x, const void* wp, void* y, int B,
                                          int H, int W, int Cin, int HO, int WO, int N,
                                          int Dh, int Dw, int pad_top, int pad_left,
                                          int flat, int wgs, int bn, int split,
                                          void* stream) {
  return forward<true>(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(wp),
                       static_cast<__nv_bfloat16*>(y), B, H, W, Cin, HO, WO, N, Dh, Dw,
                       pad_top, pad_left, flat, wgs, bn, split, stream);
}

// How many clusters of `split` blocks of the kernel at `wgs` warpgroups and
// `smem` bytes of dynamic shared memory the card runs at once
// (cudaOccupancyMaxActiveClusters), into *clusters: the wrapper counts a
// split's waves by it; bf16 = 1 asks for the bf16 class's tap body, 2 for
// its staged body (wgs consumer warpgroups and the producer). A
// cluster's blocks must share one GPC, so this is fewer than SMs / split: on
// the H100 at one block an SM, 66 clusters of 2, 30 of 4 and 15 of 8.
extern "C" int dcs_tapconv_clusters(int wgs, int smem, int split, int bf16,
                                    int* clusters) {
  if ((wgs != 1 && wgs != 2) || split < 1 || split > 8 || smem < 0 ||
      static_cast<size_t>(smem) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16 == 2) return staged_clusters_at(wgs, smem, split, clusters);
  return bf16 ? clusters_at<true>(wgs, smem, split, clusters)
              : clusters_at<false>(wgs, smem, split, clusters);
}

// The input gradient's weights, packed straight from the forward's w (taps,
// Cin, N): the tiles dcs_tapconv_pack would write for w with its taps
// reversed and its channel axes swapped (reduction over N, Cin out), in
// kb-channel chunks (32, or 8 in the small-K class) and bn-wide N tiles (32,
// 64 or 128): ceil(Cin/bn) * ceil(N/kb) * taps * 2 * kb * bn floats.
extern "C" int dcs_tapconv_pack_dgrad(const float* w, float* wp, int taps,
                                      int Cin, int N, int kb, int bn,
                                      void* stream) {
  if (taps < 1 || Cin < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kb == 8 && bn == 32) return pack<8, 32>(w, wp, taps, N, Cin, true, s);
  if (kb != BK) return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 32:
      return pack<BK, 32>(w, wp, taps, N, Cin, true, s);
    case 64:
      return pack<BK, 64>(w, wp, taps, N, Cin, true, s);
    case 128:
      return pack<BK, 128>(w, wp, taps, N, Cin, true, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The input gradient of y = tapconv_valid(pad(x), w): g (B, HO, WO, N), wp
// from dcs_tapconv_pack_dgrad at the same kb and bn, dx (B, H, W, Cin) where
// x was padded by pad_top rows and pad_left columns before it (HO = H +
// pad_top + pad_bottom - Dh + 1, and so for W), so that
//   dx[b, h, w, c] = sum_{dh, dw, n} g[b, h + pad_top - dh, w + pad_left - dw, n]
//                                    * w[dh * Dw + dw, c, n],
// g zero outside its extent. flat = 1 tiles BM = 64 * wgs consecutive pixels
// of an image (several short rows), 0 one output row at a time; wgs is 1 or
// 2. All contiguous and 16-byte aligned. Launches on `stream`, allocates
// nothing, returns cudaGetLastError(); a tiling whose halo tile does not fit
// shared memory is cudaErrorInvalidValue.
extern "C" int dcs_tapconv_dgrad(const float* g, const float* wp, float* dx,
                                 int B, int HO, int WO, int N, int H, int W,
                                 int Cin, int Dh, int Dw, int pad_top,
                                 int pad_left, int flat, int wgs, int kb, int bn,
                                 void* stream) {
  if (B < 1 || HO < 1 || WO < 1 || N < 1 || H < 1 || W < 1 || Cin < 1 ||
      Dh < 1 || Dw < 1 || pad_top < 0 || pad_left < 0 || (flat != 0 && flat != 1) ||
      (wgs != 1 && wgs != 2) || static_cast<long long>(H) * W > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo{HO, WO, N, H, W, Cin, pad_top - (Dh - 1), pad_left - (Dw - 1), Dh, Dw,
          flat, 0, 0, 0, (N + kb - 1) / kb};
  if (kb == 8 && bn == 32) return launch_tiled<8, 32, false>(s, g, wp, dx, B, geo, wgs, 1);
  if (kb != BK) return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 32:
      return launch_tiled<BK, 32, false>(s, g, wp, dx, B, geo, wgs, 1);
    case 64:
      return launch_tiled<BK, 64, false>(s, g, wp, dx, B, geo, wgs, 1);
    case 128:
      return launch_tiled<BK, 128, false>(s, g, wp, dx, B, geo, wgs, 1);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The input gradient's bf16 class on the staged body, reading the forward's
// packed weights as they are: g (B, HO, WO, N) bf16 read in place as
// zero-padded by gpad_top rows and gpad_left columns before it (the
// window less the forward's padding), wpf the tiles dcs_tapconv_pack_bf16
// wrote for the forward's w (taps, Cin, N) at N tile bn_f (64 or 128) and
// chunk kb_f (16 or 32), dx (B, H, W, Cin) bf16:
//   dx[b, h, w, c] = sum_{dh, dw, n} g[b, h - gpad_top + dh, w - gpad_left + dw, n]
//                                    * w[(Dh - 1 - dh) * Dw + Dw - 1 - dw, c, n],
// float32 sums rounded once; the plan (flat, wgs, bn, split) the forward
// staged body's for that correlation, flat = 2 its flat tiles in planes
// (staged_tiles). Launches on `stream`, returns
// cudaGetLastError(); a shape the staged body does not take is
// cudaErrorInvalidValue.
extern "C" int dcs_tapconv_dgrad_bf16(const void* g, const void* wpf, void* dx, int B,
                                      int HO, int WO, int N, int H, int W, int Cin, int Dh,
                                      int Dw, int gpad_top, int gpad_left, int flat, int wgs,
                                      int bn, int split, int bn_f, int kb_f, void* stream) {
  return dgrad_staged(static_cast<const __nv_bfloat16*>(g),
                      static_cast<const __nv_bfloat16*>(wpf), static_cast<__nv_bfloat16*>(dx),
                      B, HO, WO, N, H, W, Cin, Dh, Dw, gpad_top, gpad_left, flat, wgs, bn,
                      split, bn_f, kb_f, stream);
}

// The input gradient's bf16 class at a narrow reduction (the notes above
// dgrad_narrow_kernel): g (B, HO, WO, N) bf16, N <= 8, w (9, Cin, N) bf16
// as the forward holds it, Cin <= 32, dx (B, H, W, Cin) bf16 of the input
// the forward padded by pad_top rows and pad_left columns before it (each at
// most 2; HO, WO give the padding after):
//   dx[b, h, w, c] = sum_{dh, dw, n} g[b, h + pad_top - dh, w + pad_left - dw, n]
//                                    * w[dh * 3 + dw, c, n],
// g zero outside its extent, float32 sums rounded once. dx 16-byte aligned.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int dcs_tapconv_dgrad_narrow_bf16(const void* g, const void* w, void* dx, int B,
                                             int HO, int WO, int N, int H, int W, int Cin,
                                             int Dh, int Dw, int pad_top, int pad_left,
                                             void* stream) {
  return dgrad_narrow(static_cast<const __nv_bfloat16*>(g),
                      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(dx),
                      B, HO, WO, N, H, W, Cin, Dh, Dw, pad_top, pad_left, stream);
}
