// int8-activation x int4-weight matmul for Hopper (sm_90a), on the int8
// tensor cores through wgmma:
//
//   y = diag(x_scale) . sum_g f32(x_q[:, g] . W4[g]) * s_g
//
// Replaces chatts_tpu/ops/int4_matmul.py::int4_matmul_a8 (Pallas body
// `_kernel_a8`), the prefill matmul of qwen._dense with act_int8.
//
// Layout (the interchange format of the JAX package, unchanged):
//   x_q     (R, IN)       int8, activations quantized per row
//   x_scale (R,)          f32, their row scales
//   packed  (IN/2, OUT)   int8, byte i holds logical row 2i in its low nibble
//                         and row 2i+1 in its high nibble, both signed
//                         (-8 included: GPTQ imports carry it)
//   scales  (IN/128, OUT) f32, one scale per 128-row group
//   y       (R, OUT)      bf16
//
// What bounds it on the H100: prefill has R in the thousands, so each weight
// byte is used for thousands of multiply-adds and the kernel is bound by
// arithmetic: 2 R IN OUT int8 operations at 1,979 TOP/s.  The tensor cores
// take s8 but no s4, so the nibbles become s8 on the way.  Beside the tensor
// cores, every 128 of K each output needs its int32 sum made an f32, scaled
// and added (four instructions against the four cycles its 128 multiply-adds
// take a tensor-core lane), and each weight word its unpacking on the
// half-rate integer pipe, so the CUDA cores' instruction rate, not the
// tensor cores', sets this kernel's pace.
//
// What held the first version back: one block an SM with one shared-memory
// buffer and two block barriers a group, the next group's loads held in
// registers; the weight tile transposed through shared memory (four nibble
// extractions, eight byte permutes and four scalar stores a thread and
// group, read back as scalar fragments: 24 shared-memory loads for 16
// mma.sync a k-step); 64 int-to-float conversions a thread and group at a
// quarter of the multiply-add rate; and mma.sync, which tops out near 60% of
// the int8 peak on this card.  On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2) a 14B layer's four projections at R = 4,096 took
// 7.271 ms against a bound of 1.139 ms.
//
// Design:
//   * The operands are swapped: a warpgroup computes a tile of y^T, 128
//     output columns x 64 rows of x, as two
//     wgmma.mma_async.m64n64k32.s32.s8.s8 a k-step.  The weights are wgmma's
//     A operand, from registers, where they are made from the packed bytes;
//     x_q is its B operand, from shared memory, where its row-major (R, IN)
//     tile already is the K-major layout the 8-bit wgmma takes.  No weight
//     is written back to shared memory.
//   * A block is a producer and one or two consumer warpgroups (128 or 256
//     output columns x 64 rows; ops/int4_matmul.py picks by R).  One thread
//     of the producer keeps a ring of 6 stages full by TMA: per 128-row group
//     the x_q tile (64 rows x 128 bytes, 128-byte swizzle; rows past R arrive
//     as zeros), each warpgroup's packed weight tile (64 packed rows x 128
//     columns, the same swizzle) and the group's scales.  Full and empty
//     mbarriers hand the stages over: no block-wide barrier in the loop and
//     no global load through registers.  With two consumer warpgroups the
//     producer is a whole warpgroup (three warps idle) that gives its
//     registers to the consumers (setmaxnreg: 40 and 232 of the 168 a thread
//     the block is launched with).  The role branches test the warp's index
//     broadcast by a shuffle, so the compiler knows them uniform; with
//     thread-dependent tests it serialized every wgmma.
//   * A fragment from the packed bytes: A's row m of m-tile mt, half h, is
//     the output column 32 w + 4 fg + 2 mt + h of the warpgroup's 128 (warp
//     w, fragment row fg), so the four bytes of one 32-bit word of a packed
//     row (four columns, two K each) serve both m-tiles.  Two words (four
//     consecutive K of four columns) become four A registers by three
//     logical operations a word and eight byte permutes.  A nibble goes to
//     the high half of its byte, so the s8 value is 16 q (-8 gives -128) and
//     no sign extension is needed; a group's int32 sum is 16 times the true
//     one, at most 128 * 127 * 8 * 16 < 2^22, still exact, and the group's
//     scale is taken times 1/16 (exact for a scale of 2^-122 and more), so
//     f32(16 sum) * (s / 16) has the bits of f32(sum) * s.
//   * A group's first wgmma has scale-d = 0, so no register is zeroed.  Its
//     int32 sums become f32 by the conversion instruction, which has a pipe
//     of its own: the integer pipe, busy with the unpacking, is the scarce
//     one here (an integer add of 0x4B400000 and a float subtract instead
//     made the layer 9% slower on the H100).
//     Then, as the plain version (int4_matmul_a8_reference): the product
//     with the group's scale and the addition to the f32 accumulator rounded
//     apart, in group order; at the flush the product with the row scale and
//     one rounding to bf16: the two agree to the bit.
//   * Overlap: two sets of int32 sums in alternation.  A group's wgmmas go
//     out in two halves of two k-steps (16 A registers at a time); under each
//     half the sums of the group before, one m-tile a half, are added to the
//     f32 accumulator.  A warpgroup releases its stage as soon as its group's
//     wgmmas are done, and the other warpgroup's wgmmas fill the tensor cores
//     while this one unpacks.
//   * The flush needs no transpose: a thread holds four consecutive output
//     columns of 16 rows, and a warp's store covers 64 contiguous bytes of
//     each of four rows of y.
//   Rows past R are never stored, so any R >= 1 works; OUT may be an odd
//   multiple of 128 (the last block's second warpgroup then has no columns
//   and leaves at once).
//
// On the same card (NVIDIA H100 80GB HBM3, 700 W; scripts/compare_port_kernels.py,
// CUDA-graph replay) the layer's four projections at R = 4,096 take 3.50 ms
// (626 to 659 TOP/s, 33% of the bound), at R = 37 0.147 ms against 0.464 ms,
// bit-equal to the plain version at every shape.  The CUDA cores still set
// the pace: see "still open" for this kernel in ROADMAP.md.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;          // K rows per group and per ring stage
constexpr int kRows = 64;            // rows of x a block (wgmma's N)
constexpr int kCols = 128;           // output columns a consumer warpgroup
constexpr int kStages = 6;           // ring depth
constexpr int kXBytes = kRows * kGroup;             // x_q tile: 8 KB
constexpr int kWBytes = (kGroup / 2) * kCols;       // a warpgroup's packed tile: 8 KB
constexpr uint64_t kWaitLimitNs = 4000000000ull;    // a wait this long is a fault: trap

template <int WGS>
struct Cfg {
  // Consumers, then the producer: one warp, or with two consumer warpgroups
  // a whole warpgroup (three of its warps idle) so that setmaxnreg can hand
  // its registers over: a block's pool is what its warps were launched with.
  static constexpr int kThreads = WGS * 128 + (WGS == 2 ? 128 : 32);
  static constexpr int kScaleBytes = 1024;          // up to 256 f32 scales
  static constexpr int kStageBytes = kXBytes + WGS * kWBytes + kScaleBytes;
  // Stages, 1 KB of slack to align them to the swizzle's 1 KB, the barriers.
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that outlasts
// any real load traps, so a fault shows as an error and not as a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 1023u) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      if (now - start > kWaitLimitNs) __trap();
    }
  }
}

// One box of a 2-D tensor map into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma's descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle: start address, 1 KB between 8-row groups, swizzle mode 1.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 64 s32, 32 registers a thread) = or += A (64 x 32 s8, registers) x
// B (32 x 64 s8, shared memory).  `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
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

// Two words of packed bytes (four columns each; w0 holds K k and k + 1 in its
// nibbles, w1 K k + 2 and k + 3) -> one register a column: four consecutive
// K as s8, each 16 times its nibble's signed value.
__device__ __forceinline__ void unpack_pair(uint32_t w0, uint32_t w1, uint32_t (&out)[4]) {
  const uint32_t l0 = (w0 << 4) & 0xF0F0F0F0u, h0 = w0 & 0xF0F0F0F0u;
  const uint32_t l1 = (w1 << 4) & 0xF0F0F0F0u, h1 = w1 & 0xF0F0F0F0u;
  const uint32_t t0 = __byte_perm(l0, h0, 0x5140), t1 = __byte_perm(l0, h0, 0x7362);
  const uint32_t u0 = __byte_perm(l1, h1, 0x5140), u1 = __byte_perm(l1, h1, 0x7362);
  out[0] = __byte_perm(t0, u0, 0x5410);
  out[1] = __byte_perm(t0, u0, 0x7632);
  out[2] = __byte_perm(t1, u1, 0x5410);
  out[3] = __byte_perm(t1, u1, 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

// Grid (ceil(R / 64), ceil(OUT / (128 WGS))): the row tiles of one column
// tile run together, so its weights come from device memory once.
template <int WGS>
__global__ void __launch_bounds__(Cfg<WGS>::kThreads, 1) int4_a8_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ xscale, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ y, int R, int IN, int OUT) {
  using C = Cfg<WGS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* stages = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + kStages * C::kStageBytes;  // kStages full, then empty
  const uint32_t empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x;
  // The warp's index, broadcast from lane 0 so that the compiler knows the
  // role branches below are uniform across a warp.
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * (kCols * WGS);
  const int groups = IN / kGroup;
  // Warpgroups of this block that have columns.
  const int active = min(WGS, (OUT - n0) / kCols);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_idx >= WGS * 4) {
    // Producer: one thread keeps the ring full.  With two consumer
    // warpgroups the producer warpgroup gives its registers to them.
    if constexpr (WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == WGS * 128) {
      const uint32_t stage_tx = kXBytes + active * (kWBytes + kCols * 4);
      for (int g = 0; g < groups; ++g) {
        const int s = g % kStages;
        const uint32_t full = full0 + 8 * s;
        // The first pass finds every stage free.
        mbar_wait(empty0 + 8 * s, ((g / kStages) & 1) ^ 1);
        mbar_expect_tx(full, stage_tx);
        const uint32_t dst = base + s * C::kStageBytes;
        tma_load_2d(dst, &x_map, g * kGroup, m0, full);
        for (int w = 0; w < active; ++w) {
          tma_load_2d(dst + kXBytes + w * kWBytes, &w_map, n0 + w * kCols, g * (kGroup / 2),
                      full);
        }
        bulk_load(dst + kXBytes + WGS * kWBytes,
                  scales + static_cast<size_t>(g) * OUT + n0, active * kCols * 4, full);
      }
    }
    return;
  }
  if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int wg = warp_idx >> 2;
  if (wg >= active) return;
  const int lane = tid & 31;
  const int warp = warp_idx & 3;  // within the warpgroup
  const int fg = lane >> 2;         // fragment row group
  const int ft = lane & 3;          // thread in the group
  // The thread's word of a packed row: columns 32 warp + 4 fg + (0..3) of the
  // warpgroup's 128.  Packed row pr holds it at chunk (cw / 4) ^ (pr & 7);
  // the thread reads rows with pr & 7 = 2 ft and 2 ft + 1.
  const int cw = 8 * warp + fg;
  const int c_local = wg * kCols + 4 * cw;
  const int w_even = 2 * ft * kCols + (((cw >> 2) ^ (2 * ft)) << 4) + (cw & 3) * 4;
  const int w_odd = (2 * ft + 1) * kCols + (((cw >> 2) ^ (2 * ft + 1)) << 4) + (cw & 3) * 4;

  float acc[2][32];
  // Two sets of a group's int32 sums: the wgmmas of one group fill one while
  // the other, the group before, is added to acc.  A group's first wgmma
  // overwrites its set.
  int sum_a[2][32], sum_b[2][32];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[mt][i] = 0.f;
      sum_a[mt][i] = 0;
      sum_b[mt][i] = 0;
    }
  float sc_prev[4] = {0.f, 0.f, 0.f, 0.f};

  // acc += f32(sum) * s for m-tile mt of a set: register 4 j + 2 h + e is
  // column 2 mt + h of the thread's four, row 8 j + 2 ft + e.
  auto add_scaled = [&](int (&sum)[2][32], int mt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float f = static_cast<float>(sum[mt][i]);
      acc[mt][i] = __fadd_rn(acc[mt][i], __fmul_rn(f, sc_prev[2 * mt + ((i >> 1) & 1)]));
    }
  };

  // Group g: its wgmmas into `cur`, in two halves of two k-steps, while the
  // group before, in `prev`, is added to acc, an m-tile a half.
  auto group = [&](int g, int (&cur)[2][32], int (&prev)[2][32]) {
    const int s = g % kStages;
    mbar_wait(full0 + 8 * s, (g / kStages) & 1);
    const uint8_t* stage = stages + s * C::kStageBytes;
    const uint8_t* wt = stage + kXBytes + wg * kWBytes;
    const uint64_t x_desc = kmajor_desc(base + s * C::kStageBytes);
    // The group's scales of the thread's four columns, times 1/16.
    const float4 s4 =
        *reinterpret_cast<const float4*>(stage + kXBytes + WGS * kWBytes + c_local * 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // A fragments of two k-steps: K 32 ks + 4 ft + (0..3) come from packed
      // rows 16 ks + 2 ft and + 1, K + 16 from eight rows on.
      uint32_t a[2][2][4];
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const uint8_t* rows = wt + 16 * (2 * half + k2) * kCols;
        uint32_t lo[4], hi[4];
        unpack_pair(*reinterpret_cast<const uint32_t*>(rows + w_even),
                    *reinterpret_cast<const uint32_t*>(rows + w_odd), lo);
        unpack_pair(*reinterpret_cast<const uint32_t*>(rows + 8 * kCols + w_even),
                    *reinterpret_cast<const uint32_t*>(rows + 8 * kCols + w_odd), hi);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[k2][mt][0] = lo[2 * mt];
          a[k2][mt][1] = lo[2 * mt + 1];
          a[k2][mt][2] = hi[2 * mt];
          a[k2][mt][3] = hi[2 * mt + 1];
        }
      }
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          wgmma_m64n64k32(cur[mt], a[k2][mt], x_desc + 2 * (2 * half + k2), half + k2 > 0);
        }
      wgmma_commit();
      if (g > 0) add_scaled(prev, half);  // under this half's wgmmas
      wgmma_wait_all();  // the A registers are free again
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(cur[mt][i])::"memory");
    // The stage is free: every warp read its words before its wgmmas began.
    if ((tid & 127) == 0) mbar_arrive(empty0 + 8 * s);
    sc_prev[0] = s4.x * 0.0625f;
    sc_prev[1] = s4.y * 0.0625f;
    sc_prev[2] = s4.z * 0.0625f;
    sc_prev[3] = s4.w * 0.0625f;
  };

  for (int g = 0; g < groups; g += 2) {
    group(g, sum_a, sum_b);
    if (g + 1 < groups) group(g + 1, sum_b, sum_a);
  }
  // The last group's sums.
  if (groups & 1) {
    add_scaled(sum_a, 0);
    add_scaled(sum_a, 1);
  } else {
    add_scaled(sum_b, 0);
    add_scaled(sum_b, 1);
  }

  // Flush: the accumulator times the row scale, rounded to bf16 once; four
  // consecutive columns a row.
  __nv_bfloat16* ycol = y + n0 + c_local;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * ft + e;
      if (row < R) {
        const float rs = __ldg(xscale + row);
        uint2 o;
        o.x = pack_bf16x2(__fmul_rn(acc[0][4 * j + e], rs), __fmul_rn(acc[0][4 * j + 2 + e], rs));
        o.y = pack_bf16x2(__fmul_rn(acc[1][4 * j + e], rs), __fmul_rn(acc[1][4 * j + 2 + e], rs));
        *reinterpret_cast<uint2*>(ycol + static_cast<size_t>(row) * OUT) = o;
      }
    }
}

// cuTensorMapEncodeTiled, looked up in the libcuda that the runtime already
// loaded (no link against it).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A map of a row-major (rows, cols) byte matrix in boxes of 64 rows x 128
// bytes under the 128-byte swizzle; what a box has past the matrix is zero.
bool byte_matrix_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {128, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WGS>
int launch(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* xscale,
           const float* scales, __nv_bfloat16* y, int R, int IN, int OUT, cudaStream_t stream) {
  using C = Cfg<WGS>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_a8_wgmma_kernel<WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((R + kRows - 1) / kRows, (OUT + kCols * WGS - 1) / (kCols * WGS));
  int4_a8_wgmma_kernel<WGS><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      x_map, w_map, xscale, scales, y, R, IN, OUT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Requires IN % 128 == 0, OUT % 128 == 0, R >= 1, 16-byte aligned pointers;
// `warpgroups` (1 or 2) consumer warpgroups a block, 128 output columns each.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another `warpgroups` or when the tensor maps cannot be made.
extern "C" int chatts_int4_matmul_a8(const void* xq, const void* xscale, const void* packed,
                                     const void* scales, void* y, int R, int IN, int OUT,
                                     int warpgroups, void* stream) {
  CUtensorMap x_map, w_map;
  if (!byte_matrix_map(&x_map, xq, R, IN) || !byte_matrix_map(&w_map, packed, IN / 2, OUT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const float*>(xscale);
  const auto* sc = static_cast<const float*>(scales);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (warpgroups == 1) return launch<1>(x_map, w_map, xs, sc, yb, R, IN, OUT, st);
  if (warpgroups == 2) return launch<2>(x_map, w_map, xs, sc, yb, R, IN, OUT, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
