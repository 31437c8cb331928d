// int8-activation x int4-weight matmul for Hopper (sm_90a), on the int8
// tensor cores:
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
// arithmetic.  The tensor cores take s8 (1,979 TOP/s dense) but no s4, so the
// nibbles are sign-extended to s8 on the way into shared memory.
//
// Design (a simple first version: mma.sync, no TMA or wgmma yet):
//   * One block owns a 128 x 128 output tile; 8 warps own 64 x 32 each, as
//     4 x 4 tiles of mma.sync.m16n8k32.s32.s8.s8.s32.
//   * The K loop steps one 128-row quantization group at a time.  A group's
//     products accumulate in int32 registers; |sum| <= 128 * 127 * 8 =
//     130,048 < 2^24, so the int32 sum and its conversion to f32 are exact.
//     Each group then adds f32(sum) * s_g to an f32 accumulator, multiply and
//     add rounded separately, in group order, and the flush multiplies by the
//     row scale and rounds to bf16 once: the plain version's order
//     (int4_matmul_a8_reference), so the two agree to the bit.
//   * Shared memory holds the group's x_q tile and its weight tile, both as
//     rows of 4-byte words along K (the mma fragments' layout), rows padded
//     to 36 words so each fragment load hits all 32 banks once.  The weight
//     tile is transposed on the way in: a thread reads one 4-byte word (four
//     columns) from each of two packed rows, sign-extends the 16 nibbles with
//     per-byte ops and regroups them with byte permutes into four words of
//     four consecutive K values, one per column.
//   * The next group's global loads are issued into registers before the
//     current group's mma, so their latency hides behind it.
//   Rows past R load as zero and are not stored, so any R >= 1 works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;                 // K rows per group and per loop step
constexpr int kBM = 128;                    // tile rows
constexpr int kBN = 128;                    // tile columns
constexpr int kThreads = 256;               // 8 warps: 2 along M x 4 along N
constexpr int kStride = kGroup / 4 + 4;     // shared row stride in 4-byte words
constexpr int kAChunks = kBM * kGroup / 16 / kThreads;        // 16-byte x_q loads a thread: 4
constexpr int kBItems = (kGroup / 4) * (kBN / 4) / kThreads;  // 2-row x 4-column items: 4

// The four signed nibbles in the low (high) halves of w's bytes, as four s8.
__device__ __forceinline__ uint32_t low_nibbles(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t high_nibbles(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

// Item i of a thread's weight loads: packed-row pair pp (logical rows
// 4pp..4pp+3) and column word c (columns 4c..4c+3).  A warp's 32 lanes cover
// 8 consecutive column words of 4 row pairs: 32 contiguous bytes a row.
__device__ __forceinline__ void weight_item(int item, int& pp, int& c) {
  c = (item & 7) | (((item >> 5) & 3) << 3);
  pp = ((item >> 3) & 3) | ((item >> 7) << 2);
}

__global__ void __launch_bounds__(kThreads, 1) int4_a8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xscale,
    const int8_t* __restrict__ packed, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ y, int R, int IN, int OUT) {
  __shared__ __align__(16) uint32_t As[kBM * kStride];  // x_q tile, [row][k word]
  __shared__ __align__(16) uint32_t Bs[kBN * kStride];  // s8 weights, [column][k word]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fg = lane >> 2;  // mma fragment: group of four lanes
  const int ft = lane & 3;   // mma fragment: lane within the group
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int groups = IN / kGroup;

  uint4 a_reg[kAChunks];
  uint32_t b_reg[kBItems][2];

  auto load = [&](int grp) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int gm = m0 + (chunk >> 3);
      a_reg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (gm < R) {
        a_reg[i] = __ldg(reinterpret_cast<const uint4*>(
            xq + static_cast<size_t>(gm) * IN + grp * kGroup + (chunk & 7) * 16));
      }
    }
#pragma unroll
    for (int i = 0; i < kBItems; ++i) {
      int pp, c;
      weight_item(tid + i * kThreads, pp, c);
      const int8_t* p =
          packed + static_cast<size_t>(grp * (kGroup / 2) + 2 * pp) * OUT + n0 + 4 * c;
      b_reg[i][0] = __ldg(reinterpret_cast<const unsigned int*>(p));
      b_reg[i][1] = __ldg(reinterpret_cast<const unsigned int*>(p + OUT));
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(chunk >> 3) * kStride + (chunk & 7) * 4]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kBItems; ++i) {
      int pp, c;
      weight_item(tid + i * kThreads, pp, c);
      // Byte j of each: column 4c + j at logical rows 4pp, +1 (first packed
      // row) and 4pp + 2, +3 (second).
      const uint32_t l0 = low_nibbles(b_reg[i][0]), h0 = high_nibbles(b_reg[i][0]);
      const uint32_t l1 = low_nibbles(b_reg[i][1]), h1 = high_nibbles(b_reg[i][1]);
      const uint32_t t0 = __byte_perm(l0, h0, 0x5140), t1 = __byte_perm(l0, h0, 0x7362);
      const uint32_t u0 = __byte_perm(l1, h1, 0x5140), u1 = __byte_perm(l1, h1, 0x7362);
      uint32_t* col = &Bs[(4 * c) * kStride + pp];
      col[0] = __byte_perm(t0, u0, 0x5410);
      col[kStride] = __byte_perm(t0, u0, 0x7632);
      col[2 * kStride] = __byte_perm(t1, u1, 0x5410);
      col[3 * kStride] = __byte_perm(t1, u1, 0x7632);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load(0);
  for (int grp = 0; grp < groups; ++grp) {
    store();
    __syncthreads();
    if (grp + 1 < groups) load(grp + 1);

    float2 s[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt] = __ldg(reinterpret_cast<const float2*>(
          scales + static_cast<size_t>(grp) * OUT + n0 + wn + nt * 8 + 2 * ft));
    }

    int isum[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) isum[mt][nt][e] = 0;

#pragma unroll
    for (int ks = 0; ks < kGroup / 32; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* pb = &Bs[(wn + nt * 8 + fg) * kStride + ks * 8 + ft];
        b[nt][0] = pb[0];
        b[nt][1] = pb[4];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* pa = &As[(wm + mt * 16 + fg) * kStride + ks * 8 + ft];
        const uint32_t a[4] = {pa[0], pa[8 * kStride], pa[4], pa[8 * kStride + 4]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(isum[mt][nt], a, b[nt]);
      }
    }

#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] = __fadd_rn(acc[mt][nt][0], __fmul_rn(static_cast<float>(isum[mt][nt][0]), s[nt].x));
        acc[mt][nt][1] = __fadd_rn(acc[mt][nt][1], __fmul_rn(static_cast<float>(isum[mt][nt][1]), s[nt].y));
        acc[mt][nt][2] = __fadd_rn(acc[mt][nt][2], __fmul_rn(static_cast<float>(isum[mt][nt][2]), s[nt].x));
        acc[mt][nt][3] = __fadd_rn(acc[mt][nt][3], __fmul_rn(static_cast<float>(isum[mt][nt][3]), s[nt].y));
      }
    __syncthreads();
  }

  // Flush: the accumulator times the row scale, rounded to bf16 once.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm + mt * 16 + fg + 8 * half;
      if (gm < R) {
        const float rs = xscale[gm];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(gm) * OUT + n0 + wn + nt * 8 +
                                       2 * ft) =
              pack_bf16x2(__fmul_rn(acc[mt][nt][2 * half], rs),
                          __fmul_rn(acc[mt][nt][2 * half + 1], rs));
        }
      }
    }
  }
}

}  // namespace

// Requires IN % 128 == 0, OUT % 128 == 0, R >= 1, x_q 16-byte aligned and
// the other pointers 8-byte aligned.  Returns cudaGetLastError() after the
// launch.
extern "C" int chatts_int4_matmul_a8(const void* xq, const void* xscale, const void* packed,
                                     const void* scales, void* y, int R, int IN, int OUT,
                                     void* stream) {
  const dim3 grid((R + kBM - 1) / kBM, OUT / kBN);
  int4_a8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xscale),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(y), R, IN, OUT);
  return static_cast<int>(cudaGetLastError());
}
