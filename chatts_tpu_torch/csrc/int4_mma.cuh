// B3's tensor-core main loop (csrc/int4_matmul.cu), shared with the routed
// experts' grouped GEMM (csrc/moe_int4.cu).
//
// A block has WM x 4 warps.  A warp owns MT m16 row tiles and 32 output
// columns (four n8 tiles), so a block computes a (WM*MT*16) x 128 tile of
// A @ (q * s), A bf16 (rows, IN), q int4 in B3's packed layout (IN/2, OUT),
// s f32 (IN/128, OUT).  A K step is one 128-row group:
//   * a 4-stage cp.async ring holds, per stage, the A tile (BM x 128 bf16,
//     its 16-byte chunks XOR-swizzled by row so that ldmatrix reads are free
//     of bank conflicts), the packed weight tile (64 x 128 bytes, chunks
//     swizzled by row) and the group's 128 scales;
//   * bf16 mma.sync.m16n8k16 sums into f32 partials that start at 0; at the
//     group's end the partials, times the group's scales, are added to the
//     f32 accumulators, the multiply and the add rounded apart.
// B fragments need no shuffle: a packed byte is the (k, k+1) pair of one
// column, which is one bf16x2 register of the m16n8k16 B fragment.  A warp's
// n8 tile j takes the columns 4c + j (c = the fragment's column), so the
// thread of fragment column c finds the registers of all four tiles in the
// four bytes of one 32-bit shared-memory word.  The accumulators then hold 8
// consecutive columns a thread: acc[mt][j][2h] is column 8*ft + j and
// acc[mt][j][2h + 1] column 8*ft + 4 + j of tile row mt*16 + fg + 8h.
//
// What the two kernels differ in is given as two small types:
//   Rows::src(row, p) sets p to the start of the A row behind tile row `row`
//     and returns whether it exists (a missing row is zero-filled);
//   Cols::operator()(tc) is the weight column of tile column tc.
// Each kernel keeps its own `__global__` entry and epilogue, so that a trace
// tells them apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int4_mma {

constexpr int kGroup = 128;
constexpr int kTileN = 128;                            // output columns a block
constexpr int kWarpsN = kTileN / 32;                   // warps along OUT
constexpr int kStages = 4;                             // cp.async ring depth
constexpr int kWTileBytes = (kGroup / 2) * kTileN;     // packed rows x columns
constexpr int kSTileBytes = kTileN * 4;                // one group's scales
constexpr int kXRowBytes = kGroup * 2;                 // one row of the A tile

template <int MT, int WM>
struct Cfg {
  static constexpr int kThreads = WM * kWarpsN * 32;
  static constexpr int kBM = WM * MT * 16;
  static constexpr int kXTileBytes = kBM * kXRowBytes;
  static constexpr int kStageBytes = kXTileBytes + kWTileBytes + kSTileBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 32-bit word of four packed bytes (four columns of one packed row) ->
// four bf16x2 B-fragment registers, b[j] = (q[2i][col j], q[2i+1][col j]).
// Exact: the byte is placed as (low nibble, high nibble) in the low mantissa
// bits of two bf16 128.0 (0x4300) with the sign bit flipped (XOR 8), and 136
// is subtracted by one bf16x2 fma: q in -8..7, -8 included.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t (&b)[4]) {
  const uint32_t wh = w >> 4;  // byte j's high nibble in the low bits of byte j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // Byte 0 <- byte j of w (low nibble: row 2i); byte 2 <- byte j of wh
    // (low nibble: row 2i+1); bytes 1 and 3 are masked off below.
    const uint32_t p = __byte_perm(w, wh, j | ((4 + j) << 8));
    // bf16 128 + (nibble ^ 8) in each half, then minus 136: the signed nibble.
    const uint32_t v = (p & 0x000F000Fu) ^ 0x43084308u;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(b[j])
        : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));  // v * 1.0 + (-136.0)
  }
}

// Issue the cp.async copies of group g into one stage.
template <int MT, int WM, class Rows, class Cols>
__device__ __forceinline__ void load_stage(uint8_t* stage, const Rows& rows, const Cols& cols,
                                           const int8_t* __restrict__ packed,
                                           const float* __restrict__ scales, int OUT, int g) {
  using C = Cfg<MT, WM>;
  const int tid = threadIdx.x;
  const uint32_t xs = smem_u32(stage);
  // A: BM rows x 16 chunks of 8 bf16; chunk c of row r at c ^ (r & 7).
  for (int i = tid; i < C::kBM * 16; i += C::kThreads) {
    const int row = i >> 4;
    const int c = i & 15;
    const __nv_bfloat16* src;
    const bool in = rows.src(row, src);
    cp_async16(xs + row * kXRowBytes + ((c ^ (row & 7)) << 4), src + g * kGroup + c * 8,
               in ? 16 : 0);
  }
  // Weights: 64 packed rows x 8 chunks of 16 columns; chunk c of row r at
  // c ^ ((r & 3) << 1).
  const uint32_t ws = xs + C::kXTileBytes;
  for (int i = tid; i < (kGroup / 2) * 8; i += C::kThreads) {
    const int row = i >> 3;
    const int c = i & 7;
    const int8_t* src = packed + static_cast<size_t>(g * (kGroup / 2) + row) * OUT + cols(c * 16);
    cp_async16(ws + row * kTileN + ((c ^ ((row & 3) << 1)) << 4), src, 16);
  }
  // The group's 128 scales.
  const uint32_t ss = ws + kWTileBytes;
  for (int i = tid; i < kTileN / 4; i += C::kThreads) {
    cp_async16(ss + i * 16, scales + static_cast<size_t>(g) * OUT + cols(i * 4), 16);
  }
}

// acc = the block's tile over groups [g_begin, g_begin + g_count), from
// zero; waits for every copy before it returns (smem is then free).
template <int MT, int WM, class Rows, class Cols>
__device__ __forceinline__ void mainloop(float (&acc)[MT][4][4], uint8_t* smem, const Rows& rows,
                                         const Cols& cols, const int8_t* __restrict__ packed,
                                         const float* __restrict__ scales, int OUT, int g_begin,
                                         int g_count) {
  using C = Cfg<MT, WM>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int fg = lane >> 2;  // fragment row group
  const int ft = lane & 3;   // thread in the group

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < g_count) {
      load_stage<MT, WM>(smem + s * C::kStageBytes, rows, cols, packed, scales, OUT, g_begin + s);
    }
    cp_async_commit();
  }

  // Per-thread shared-memory offsets inside a stage.
  // ldmatrix: lanes 0-15 give rows 0-15 at k 0-7, lanes 16-31 at k 8-15.
  const int a_row0 = wm * MT * 16 + (lane & 15);
  const int a_half = lane >> 4;
  // The thread's weight word: fragment column fg of the warp's 32 columns,
  // i.e. columns wn*32 + 4*fg + (0..3), in packed rows 8*kk + ft (+ 4).
  const int w_word = wn * 8 + fg;
  const int w_off = ((((w_word >> 2) ^ (ft << 1)) << 4)) + (w_word & 3) * 4 + ft * kTileN;
  // The thread's 8 output columns: wn*32 + 8*ft + (0..7).
  const int c_local = wn * 32 + 8 * ft;

  for (int it = 0; it < g_count; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = it + kStages - 1;
      if (nxt < g_count) {
        load_stage<MT, WM>(smem + (nxt % kStages) * C::kStageBytes, rows, cols, packed, scales,
                           OUT, g_begin + nxt);
      }
      cp_async_commit();
    }
    const uint8_t* stage = smem + (it % kStages) * C::kStageBytes;
    const uint32_t xs = smem_u32(stage);
    const uint8_t* ws = stage + C::kXTileBytes;
    const float* ss = reinterpret_cast<const float*>(ws + kWTileBytes);

    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;

#pragma unroll
    for (int kk = 0; kk < kGroup / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = a_row0 + mt * 16;
        const int c = 2 * kk + a_half;
        ldmatrix_x4(a[mt], xs + row * kXRowBytes + ((c ^ (row & 7)) << 4));
      }
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ws + w_off + (8 * kk) * kTileN);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ws + w_off + (8 * kk + 4) * kTileN);
      uint32_t b0[4], b1[4];
      unpack_word(w0, b0);
      unpack_word(w1, b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(part[mt][j], a[mt], b0[j], b1[j]);
    }

    // acc += part * s, per column, the multiply and the add rounded apart.
    const float4 s_lo = *reinterpret_cast<const float4*>(ss + c_local);
    const float4 s_hi = *reinterpret_cast<const float4*>(ss + c_local + 4);
    const float s[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // c0, c2: fragment column 2*ft -> column 8*ft + j; c1, c3: 8*ft + 4 + j.
        acc[mt][j][0] = __fadd_rn(acc[mt][j][0], __fmul_rn(part[mt][j][0], s[j]));
        acc[mt][j][1] = __fadd_rn(acc[mt][j][1], __fmul_rn(part[mt][j][1], s[4 + j]));
        acc[mt][j][2] = __fadd_rn(acc[mt][j][2], __fmul_rn(part[mt][j][2], s[j]));
        acc[mt][j][3] = __fadd_rn(acc[mt][j][3], __fmul_rn(part[mt][j][3], s[4 + j]));
      }
  }
  cp_async_wait<0>();
}

}  // namespace int4_mma
