// Weight-only int4 matmul for Hopper (sm_90a): y = x @ (q * s).
//
// Replaces chatts_tpu/ops/int4_matmul.py::int4_matmul (Pallas body `_kernel`).
//
// Layout (the interchange format of the JAX package, unchanged):
//   x       (R, IN)     bf16
//   packed  (IN/2, OUT) int8, byte i holds logical row 2i in its low nibble and
//                       row 2i+1 in its high nibble, both signed
//   scales  (IN/128, OUT) f32, one scale per 128-row group
//   y       (R, OUT)    bf16
//
// Arithmetic, in the TPU kernel's order (its L133-137): for each 128-row
// group g, d = x[:, g] @ q[g] summed in f32 on the tensor cores (q is exact in
// bf16 and every bf16 x int4 product is exact in f32), then acc += d * s_g in
// f32, the multiply and the add rounded apart, in group order; one rounding to
// bf16 at the end.  ops/int4_matmul.py::int4_matmul_grouped_reference is the
// plain version of exactly this.
//
// What bounds it on the H100: with few rows (decode, serving's 32 slots,
// short admissions) every weight byte is used for R multiply-adds, so the
// bytes (IN*OUT/2 packed + IN/128*OUT*4 scales) over 3.35 TB/s bound it.  With
// R in the hundreds and more it is the 2*R*IN*OUT bf16 tensor-core operations
// at 989 TFLOP/s.
//
// Two configurations, each its own `__global__` entry whose name holds
// `int4_mma_kernel` (the benchmark finds B3's device time by that name):
//   * Streaming (kStream, `int4_mma_kernel<MT, 1>`): csrc/int4_mma.cuh's
//     mma.sync main loop, shared with csrc/moe_int4.cu.  A block has 4 warps;
//     a warp owns MT m16 row tiles and 32 output columns, so a block computes
//     a (MT*16) x 128 tile, MT = min(4, ceil(R/16)).  Up to 64 rows live in
//     one block row (rows past R are zero-filled), so each weight byte is read
//     from device memory once; more rows take 64-row tiles, and later row
//     tiles find the weights in L2.  A K step is one 128-row group through a
//     4-stage cp.async ring of (x tile, packed tile, scales); B fragments come
//     from the packed bytes without a shuffle (int4_mma.cuh says how).  Where
//     the tiles cannot fill two blocks an SM, K is split into runs of whole
//     groups.
//   * GEMM (kGemm, `int4_mma_kernel_wg`): wgmma on B5's skeleton
//     (csrc/int4_matmul_a8.cu; the ring's pieces are csrc/tma_ring.cuh's).
//     The operands are swapped: a block computes a 128-column x 128-row tile
//     of y^T = W^T x^T.  The weights are wgmma's A operand, made in registers
//     from the packed bytes; x is its B operand, read by wgmma from shared
//     memory, where x's row-major (R, IN) tile already is the K-major layout
//     16-bit wgmma takes (TMA, 128-byte swizzle; rows past R arrive as
//     zeros).  Nothing of the weights goes back to shared memory.
//     - A block is two consumer warpgroups, 64 output columns each (one m64
//       tile of wgmma.m64n128k16), and a producer warpgroup whose one thread
//       keeps a 5-stage ring full by TMA: per 128-row group the x tile (two
//       boxes of 64 K x 128 rows), the packed tile (64 packed rows x 128
//       columns) and the group's 128 scales.  Full and empty mbarriers hand
//       the stages over: no block-wide barrier in the loop.  setmaxnreg gives
//       the producer's registers to the consumers (40 and 232 of the 168 a
//       thread the block is launched with).
//     - A fragments: A's row fg (fg + 8) of warp w is the output column
//       16 (4 wg + w) + 2 fg (+ 1), so the thread's two bytes of a packed row
//       are one 16-bit word; the words of packed rows k and k + 4 make one
//       32-bit word, which int4_mma::unpack_word turns into the k-step's four
//       A registers (its exact -8..7 trick).
//     - A group is two batches of four wgmmas into f32 partials, the first
//       with scale-d 0; the second batch's fragments are unpacked under the
//       first batch, and the next group's first batch's under the second.
//       Then acc += part * s per column, the multiply and the add rounded
//       apart, in group order; one rounding to bf16 at the end.
//     - What sets the pace is the CUDA cores' share: per group and thread
//       about 130 instructions of unpacking and 128 of scaling, which the
//       tensor cores do not hide.  On an H100 (700 W, at its power limit,
//       about 1.6 GHz) the loop without either ran at 77% of the dense peak
//       and with both at 54%; unpacking the next group under this one's
//       wgmmas, the two warpgroups taking turns at the tensor cores, and the
//       tile's rows in two halves each scaled under the other's wgmmas all
//       left it where it was, as did A read from shared memory.  An FFMA
//       would halve the scaling but round once where the plain version
//       rounds twice.
//     - Persistent: grid = min(units, SMs), a unit a (tile, split); a block
//       takes units blockIdx.x, + gridDim.x, ..., in bands of 16 column tiles
//       (row tile outer, column inner within a band), so the units in flight
//       share their x tiles and a band's weights in L2.  The producer runs on
//       into the next unit while the consumers store.  No atomics: two calls
//       agree to the bit.
//     - The store: a thread holds two adjacent output columns of 32 rows, so
//       each warp store writes whole 32-byte sectors of y (8 threads x 4
//       bytes of one row).  A tile stores its 32 KB once, after its whole K
//       loop, too little to pay for a transpose through shared memory.
//   * A split writes f32 partial sums to a workspace the caller allocates; a
//     second launch adds the splits in split order and rounds to bf16
//     (deterministic; no atomics).  The GEMM splits K only when its tiles
//     cannot fill the SMs once.
// Only the order of the f32 sums inside a group differs between the two
// configurations.
//
// ops/int4_matmul.py picks the configuration for R (the band, with the
// measurement behind it, is there).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_mma.cuh"
#include "tma_ring.cuh"

namespace {

using int4_mma::Cfg;
using int4_mma::kGroup;
using int4_mma::kTileN;
using int4_mma::kWarpsN;

// Paths; ops/int4_matmul.py passes one.
constexpr int kStream = 1;
constexpr int kGemm = 2;

// ---------------------------------------------------------------------------
// Tensor-core kernel
// ---------------------------------------------------------------------------

// The A rows of block row m0: x's rows m0.., those at R and past zero-filled.
struct DenseRows {
  const __nv_bfloat16* __restrict__ x;
  int R, IN, m0;
  __device__ __forceinline__ bool src(int row, const __nv_bfloat16*& p) const {
    const int gr = m0 + row;
    p = x + static_cast<size_t>(gr < R ? gr : 0) * IN;
    return gr < R;
  }
};

// The weight columns of block column n0: n0..n0 + 127.
struct DenseCols {
  int n0;
  __device__ __forceinline__ int operator()(int tc) const { return n0 + tc; }
};

// Grid: (OUT/128, ceil(R/BM), splits); split z takes groups
// [z*gps, min(G, (z+1)*gps)).  With one split it writes y in bf16, else f32
// partial sums to partial[z][R][OUT].
template <int MT, int WM>
__global__ void __launch_bounds__(Cfg<MT, WM>::kThreads) int4_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
    float* __restrict__ partial, int R, int IN, int OUT, int gps) {
  using C = Cfg<MT, WM>;
  extern __shared__ __align__(128) uint8_t smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int fg = lane >> 2;  // fragment row group
  const int ft = lane & 3;   // thread in the group
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * C::kBM;
  const int n_groups = IN / kGroup;
  const int g_begin = blockIdx.z * gps;
  const int g_count = min(n_groups, g_begin + gps) - g_begin;
  // The thread's 8 output columns: wn*32 + 8*ft + (0..7).
  const int c_local = wn * 32 + 8 * ft;

  float acc[MT][4][4];
  int4_mma::mainloop<MT, WM>(acc, smem, DenseRows{x, R, IN, m0}, DenseCols{n0}, packed, scales,
                             OUT, g_begin, g_count);

  const int col = n0 + c_local;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * MT * 16 + mt * 16 + fg + 8 * h;
      if (row >= R) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h];
        v[4 + j] = acc[mt][j][2 * h + 1];
      }
      if (gridDim.z == 1) {
        uint4 o;
        o.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
        o.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[3])) << 16);
        o.z = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[4])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[5])) << 16);
        o.w = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[6])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[7])) << 16);
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * OUT + col) = o;
      } else {
        float* dst = partial + (static_cast<size_t>(blockIdx.z) * R + row) * OUT + col;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
}

// y = bf16(sum over s of partial[s]), the splits added in order, four
// elements a thread (R * OUT is a multiple of 128).
__global__ void int4_splitk_reduce_kernel(const float* __restrict__ partial,
                                          __nv_bfloat16* __restrict__ y, int R, int OUT,
                                          int splits) {
  const size_t total = static_cast<size_t>(R) * OUT;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 v = *reinterpret_cast<const float4*>(partial + i);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(partial + static_cast<size_t>(s) * total + i);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  uint2 o;
  o.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
        ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16);
  o.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.z)) |
        ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.w)) << 16);
  *reinterpret_cast<uint2*>(y + i) = o;
}

// ---------------------------------------------------------------------------
// GEMM configuration: wgmma, weights as register operand A
// ---------------------------------------------------------------------------

namespace gemm {

constexpr int kRows = 128;                        // rows of x a tile: wgmma's N
constexpr int kCols = 128;                        // output columns a tile, 64 a warpgroup
constexpr int kStages = 5;                        // ring depth
constexpr int kBand = 16;                         // column tiles a band of the walk
constexpr int kXBoxBytes = kRows * 128;           // 64 K of the tile's rows: 16 KB
constexpr int kXBytes = 2 * kXBoxBytes;           // a group's x tile
constexpr int kWBytes = (kGroup / 2) * kCols;     // the packed tile: 8 KB
constexpr int kSBytes = 1024;                     // 512 B of scales; stages stay 1 KB aligned
constexpr int kStageBytes = kXBytes + kWBytes + kSBytes;
constexpr uint32_t kStageTx = kXBytes + kWBytes + kCols * 4;
constexpr int kThreads = 3 * 128;                 // two consumer warpgroups, the producer
// Stages, 1 KB of slack to align them to the swizzle's 1 KB, the barriers.
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

// d (64 x 128 f32, 64 registers a thread) = or += A (64 x 16 bf16,
// registers) x B (16 x 128 bf16, K-major in shared memory).  `accumulate` 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// Keeps the compiler from moving reads of wgmma's registers across a wait.
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Unit u of the walk: split z of tile (tm, tn).  Tiles go in bands of kBand
// column tiles, row tile outer and column tile inner within a band.
__device__ __forceinline__ void unit_of(int u, int splits, int tiles_m, int tiles_n, int& tm,
                                        int& tn, int& z) {
  z = u % splits;
  const int t = u / splits;
  const int band = t / (kBand * tiles_m);
  const int rem = t - band * kBand * tiles_m;
  const int width = min(kBand, tiles_n - band * kBand);
  tm = rem / width;
  tn = band * kBand + rem % width;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

}  // namespace gemm

// Grid: min(units, SMs) blocks of gemm::kThreads; units = tiles * splits,
// split z taking groups [z*gps, min(G, (z+1)*gps)).  With one split it writes
// y in bf16, else f32 partial sums to partial[z][R][OUT].
__global__ void __launch_bounds__(gemm::kThreads, 1) int4_mma_kernel_wg(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
    float* __restrict__ partial, int R, int IN, int OUT, int gps, int splits) {
  using namespace gemm;
  using namespace tma_ring;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* stages = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + kStages * kStageBytes;  // kStages full, then empty
  const uint32_t empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x;
  // The warp's index, broadcast from lane 0 so that the compiler knows the
  // role branches below are uniform across a warp.
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int n_groups = IN / kGroup;
  const int tiles_m = (R + kRows - 1) / kRows;
  const int tiles_n = OUT / kCols;
  const int units = tiles_m * tiles_n * splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_idx >= 8) {
    // Producer: one thread keeps the ring full, unit after unit.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int s = 0, phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int tm, tn, z;
        unit_of(u, splits, tiles_m, tiles_n, tm, tn, z);
        const int g_begin = z * gps;
        const int g_end = min(n_groups, g_begin + gps);
        for (int g = g_begin; g < g_end; ++g) {
          const uint32_t full = full0 + 8 * s;
          // The first pass finds every stage free.
          mbar_wait(empty0 + 8 * s, phase ^ 1);
          mbar_expect_tx(full, kStageTx);
          const uint32_t dst = base + s * kStageBytes;
          tma_load_2d(dst, &x_map, g * kGroup, tm * kRows, full);
          tma_load_2d(dst + kXBoxBytes, &x_map, g * kGroup + kGroup / 2, tm * kRows, full);
          tma_load_2d(dst + kXBytes, &w_map, tn * kCols, g * (kGroup / 2), full);
          bulk_load(dst + kXBytes + kWBytes, scales + static_cast<size_t>(g) * OUT + tn * kCols,
                    kCols * 4, full);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int lane = tid & 31;
  const int fg = lane >> 2;  // fragment row group
  const int ft = lane & 3;   // thread in the group
  // The warp's 16 output columns are 16-byte chunk `chunk` of a packed row;
  // packed row pr holds it at chunk ^ (pr & 7).  The thread's two columns,
  // c_local and c_local + 1, are A rows fg and fg + 8 of its warp; it reads
  // them from packed rows 8 kk + ft and 8 kk + ft + 4 of k-step kk.
  const int chunk = warp_idx;  // 4 x warpgroup + warp in it
  const int c_local = 16 * chunk + 2 * fg;
  const int w_lo = ft * kCols + ((chunk ^ ft) << 4) + 2 * fg;
  const int w_hi = (ft + 4) * kCols + ((chunk ^ (ft + 4)) << 4) + 2 * fg;

  // The A fragments of k-steps 4 half .. 4 half + 3 from stage s.
  auto unpack_half = [&](int s, int half, uint32_t (&a)[4][4]) {
    const uint8_t* wt = stages + s * kStageBytes + kXBytes;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rows = 8 * (4 * half + k) * kCols;
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(wt + rows + w_lo);
      const uint32_t hi = *reinterpret_cast<const uint16_t*>(wt + rows + w_hi);
      int4_mma::unpack_word(lo | (hi << 16), a[k]);
    }
  };
  // wgmma's B descriptor of k-step kk: 32 bytes along a 128-byte row, the
  // second 64 K in the second box.
  auto b_desc = [&](uint64_t desc, int kk) {
    return desc + static_cast<uint64_t>(((kk >> 2) * kXBoxBytes + (kk & 3) * 32) >> 4);
  };

  float acc[64], part[64];
  uint32_t a0[4][4], a1[4][4];
  int s = 0, phase = 0;
  if (static_cast<int>(blockIdx.x) < units) {
    mbar_wait(full0, 0);
    unpack_half(0, 0, a0);
  }
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int tm, tn, z;
    unit_of(u, splits, tiles_m, tiles_n, tm, tn, z);
    const int g_begin = z * gps;
    const int g_count = min(n_groups, g_begin + gps) - g_begin;
    const bool more_units = u + static_cast<int>(gridDim.x) < units;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int g = 0; g < g_count; ++g) {
      const uint64_t desc = kmajor_desc(base + s * kStageBytes);
      // First half: its fragments were unpacked before.
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_m64n128k16(part, a0[k], b_desc(desc, k), k > 0);
      wgmma_commit();
      // Second half: unpacked under the first.  The group's scales are read
      // before its last wgmma goes out, so that the stage is free once they
      // are done.
      unpack_half(s, 1, a1);
      const float2 sc = *reinterpret_cast<const float2*>(stages + s * kStageBytes + kXBytes +
                                                         kWBytes + c_local * 4);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_m64n128k16(part, a1[k], b_desc(desc, 4 + k), 1);
      wgmma_commit();
      // The next group's first half, under this group's second.
      wgmma_wait<1>();
      const int s_next = s + 1 == kStages ? 0 : s + 1;
      const int phase_next = s + 1 == kStages ? phase ^ 1 : phase;
      if (g + 1 < g_count || more_units) {
        mbar_wait(full0 + 8 * s_next, phase_next);
        unpack_half(s_next, 0, a0);
      }
      wgmma_wait<0>();
      fence_operand(part);
      if ((tid & 127) == 0) mbar_arrive(empty0 + 8 * s);
      // acc += part * s, per column, the multiply and the add rounded apart.
      // Register 4 j + 2 h + e: column c_local + h, row 8 j + 2 ft + e.
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], (i & 2) ? sc.y : sc.x));
      }
      s = s_next;
      phase = phase_next;
    }

    const int col = tn * kCols + c_local;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = tm * kRows + 8 * j + 2 * ft + e;
        if (row >= R) continue;
        if (splits == 1) {
          *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row) * OUT + col) =
              pack_bf16x2(acc[4 * j + e], acc[4 * j + 2 + e]);
        } else {
          *reinterpret_cast<float2*>(partial + (static_cast<size_t>(z) * R + row) * OUT + col) =
              make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

struct Plan {
  int splits;  // K splits (1: the kernel writes y itself)
  int gps;     // groups a split
};

int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

int stream_mt(int R) { return R <= 16 ? 1 : R <= 32 ? 2 : R <= 48 ? 3 : 4; }

Plan make_plan(int path, int R, int IN, int OUT) {
  const int n_groups = IN / kGroup;
  // Streaming is bound by bytes in flight: aim at two blocks an SM.  The GEMM
  // runs one block an SM (its registers): aim at one.
  const int bm = path == kStream ? 16 * stream_mt(R) : gemm::kRows;
  const int target = path == kStream ? 2 * sm_count() : sm_count();
  const int tiles = (OUT / kTileN) * ((R + bm - 1) / bm);
  int splits = (target + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > n_groups ? n_groups : splits);
  const int gps = (n_groups + splits - 1) / splits;
  return Plan{(n_groups + gps - 1) / gps, gps};
}

template <int MT, int WM>
int launch_mma(const __nv_bfloat16* x, const int8_t* packed, const float* scales,
               __nv_bfloat16* y, float* ws, int R, int IN, int OUT, const Plan& plan,
               cudaStream_t stream) {
  using C = Cfg<MT, WM>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_mma_kernel<MT, WM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(OUT / kTileN, (R + C::kBM - 1) / C::kBM, plan.splits);
  int4_mma_kernel<MT, WM><<<grid, C::kThreads, C::kSmemBytes, stream>>>(x, packed, scales, y, ws,
                                                                         R, IN, OUT, plan.gps);
  return 0;
}

int launch_gemm(const __nv_bfloat16* x, const int8_t* packed, const float* scales,
                __nv_bfloat16* y, float* ws, int R, int IN, int OUT, const Plan& plan,
                cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!tma_ring::swizzled_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, R, IN,
                              gemm::kRows) ||
      !tma_ring::swizzled_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, IN / 2, OUT,
                              kGroup / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_mma_kernel_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int units = (R + gemm::kRows - 1) / gemm::kRows * (OUT / gemm::kCols) * plan.splits;
  const int grid = units < sm_count() ? units : sm_count();
  int4_mma_kernel_wg<<<grid, gemm::kThreads, gemm::kSmemBytes, stream>>>(
      x_map, w_map, scales, y, ws, R, IN, OUT, plan.gps, plan.splits);
  return 0;
}

}  // namespace

// Bytes of f32 workspace the call needs (0 when the kernel writes y itself).
extern "C" long long chatts_int4_matmul_workspace_bytes(int R, int IN, int OUT, int path) {
  const Plan plan = make_plan(path, R, IN, OUT);
  if (plan.splits == 1) return 0;
  return static_cast<long long>(plan.splits) * R * OUT * 4;
}

// Requires IN % 128 == 0, OUT % 128 == 0, 16-byte aligned pointers and
// R >= 1.  Returns cudaGetLastError() after the launches (or the error of
// setting the kernel's shared-memory size, or cudaErrorInvalidValue when the
// GEMM's tensor maps cannot be made).
extern "C" int chatts_int4_matmul(const void* x, const void* packed, const void* scales, void* y,
                                  void* workspace, int R, int IN, int OUT, int path,
                                  void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pk = static_cast<const int8_t*>(packed);
  const auto* sc = static_cast<const float*>(scales);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* ws = static_cast<float*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
  if (path != kStream && path != kGemm) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(path, R, IN, OUT);
  int err = 0;
  if (path == kGemm) {
    err = launch_gemm(xb, pk, sc, yb, ws, R, IN, OUT, plan, st);
  } else {
    switch (stream_mt(R)) {
      case 1: err = launch_mma<1, 1>(xb, pk, sc, yb, ws, R, IN, OUT, plan, st); break;
      case 2: err = launch_mma<2, 1>(xb, pk, sc, yb, ws, R, IN, OUT, plan, st); break;
      case 3: err = launch_mma<3, 1>(xb, pk, sc, yb, ws, R, IN, OUT, plan, st); break;
      default: err = launch_mma<4, 1>(xb, pk, sc, yb, ws, R, IN, OUT, plan, st); break;
    }
  }
  if (err != 0) return err;
  if (plan.splits > 1) {
    const size_t total4 = static_cast<size_t>(R) * OUT / 4;
    const int threads = 256;
    const unsigned int blocks = static_cast<unsigned int>((total4 + threads - 1) / threads);
    int4_splitk_reduce_kernel<<<blocks, threads, 0, st>>>(ws, yb, R, OUT, plan.splits);
  }
  return static_cast<int>(cudaGetLastError());
}
