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
// What bounds it on the H100: with few rows (decode, serving's 24 slots,
// short admissions) every weight byte is used for R multiply-adds, so the
// bytes (IN*OUT/2 packed + IN/128*OUT*4 scales) over 3.35 TB/s bound it.  With
// R in the hundreds and more it is the 2*R*IN*OUT bf16 tensor-core operations
// at 989 TFLOP/s.
//
// Design: one tensor-core kernel (`int4_mma_kernel`), two configurations.
//   * A block has WM x 4 warps.  A warp owns MT m16 row tiles and 32 output
//     columns (four n8 tiles), so a block computes a (WM*MT*16) x 128 tile.
//     - Streaming (kStream): WM = 1 and MT = min(4, ceil(R/16)).  Up to 64
//       rows live in one block row (rows past R are zero-filled), so each
//       weight byte is read from device memory once; more rows take 64-row
//       tiles, and later row tiles find the weights in L2.  Where the tiles
//       cannot fill two blocks an SM, K is split into runs of whole groups.
//     - GEMM (kGemm): WM = 2, MT = 4: 128 x 128 output tiles, K split only
//       when the tiles cannot fill the SMs once.
//   * A K step is one 128-row group.  A 4-stage cp.async ring holds, per
//     stage, the x tile (BM x 128 bf16, its 16-byte chunks XOR-swizzled by
//     row so that ldmatrix reads are free of bank conflicts), the packed
//     weight tile (64 x 128 bytes, chunks swizzled by row) and the group's
//     128 scales.  Dynamic shared memory: 51 KB (MT = 1) to 166 KB (GEMM).
//   * B fragments need no shuffle: a packed byte is the (k, k+1) pair of one
//     column, which is one bf16x2 register of the m16n8k16 B fragment.  A
//     warp's n8 tile j takes the columns 4c + j (c = the fragment's column),
//     so the thread of fragment column c finds the registers of all four
//     tiles in the four bytes of one 32-bit shared-memory word.  The
//     accumulators then hold 8 consecutive columns a thread: 16-byte stores.
//   * Unpacking is exact: the byte is placed as (low nibble, high nibble) in
//     the low mantissa bits of two bf16 128.0 (0x4300) with the sign bit
//     flipped (XOR 8), and 136 is subtracted by one bf16x2 fma: q in -8..7,
//     two a register, -8 included.
//   * Per group, bf16 mma.sync.m16n8k16 sums into f32 partials that start at
//     0; at the group's end the partials, times the group's scales, are added
//     to the f32 accumulators.  Two sets of 4*MT*4 f32 registers a thread.
//   * A split writes f32 partial sums to a workspace the caller allocates; a
//     second launch adds the splits in split order and rounds to bf16
//     (deterministic; no atomics).
//   mma.sync, not wgmma: its fragments sit in registers, where the unpacked
//   weights are made, and it takes any tile shape; wgmma would need the
//   unpacked bf16 weights written back to shared memory first.
//
// ops/int4_matmul.py picks the configuration for R (the band, with the
// measurement behind it, is there).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;

// Paths; ops/int4_matmul.py passes one.
constexpr int kStream = 1;
constexpr int kGemm = 2;

// ---------------------------------------------------------------------------
// Tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTileN = 128;                            // output columns a block
constexpr int kWarpsN = kTileN / 32;                   // warps along OUT
constexpr int kStages = 4;                             // cp.async ring depth
constexpr int kWTileBytes = (kGroup / 2) * kTileN;     // packed rows x columns
constexpr int kSTileBytes = kTileN * 4;                // one group's scales
constexpr int kXRowBytes = kGroup * 2;                 // one row of the x tile

template <int MT, int WM>
struct MmaCfg {
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
template <int MT, int WM>
__device__ __forceinline__ void load_stage(uint8_t* stage, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ packed,
                                           const float* __restrict__ scales, int R, int IN,
                                           int OUT, int m0, int n0, int g) {
  using C = MmaCfg<MT, WM>;
  const int tid = threadIdx.x;
  const uint32_t xs = smem_u32(stage);
  // x: BM rows x 16 chunks of 8 bf16; chunk c of row r at c ^ (r & 7).
  for (int i = tid; i < C::kBM * 16; i += C::kThreads) {
    const int row = i >> 4;
    const int c = i & 15;
    const int gr = m0 + row;
    const __nv_bfloat16* src =
        x + static_cast<size_t>(gr < R ? gr : 0) * IN + g * kGroup + c * 8;
    cp_async16(xs + row * kXRowBytes + ((c ^ (row & 7)) << 4), src, gr < R ? 16 : 0);
  }
  // Weights: 64 packed rows x 8 chunks of 16 columns; chunk c of row r at
  // c ^ ((r & 3) << 1).
  const uint32_t ws = xs + C::kXTileBytes;
  for (int i = tid; i < (kGroup / 2) * 8; i += C::kThreads) {
    const int row = i >> 3;
    const int c = i & 7;
    const int8_t* src = packed + static_cast<size_t>(g * (kGroup / 2) + row) * OUT + n0 + c * 16;
    cp_async16(ws + row * kTileN + ((c ^ ((row & 3) << 1)) << 4), src, 16);
  }
  // The group's 128 scales.
  const uint32_t ss = ws + kWTileBytes;
  for (int i = tid; i < kTileN / 4; i += C::kThreads) {
    cp_async16(ss + i * 16, scales + static_cast<size_t>(g) * OUT + n0 + i * 4, 16);
  }
}

// Grid: (OUT/128, ceil(R/BM), splits); split z takes groups
// [z*gps, min(G, (z+1)*gps)).  With one split it writes y in bf16, else f32
// partial sums to partial[z][R][OUT].
template <int MT, int WM>
__global__ void __launch_bounds__(MmaCfg<MT, WM>::kThreads) int4_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
    float* __restrict__ partial, int R, int IN, int OUT, int gps) {
  using C = MmaCfg<MT, WM>;
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

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < g_count) {
      load_stage<MT, WM>(smem + s * C::kStageBytes, x, packed, scales, R, IN, OUT, m0, n0,
                         g_begin + s);
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
        load_stage<MT, WM>(smem + (nxt % kStages) * C::kStageBytes, x, packed, scales, R, IN,
                           OUT, m0, n0, g_begin + nxt);
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
  const int bm = path == kStream ? 16 * stream_mt(R) : 128;
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
  using C = MmaCfg<MT, WM>;
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

}  // namespace

// Bytes of f32 workspace the call needs (0 when the kernel writes y itself).
extern "C" long long chatts_int4_matmul_workspace_bytes(int R, int IN, int OUT, int path) {
  const Plan plan = make_plan(path, R, IN, OUT);
  if (plan.splits == 1) return 0;
  return static_cast<long long>(plan.splits) * R * OUT * 4;
}

// Requires IN % 128 == 0, OUT % 128 == 0, 16-byte aligned pointers and
// R >= 1.  Returns cudaGetLastError() after the launches (or the error of
// setting the kernel's shared-memory size).
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
    err = launch_mma<4, 2>(xb, pk, sc, yb, ws, R, IN, OUT, plan, st);
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
