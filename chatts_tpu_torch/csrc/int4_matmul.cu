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
//   * The main loop is csrc/int4_mma.cuh's (shared with csrc/moe_int4.cu):
//     a K step is one 128-row group through a 4-stage cp.async ring of (x
//     tile, packed tile, scales), swizzled for ldmatrix; B fragments taken
//     from the packed bytes without a shuffle and unpacked exactly; bf16
//     mma.sync.m16n8k16 into f32 partials a group, times the group's scales
//     added to the f32 accumulators.  Two sets of 4*MT*4 f32 registers a
//     thread; dynamic shared memory 51 KB (MT = 1) to 166 KB (GEMM).
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

#include "int4_mma.cuh"

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
