// Routed experts in int4 for Hopper (sm_90a): ops/moe_int4.py::moe_int4.
//
// What it computes: tokens x (T, H) bf16, each routed to K experts
// (idx (T, K) int32, global expert ids; w (T, K) f32).  The layer holds
// experts [first, first + E), each a SiLU MLP in B3's int4 layout
// (csrc/int4_matmul.cu: packed (IN/2, OUT) int8, two signed nibbles a byte,
// f32 scales a group of 128 input rows), stacked: gate_up (E, H/2, 2I), the
// gate's I columns first, and down (E, I/2, H).  out[t] = bf16(sum over k in
// order of w[t, k] * y[t, k]) in f32, where y = down(bf16(silu(g) * u)) and
// g, u = the gate/up product, each product rounded to bf16 once, as B3
// rounds it; a choice of an expert not held adds nothing.
//
// What bounds it on the H100: in decode (T in the hundreds, K = 6 of 64) an
// expert gets a dozen rows, so every weight byte of every expert is read for
// a few multiply-adds: the packed bytes and scales over 3.35 TB/s.  In
// prefill an expert's rows run to the hundreds and the tensor cores' 989
// TFLOP/s bound it.
//
// Four launches, no host sync (a CUDA graph holds them):
//   1. `moe_int4_route_kernel` (one block): counts each held expert's
//      pairs (token, choice), adds the counts to the layer's counter, lays
//      the pairs out sorted by expert (stable: in pair order within an
//      expert, by warp ballots) and writes the list of row tiles (expert,
//      first sorted row) the GEMMs take: ceil(count / BM) tiles an expert.
//   2. `moe_int4_gemm_kernel<MT, true>` (gate/up): grid (I / 64, tiles bound); a block takes
//      one tile's rows (gathered from x by token) and 64 gate columns with
//      the same 64 up columns, so that silu(g) * u is formed in its
//      epilogue (the gate warps hand their sums to the up warps through
//      shared memory) and written as a row of act (P, I) in sorted order.
//   3. `moe_int4_gemm_kernel<MT, false>` (down): grid (H / 128, tiles bound) over act's rows;
//      each row's result goes to y (P, H) at its pair's index.
//   4. `moe_int4_combine_kernel`: out[t] = the K rows of y, weighted, summed
//      in order.
// A block whose tile index is past the route's count returns at once.  The
// GEMMs run B3's main loop (csrc/int4_mma.cuh, shared with
// csrc/int4_matmul.cu) on gathered A rows and an expert's columns, under
// their own names so that a trace tells them apart: warps of 32 columns, a
// 4-stage cp.async ring of (A tile, packed tile, scales) a 128-row group,
// mma.sync m16n8k16 into f32 partials a group, times the group's scales
// added in group order; BM = 16, 32 or 64 rows a tile
// (ops/moe_int4.py::rows_per_tile, from the shapes).  A row's result does
// not depend on the rows beside it, so the sort's order does not change it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_mma.cuh"

namespace {

using int4_mma::kGroup;
using int4_mma::kTileN;
constexpr int kThreads = int4_mma::kWarpsN * 32;
constexpr int kMaxExperts = 256;
constexpr int kRouteThreads = 1024;
constexpr int kRouteSmemPairs = 11264;  // 44 KB of staged ids, under 48 KB with the rest

template <int MT>
using MmaCfg = int4_mma::Cfg<MT, 1>;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// ---------------------------------------------------------------------------
// Routing
// ---------------------------------------------------------------------------

// The pairs' local expert ids are read from shared memory where they fit
// (kRouteSmemPairs; decode and the mixed step), else from global memory.
__global__ void __launch_bounds__(kRouteThreads) moe_int4_route_kernel(
    const int* __restrict__ idx, int P, int E, int first, int bm, int max_tiles,
    int* __restrict__ offsets, int* __restrict__ sorted, int* __restrict__ tile_expert,
    int* __restrict__ tile_row0, int* __restrict__ n_tiles, int* __restrict__ counts) {
  __shared__ int cnt[kMaxExperts];
  __shared__ int off[kMaxExperts + 1];
  extern __shared__ int s_idx[];
  const bool staged = P <= kRouteSmemPairs;
  if (staged) {
    for (int p = threadIdx.x; p < P; p += blockDim.x) s_idx[p] = idx[p] - first;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int e = warp; e < E; e += warps) {
    int n = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      const int v = p < P ? (staged ? s_idx[p] : idx[p] - first) : -1;
      n += __popc(__ballot_sync(0xffffffffu, v == e));
    }
    if (lane == 0) cnt[e] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0, t = 0;
    for (int e = 0; e < E; ++e) {
      off[e] = acc;
      offsets[e] = acc;
      for (int r0 = 0; r0 < cnt[e] && t < max_tiles; r0 += bm, ++t) {
        tile_expert[t] = e;
        tile_row0[t] = acc + r0;
      }
      acc += cnt[e];
      if (counts != nullptr) counts[e] += cnt[e];
    }
    off[E] = acc;
    offsets[E] = acc;
    *n_tiles = t;
  }
  __syncthreads();
  for (int e = warp; e < E; e += warps) {
    int pos = off[e];
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      const int v = p < P ? (staged ? s_idx[p] : idx[p] - first) : -1;
      const unsigned hit = __ballot_sync(0xffffffffu, v == e);
      if (v == e) sorted[pos + __popc(hit & ((1u << lane) - 1u))] = p;
      pos += __popc(hit);
    }
  }
}

// ---------------------------------------------------------------------------
// The grouped GEMMs
// ---------------------------------------------------------------------------

// A tile's rows: A's row of each tile row, -1 past the expert's rows.
struct GatheredRows {
  const __nv_bfloat16* __restrict__ a;
  const int* rows;  // shared memory
  int IN;
  __device__ __forceinline__ bool src(int row, const __nv_bfloat16*& p) const {
    const int r = rows[row];
    p = a + static_cast<size_t>(r < 0 ? 0 : r) * IN;
    return r >= 0;
  }
};

// GATE_UP: the tile's 128 columns are gate columns [n0, n0 + 64) and up
// columns [I + n0, I + n0 + 64), n0 = blockIdx.x * 64; else [n0, n0 + 128),
// n0 = blockIdx.x * 128.
template <bool GATE_UP>
struct ExpertCols {
  int n0, I;
  __device__ __forceinline__ int operator()(int tc) const {
    if (GATE_UP) return tc < 64 ? n0 + tc : I + n0 + tc - 64;
    return n0 + tc;
  }
};

// One (column tile, row tile) of either GEMM.  GATE_UP: A rows are x's
// tokens (sorted pair / K), the result silu(g) * u into act[sorted row];
// else A rows are act's sorted rows and the result goes to y[pair].
template <int MT, bool GATE_UP>
__global__ void __launch_bounds__(kThreads) moe_int4_gemm_kernel(
    const __nv_bfloat16* __restrict__ a, const int8_t* __restrict__ packed_all,
    const float* __restrict__ scales_all, __nv_bfloat16* __restrict__ dst,
    const int* __restrict__ offsets, const int* __restrict__ sorted,
    const int* __restrict__ tile_expert, const int* __restrict__ tile_row0,
    const int* __restrict__ n_tiles, int K, int IN, int OUT, int I) {
  using C = MmaCfg<MT>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_rows[C::kBM];  // A's row of each tile row, -1 past the expert's rows
  __shared__ int s_dst[C::kBM];   // the destination row of each tile row

  const int tile = blockIdx.y;
  if (tile >= *n_tiles) return;
  const int e = tile_expert[tile];
  const int row0 = tile_row0[tile];
  const int row_end = offsets[e + 1];
  if (threadIdx.x < C::kBM) {
    const int sr = row0 + threadIdx.x;
    const bool in = sr < row_end;
    const int pair = in ? sorted[sr] : -1;
    s_rows[threadIdx.x] = in ? (GATE_UP ? pair / K : sr) : -1;
    s_dst[threadIdx.x] = in ? (GATE_UP ? sr : pair) : -1;
  }
  __syncthreads();

  const int8_t* packed = packed_all + static_cast<size_t>(e) * (IN / 2) * OUT;
  const float* scales = scales_all + static_cast<size_t>(e) * (IN / kGroup) * OUT;
  const int n0 = blockIdx.x * (GATE_UP ? 64 : kTileN);

  const int lane = threadIdx.x & 31;
  const int wn = threadIdx.x >> 5;
  const int fg = lane >> 2;
  const int ft = lane & 3;
  const int c_local = wn * 32 + 8 * ft;

  float acc[MT][4][4];
  int4_mma::mainloop<MT, 1>(acc, smem, GatheredRows{a, s_rows, IN}, ExpertCols<GATE_UP>{n0, I},
                            packed, scales, OUT, 0, IN / kGroup);

  if (GATE_UP) {
    // The gate warps (0, 1) hand their sums, rounded to bf16, to the up
    // warps (2, 3) of the same columns.
    __syncthreads();
    float* hand = reinterpret_cast<float*>(smem);  // [2 warps][32 lanes][MT * 16]
    if (wn < 2) {
      float* mine = hand + (wn * 32 + lane) * MT * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) mine[(mt * 4 + j) * 4 + q] = bf16r(acc[mt][j][q]);
    }
    __syncthreads();
    if (wn < 2) return;
    const float* gate = hand + ((wn - 2) * 32 + lane) * MT * 16;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = gate[(mt * 4 + j) * 4 + q];
          const float u = bf16r(acc[mt][j][q]);
          acc[mt][j][q] = g / (1.f + expf(-g)) * u;
        }
  }

  // The thread's 8 columns: c_local .. c_local + 7 of the tile (for gate/up,
  // of the up half: act columns n0 + c_local - 64 ..).
  const int col = GATE_UP ? n0 + c_local - 64 : n0 + c_local;
  const int ld = GATE_UP ? I : OUT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = mt * 16 + fg + 8 * h;
      const int drow = s_dst[lr];
      if (drow < 0) continue;
      uint4 o;
      o.x = pack_bf16x2(acc[mt][0][2 * h], acc[mt][1][2 * h]);
      o.y = pack_bf16x2(acc[mt][2][2 * h], acc[mt][3][2 * h]);
      o.z = pack_bf16x2(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1]);
      o.w = pack_bf16x2(acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(drow) * ld + col) = o;
    }
}

// out[t] = bf16(sum over k < K in order of w[t, k] * y[t * K + k]) over the
// held choices; 8 columns a thread.
__global__ void moe_int4_combine_kernel(const __nv_bfloat16* __restrict__ y,
                                        const int* __restrict__ idx, const float* __restrict__ w,
                                        __nv_bfloat16* __restrict__ out, int K, int E, int first,
                                        int H) {
  const int t = blockIdx.x;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * 8;
  if (c >= H) return;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const int e = idx[t * K + k] - first;
    if (e < 0 || e >= E) continue;
    const float wk = w[t * K + k];
    const uint4 v = *reinterpret_cast<const uint4*>(y + (static_cast<size_t>(t) * K + k) * H + c);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, __bfloat162float(b[i])));
  }
  uint4 o;
  o.x = pack_bf16x2(acc[0], acc[1]);
  o.y = pack_bf16x2(acc[2], acc[3]);
  o.z = pack_bf16x2(acc[4], acc[5]);
  o.w = pack_bf16x2(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(t) * H + c) = o;
}

// The workspace: ints (offsets E + 1, sorted P, tile lists 2 x max_tiles,
// the tile count), then act (P, I) and y (P, H) bf16, each 256-byte aligned.
struct Layout {
  size_t offsets, sorted, tile_expert, tile_row0, n_tiles, act, y, total;
  int max_tiles;
};

size_t up256(size_t x) { return (x + 255) / 256 * 256; }

Layout layout(int T, int K, int E, int I, int H) {
  Layout L;
  const size_t P = static_cast<size_t>(T) * K;
  L.max_tiles = static_cast<int>((P + 15) / 16) + E;
  L.offsets = 0;
  L.sorted = up256(L.offsets + 4 * (E + 1));
  L.tile_expert = up256(L.sorted + 4 * P);
  L.tile_row0 = up256(L.tile_expert + 4 * static_cast<size_t>(L.max_tiles));
  L.n_tiles = up256(L.tile_row0 + 4 * static_cast<size_t>(L.max_tiles));
  L.act = up256(L.n_tiles + 4);
  L.y = up256(L.act + 2 * P * I);
  L.total = up256(L.y + 2 * P * H);
  return L;
}

template <int MT, bool GATE_UP>
int launch_gemm(dim3 grid, cudaStream_t st, const __nv_bfloat16* a, const int8_t* packed,
                const float* scales, __nv_bfloat16* dst, const int* offsets, const int* sorted,
                const int* tile_expert, const int* tile_row0, const int* n_tiles, int K, int IN,
                int OUT, int I) {
  using C = MmaCfg<MT>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(moe_int4_gemm_kernel<MT, GATE_UP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  moe_int4_gemm_kernel<MT, GATE_UP><<<grid, kThreads, C::kSmemBytes, st>>>(
      a, packed, scales, dst, offsets, sorted, tile_expert, tile_row0, n_tiles, K, IN, OUT, I);
  return 0;
}

template <int MT>
int launch_both(cudaStream_t st, const Layout& L, uint8_t* ws, const __nv_bfloat16* x,
                const int8_t* gu_q, const float* gu_s, const int8_t* d_q, const float* d_s, int T,
                int K, int I, int H) {
  const int* offsets = reinterpret_cast<const int*>(ws + L.offsets);
  const int* sorted = reinterpret_cast<const int*>(ws + L.sorted);
  const int* te = reinterpret_cast<const int*>(ws + L.tile_expert);
  const int* tr = reinterpret_cast<const int*>(ws + L.tile_row0);
  const int* nt = reinterpret_cast<const int*>(ws + L.n_tiles);
  auto* act = reinterpret_cast<__nv_bfloat16*>(ws + L.act);
  auto* y = reinterpret_cast<__nv_bfloat16*>(ws + L.y);
  const int P = T * K;
  const int tiles = (P + MmaCfg<MT>::kBM - 1) / MmaCfg<MT>::kBM + (L.max_tiles - (P + 15) / 16);
  int err = launch_gemm<MT, true>(dim3(I / 64, tiles), st, x, gu_q, gu_s, act, offsets, sorted, te,
                                  tr, nt, K, H, 2 * I, I);
  if (err != 0) return err;
  return launch_gemm<MT, false>(dim3(H / kTileN, tiles), st, act, d_q, d_s, y, offsets, sorted,
                                te, tr, nt, K, I, H, I);
}

}  // namespace

extern "C" long long chatts_moe_int4_workspace_bytes(int T, int K, int E, int I, int H) {
  return static_cast<long long>(layout(T, K, E, I, H).total);
}

// x (T, H) bf16, idx (T, K) int32, w (T, K) f32; gate_up (E, H/2, 2I) int8
// with scales (E, H/128, 2I) f32; down (E, I/2, H) int8 with scales (E,
// I/128, H) f32; counts (E,) int32 or null; ws of
// chatts_moe_int4_workspace_bytes; out (T, H) bf16.  Requires H % 128 == 0,
// I % 128 == 0, E <= 256, bm 16, 32 or 64.  Returns cudaGetLastError().
extern "C" int chatts_moe_int4(const void* x, const void* idx, const void* w, const void* gu_q,
                               const void* gu_s, const void* d_q, const void* d_s, void* counts,
                               void* ws, void* out, int T, int K, int E, int I, int H, int first,
                               int bm, void* stream) {
  if (T < 1 || H % kTileN || I % kGroup || E < 1 || E > kMaxExperts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const Layout L = layout(T, K, E, I, H);
  auto* base = static_cast<uint8_t*>(ws);
  const int staged_bytes = T * K <= kRouteSmemPairs ? T * K * 4 : 0;
  moe_int4_route_kernel<<<1, kRouteThreads, staged_bytes, st>>>(
      static_cast<const int*>(idx), T * K, E, first, bm, L.max_tiles,
      reinterpret_cast<int*>(base + L.offsets), reinterpret_cast<int*>(base + L.sorted),
      reinterpret_cast<int*>(base + L.tile_expert), reinterpret_cast<int*>(base + L.tile_row0),
      reinterpret_cast<int*>(base + L.n_tiles), static_cast<int*>(counts));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gq = static_cast<const int8_t*>(gu_q);
  const auto* gs = static_cast<const float*>(gu_s);
  const auto* dq = static_cast<const int8_t*>(d_q);
  const auto* ds = static_cast<const float*>(d_s);
  int err;
  switch (bm) {
    case 16: err = launch_both<1>(st, L, base, xb, gq, gs, dq, ds, T, K, I, H); break;
    case 32: err = launch_both<2>(st, L, base, xb, gq, gs, dq, ds, T, K, I, H); break;
    case 64: err = launch_both<4>(st, L, base, xb, gq, gs, dq, ds, T, K, I, H); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  moe_int4_combine_kernel<<<dim3(T, (H / 8 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(base + L.y), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out), K, E, first, H);
  return static_cast<int>(cudaGetLastError());
}
