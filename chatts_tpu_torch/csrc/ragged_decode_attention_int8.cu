// Ragged decode attention over an int8 KV cache for Hopper (sm_90a): one
// query token per batch row against head-major int8 codes with one f32 scale
// per (row, kv head, position), reading only each row's valid prefix, with
// the KV axis split over blocks (flash-decoding).
//
// Replaces chatts_tpu/ops/ragged_decode_attention.py::ragged_decode_attention_int8
// (Pallas body `_kernel_int8`).
//
// What it computes, for a bf16 query and head_dim 128:
//   q (B, H, D) bf16, k/v codes (B, KVH, S, D) int8, k/v scales (B, KVH, S) f32,
//   lengths (B,) int32  ->  out (B, H, D) bf16
//   Row b attends cache positions [0, lengths[b]).  The query is scaled in f32,
//   each code becomes an f32 in registers, and the scales are factored out of
//   the D contraction as in the reference:
//     s   = ((q * scale) . k_code) * k_scale[pos]
//     acc += (p * v_scale[pos]) * v_code
//   with the softmax online in f32.  A row of length 0 gives 0.
//
// What bounds it on the H100: device-memory bandwidth.  A position costs
// 2 * D code bytes plus two 4-byte scales, half the bf16 cache's bytes, and
// each is used for G = H / KVH query heads: about 2 G multiply-adds a byte,
// far below what the CUDA cores do, so the products stay in f32 on the CUDA
// cores, the reference's arithmetic.
//
// What held the first version back: a grid of (KVH, B) blocks, 192 at the
// serving shape (24 slots, 8 kv heads), each walking its row's 128-key tiles
// one after another, so a call took as long as its longest row; 78 KB of
// shared memory a block (two a SM), a full wait for a tile before any
// compute, three block barriers and two block-wide reductions a tile, a PV
// loop of up to 128 dependent steps reading one byte of shared memory each,
// and every code converted by the int-to-float instruction, which runs at a
// quarter of the multiply-add rate.  On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2; B24 H40 KVH8 S1024, lengths 0 to 1024) it took
// 0.070 ms against a byte bound of 0.0070 ms.
//
// Design: the bf16 kernel's (csrc/ragged_decode_attention.cu), which shares
// its plan, its workspace and its merge (decode_split.cuh).
//   * Grid (splits, KVH, B): block z takes the keys [z * chunk, (z + 1) *
//     chunk) below the row's length, for all G heads of its kv head.  The
//     plan comes from the shapes alone; `lengths` is read only here, on the
//     device, so a call can be captured in a CUDA graph and replayed with
//     other lengths.  A block past the length returns at once.
//   * Inside a block each of the 4 warps walks its own 32-key tiles of the
//     chunk (tiles warp, warp + 4, ...) with its own running max, sum and
//     accumulator; the warps meet once, at the end of the chunk.
//   * No k or v passes through shared memory: a warp's tile sits in its
//     registers.  For the scores lane j owns key j of the tile and reads its
//     128-byte row with 8 loads of 16 bytes, against q in shared memory (f32,
//     scaled; broadcast reads), so a score needs no reduction across lanes;
//     the lane loads its key's two scales itself (one coalesced 4-byte load
//     each).  p * v_scale goes through 128 bytes a head of the warp's own
//     shared memory.  For the PV product lane j owns output columns 4j..4j+3
//     and reads 4 bytes of each value row (one 128-byte line a warp load).
//     All 42 loads of a tile are started before anything waits for one (up to
//     8 heads a kv head; above, the value rows come 8 at a time), the first
//     tile's before q is staged, the next tile's keys under this tile's PV
//     product.  The sum of p stays a per-lane partial until the end.
//   * A code becomes an f32 without the conversion instruction: the byte,
//     its sign bit flipped, is placed in the low mantissa of 2^23 by one
//     byte permute, and 2^23 + 128 is subtracted: exact for -128..127.
//   * The kernel is compiled for each G up to 8 (and for 16 slots, the heads
//     past G zero, for 9 to 16), so the loops over the heads have no branch.
//   * With more than one split a block writes its unnormalised accumulator,
//     max and sum to the workspace and decode_merge_kernel joins them in split
//     order (no atomics: two calls give the same bits); with one split the
//     block normalises and writes the output itself.
//
// On the same card and shape (4 splits of 256 keys, 768 blocks) a call with
// its merge takes 0.027 ms, 26% of the byte bound; with 16 of the 24 slots
// live at 540 to 585 keys 0.0225 ms against 0.035 ms, and at capacity 6,144
// (mean length 2,832) 0.117 ms against 0.367 ms (scripts/compare_port_kernels.py,
// CUDA-graph replay).  What is left is two launches and, at G = 5, about
// seven CUDA-core instructions a code byte in chains that few warps an SM
// hide badly: a block is faster with 159 registers than with 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

using decode_split::kD;
using decode_split::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;  // keys a warp tile
constexpr unsigned kFull = 0xffffffffu;

template <int MAXG>
struct Smem {
  float qs[MAXG][kD];               // q, scaled, f32
  float ps[kWarps][MAXG][kTK];      // a warp's p * v_scale of its current tile
  float acc[kWarps][MAXG][kD];      // the warps' parts, written once at the end
  float ml[kWarps][MAXG][2];
};

// The four codes of a 32-bit word as f32.  u = w ^ 0x80808080 holds code + 128
// in each byte; byte i under the exponent of 2^23 is the float 2^23 + code +
// 128, and the subtraction is exact.
__device__ __forceinline__ void codes4(unsigned int w, float (&f)[4]) {
  const unsigned int u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Two blocks an SM are asked for, no more: left to itself ptxas stops at 128
// registers for G = 4 and 5 (four blocks an SM) and spills, and a block then
// takes longer than the fourth block buys.
template <int MAXG>
__global__ void __launch_bounds__(kThreads, 2) ragged_decode_int8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int H, int KVH, int S, float scale,
    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MAXG>& sm = *reinterpret_cast<Smem<MAXG>*>(smem_raw);

  const int z = blockIdx.x;
  const int splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = min(max(lengths[b], 0), S);
  const int begin = z * chunk;
  const size_t out0 = (static_cast<size_t>(b) * H + kvh * G) * kD;
  if (begin >= length) {
    // Nothing to attend.  The merge skips this part; with one split the
    // row has length 0 and its output is 0.
    if (splits == 1) {
      for (int g = 0; g < G; ++g) out[out0 + g * kD + tid] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int end = min(begin + chunk, length);

  const size_t head = static_cast<size_t>(b) * KVH + kvh;
  const int8_t* kbase = k_cache + head * S * kD;
  const int8_t* vbase = v_cache + head * S * kD;
  const float* ksb = k_scale + head * S;
  const float* vsb = v_scale + head * S;

  // A warp's tile in flight, in registers: the lane's key row (8 x 16 bytes)
  // with its two scales, and the lane's 4 bytes of each of kVB value rows.
  // Every load of a tile is started before anything waits for one.  A dead
  // key's value row and scales are never read: the cache past the length may
  // hold anything, and 0 * NaN is NaN.
  constexpr int kVB = MAXG <= 8 ? kTK : 8;  // value rows loaded at once
  uint4 kreg[kD / 16];
  unsigned int vreg[kVB];
  float ksc = 0.f, vsc = 0.f;
  auto load_k = [&](int s0) {
    const bool in = s0 + lane < end;
    const int key = in ? s0 + lane : s0;
    const uint4* krow = reinterpret_cast<const uint4*>(kbase + static_cast<size_t>(key) * kD);
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) kreg[c] = __ldg(krow + c);
    ksc = in ? __ldg(ksb + key) : 0.f;
  };
  auto load_vs = [&](int s0) { vsc = s0 + lane < end ? __ldg(vsb + s0 + lane) : 0.f; };
  auto load_v = [&](int s0, int j0) {
    const unsigned int* vrow =
        reinterpret_cast<const unsigned int*>(vbase + static_cast<size_t>(s0) * kD) + lane;
#pragma unroll
    for (int j = 0; j < kVB; ++j) {
      vreg[j] = s0 + j0 + j < end ? __ldg(vrow + (j0 + j) * (kD / 4)) : 0u;
    }
  };
  const int first = begin + warp * kTK;
  if (first < end) {
    load_k(first);
    load_vs(first);
    if (kVB == kTK) load_v(first, 0);
  }

  // Query heads kvh*G .. kvh*G+G-1, scaled in f32.
  for (int i = tid; i < MAXG * kD; i += kThreads) {
    const int g = i / kD;
    const int d = i - g * kD;
    sm.qs[g][d] = (g < G) ? __bfloat162float(q[out0 + g * kD + d]) * scale : 0.f;
  }
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;  // this lane's share of the sum of p
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  for (int s0 = first; s0 < end; s0 += kWarps * kTK) {
    const int next = s0 + kWarps * kTK;
    // Scores: lane owns key s0 + lane.
    const bool live = s0 + lane < end;
    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) {
      const unsigned int w[4] = {kreg[c].x, kreg[c].y, kreg[c].z, kreg[c].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float kv[4];
        codes4(w[i], kv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const float4 q4 = *reinterpret_cast<const float4*>(&sm.qs[g][c * 16 + i * 4]);
          sc[g] += q4.x * kv[0] + q4.y * kv[1] + q4.z * kv[2] + q4.w * kv[3];
        }
      }
    }
    const float tile_ksc = ksc, tile_vsc = vsc;
    if (next < end) load_k(next);  // the next tile's keys, under this tile's PV
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float s = live ? sc[g] * tile_ksc : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      m[g] = m_new;
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
      sm.ps[warp][g][lane] = p * tile_vsc;
    }
    if (next < end) load_vs(next);
    __syncwarp();

    // PV: lane owns output columns 4*lane .. 4*lane+3.
    const int n_live = min(kTK, end - s0);
#pragma unroll
    for (int j0 = 0; j0 < kTK; j0 += kVB) {
      if (kVB < kTK) {
        if (j0 >= n_live) break;
        load_v(s0, j0);
      }
#pragma unroll
      for (int j = 0; j < kVB; j += 4) {
        if (j0 + j < n_live) {  // warp-uniform
          float vv[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) codes4(vreg[j + jj], vv[jj]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            const float4 p4 = *reinterpret_cast<const float4*>(&sm.ps[warp][g][j0 + j]);
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[g][e] += p[jj] * vv[jj][e];
          }
        }
      }
    }
    if (kVB == kTK && next < end) load_v(next, 0);
    __syncwarp();  // the warp is done with ps before the next tile rewrites it
  }

  // The warps meet: each leaves its part, then thread d joins column d in
  // warp order.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const float sum = warp_sum(l[g]);
    *reinterpret_cast<float4*>(&sm.acc[warp][g][4 * lane]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    if (lane == 0) {
      sm.ml[warp][g][0] = m[g];
      sm.ml[warp][g][1] = sum;
    }
  }
  __syncthreads();
  const size_t n_parts = static_cast<size_t>(gridDim.z) * KVH * splits;
  const size_t part = head * splits + z;
  for (int g = 0; g < G; ++g) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.ml[w][g][0]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm.ml[w][g][0] - mx);
      sum += sm.ml[w][g][1] * e;
      a += sm.acc[w][g][tid] * e;
    }
    if (splits == 1) {
      out[out0 + g * kD + tid] = __float2bfloat16_rn(a / (sum > 0.f ? sum : 1.f));
    } else {
      decode_split::part_acc(ws, part, G, g)[tid] = a;
      if (tid == 0) {
        float* ml = decode_split::part_ml(ws, n_parts, part, G, g);
        ml[0] = mx;
        ml[1] = sum;
      }
    }
  }
}

template <int MAXG>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* lengths, void* out, void* ws, int B, int H, int KVH, int S, float scale,
           int splits, int chunk, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<MAXG>));
  cudaError_t err = cudaFuncSetAttribute(ragged_decode_int8_kernel<MAXG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, KVH, B);
  ragged_decode_int8_kernel<MAXG><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), H, KVH, S, scale, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  decode_split::decode_merge_kernel<<<dim3(H, B), kD, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, KVH, S, splits, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,128) bf16, k/v codes (B,KVH,S,128) int8, k/v scales (B,KVH,S) f32, all
// contiguous, q and the codes 16-byte aligned; lengths (B,) int32 on the
// device.  `splits` blocks of `chunk` keys cover the capacity S (chunk a
// multiple of 128); workspace holds B * KVH * splits * (H / KVH) * 130 floats
// (decode_split.cuh has the layout) and may be null with one split.  Requires
// H % KVH == 0, H / KVH <= 16, B <= 65535.  Returns cudaGetLastError(); 1
// (cudaErrorInvalidValue) for a group too wide or a plan that does not cover S.
extern "C" int chatts_ragged_decode_attention_int8(const void* q, const void* k, const void* v,
                                                   const void* k_scale, const void* v_scale,
                                                   const void* lengths, void* out,
                                                   void* workspace, int B, int H, int KVH, int S,
                                                   float scale, int splits, int chunk,
                                                   void* stream) {
  const int G = H / KVH;
  auto st = static_cast<cudaStream_t>(stream);
  if (!decode_split::plan_ok(S, splits, chunk) || (splits > 1 && workspace == nullptr) ||
      B > 65535 || KVH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define CHATTS_DECODE_CASE(N)                                                                  \
  case N:                                                                                      \
    return launch<N>(q, k, v, k_scale, v_scale, lengths, out, workspace, B, H, KVH, S, scale, \
                     splits, chunk, st)
  switch (G <= 8 ? G : (G <= 16 ? 16 : 0)) {
    CHATTS_DECODE_CASE(1);
    CHATTS_DECODE_CASE(2);
    CHATTS_DECODE_CASE(3);
    CHATTS_DECODE_CASE(4);
    CHATTS_DECODE_CASE(5);
    CHATTS_DECODE_CASE(6);
    CHATTS_DECODE_CASE(7);
    CHATTS_DECODE_CASE(8);
    CHATTS_DECODE_CASE(16);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CHATTS_DECODE_CASE
}
