// Ragged decode attention over an int8 KV cache for Hopper (sm_90a): one
// query token per batch row against head-major int8 codes with one f32 scale
// per (row, kv head, position), reading only each row's valid prefix.
//
// Replaces chatts_tpu/ops/ragged_decode_attention.py::ragged_decode_attention_int8
// (Pallas body `_kernel_int8`).
//
// What it computes, for a bf16 query and head_dim 128:
//   q (B, H, D) bf16, k/v codes (B, KVH, S, D) int8, k/v scales (B, KVH, S) f32,
//   lengths (B,) int32  ->  out (B, H, D) bf16
//   Row b attends cache positions [0, lengths[b]).  The query is scaled in f32,
//   each code converts to f32 in registers, and the scales are factored out of
//   the D contraction as in the reference:
//     s   = ((q * scale) . k_code) * k_scale[pos]
//     acc += (p * v_scale[pos]) * v_code
//   with the softmax online in f32.  A row of length 0 gives 0.
//
// What bounds it on the H100: device-memory bandwidth.  A position costs
// 2 * D code bytes plus two 4-byte scales, half the bf16 cache's bytes, and
// each is used for G = H / KVH query heads.
//
// Design: the bf16 kernel's (csrc/ragged_decode_attention.cu).  One block of
// 128 threads per (batch row, kv head) serves all G query heads of that kv
// head.  128-key tiles of k and v codes stream into shared memory with
// cp.async, double-buffered; only ceil(length / 128) tiles are read, and keys
// at or past the length are zero-filled, not read.  In the score phase thread
// j owns key j of the tile: it loads that key's two scales itself (one
// coalesced 4-byte load each, issued before the tile wait), multiplies its G
// scores by the k scale, and multiplies its G probabilities by the v scale as
// it stores them for the PV phase, so the scales need no shared memory.  In
// the PV phase thread d owns output column d of all G heads.  Key rows are
// padded by 16 bytes, so the 16-byte reads of 8 threads on 8 rows fall on
// distinct banks.  As for the bf16 kernel, B * KVH blocks do not fill the
// 132 SMs at small batch; a KV split is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kTK = 128;      // keys per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKPad = 16;     // bytes of padding per key row
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 min, as the reference

template <int MAXG>
struct Smem {
  int8_t ks[2][kTK][kD + kKPad];
  int8_t vs[2][kTK][kD];
  float qs[MAXG][kD];
  float ps[MAXG][kTK];  // p * v_scale of each key
  float red_max[kWarps][MAXG];
  float red_sum[kWarps][MAXG];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Byte i (0 = lowest address) of a little-endian 32-bit word, as a signed code.
__device__ __forceinline__ float code(unsigned int w, int i) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * i))));
}

template <int MAXG>
__device__ __forceinline__ void load_tile(Smem<MAXG>& sm, int stage, const int8_t* kbase,
                                          const int8_t* vbase, int s0, int length) {
  // 128 keys x 8 chunks of 16 codes, for k and for v: 8 chunks a thread each.
#pragma unroll
  for (int i = 0; i < (kTK * kD / 16) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3;
    const int c = (idx & 7) * 16;
    const int s = s0 + r;
    const bool in = s < length;
    const size_t off = static_cast<size_t>(in ? s : 0) * kD + c;
    cp_async16(&sm.ks[stage][r][c], kbase + off, in);
    cp_async16(&sm.vs[stage][r][c], vbase + off, in);
  }
  cp_async_commit();
}

template <int MAXG>
__global__ void __launch_bounds__(kThreads) ragged_decode_int8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int H, int KVH, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MAXG>& sm = *reinterpret_cast<Smem<MAXG>*>(smem_raw);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = min(max(lengths[b], 0), S);
  const int n_tiles = (length + kTK - 1) / kTK;

  const size_t head = static_cast<size_t>(b) * KVH + kvh;
  const int8_t* kbase = k_cache + head * S * kD;
  const int8_t* vbase = v_cache + head * S * kD;
  const float* ksb = k_scale + head * S;
  const float* vsb = v_scale + head * S;
  if (n_tiles > 0) load_tile(sm, 0, kbase, vbase, 0, length);

  // Query heads kvh*G .. kvh*G+G-1, scaled in f32.
  for (int i = tid; i < MAXG * kD; i += kThreads) {
    const int g = i / kD;
    const int d = i - g * kD;
    sm.qs[g][d] = (g < G) ? __bfloat162float(q[(static_cast<size_t>(b) * H + kvh * G + g) * kD + d]) * scale
                          : 0.f;
  }

  float m[MAXG], l[MAXG], acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int s0 = t * kTK;
    const bool live = s0 + tid < length;
    const float ksc = live ? ksb[s0 + tid] : 0.f;
    const float vsc = live ? vsb[s0 + tid] : 0.f;
    cp_async_wait_all();
    __syncthreads();  // tile t is visible; tile t-1 is no longer read
    if (t + 1 < n_tiles) load_tile(sm, stage ^ 1, kbase, vbase, s0 + kTK, length);

    // Score phase: thread tid owns key s0 + tid.
    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kD; c += 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(&sm.ks[stage][tid][c]);
      const unsigned int w[4] = {u.x, u.y, u.z, u.w};
      float kv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) kv[j] = code(w[j >> 2], j & 3);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 16; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(&sm.qs[g][c + j]);
            part += qv.x * kv[j] + qv.y * kv[j + 1] + qv.z * kv[j + 2] + qv.w * kv[j + 3];
          }
          sc[g] += part;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float v = live ? sc[g] * ksc : kNegInf;
      sc[g] = v;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) sm.red_max[warp][g] = v;
    }
    __syncthreads();

    float alpha[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float tile_max = sm.red_max[0][g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tile_max = fmaxf(tile_max, sm.red_max[w][g]);
      const float m_new = fmaxf(m[g], tile_max);
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      float p = live ? expf(sc[g] - m_new) : 0.f;
      sm.ps[g][tid] = p * vsc;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) sm.red_sum[warp][g] = p;
    }
    __syncthreads();

    // PV phase: thread tid owns output column d = tid of every head.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float tile_sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tile_sum += sm.red_sum[w][g];
      l[g] = l[g] * alpha[g] + tile_sum;
      acc[g] *= alpha[g];
    }
    const int n_live = min(kTK, length - s0);
    for (int j = 0; j < n_live; ++j) {
      const float vj = static_cast<float>(sm.vs[stage][j][tid]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) acc[g] += sm.ps[g][j] * vj;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float denom = l[g] > 0.f ? l[g] : 1.f;
      out[(static_cast<size_t>(b) * H + kvh * G + g) * kD + tid] = __float2bfloat16_rn(acc[g] / denom);
    }
  }
}

template <int MAXG>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* lengths, void* out, int B, int H, int KVH, int S, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<MAXG>));
  cudaError_t err = cudaFuncSetAttribute(ragged_decode_int8_kernel<MAXG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KVH, B);
  ragged_decode_int8_kernel<MAXG><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, KVH, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,128) bf16, k/v codes (B,KVH,S,128) int8, k/v scales (B,KVH,S) f32, all
// contiguous, q and the codes 16-byte aligned; lengths (B,) int32 on the device.
// Requires H % KVH == 0 and H / KVH <= 16.  Returns cudaGetLastError(); 1
// (cudaErrorInvalidValue) for a group too wide.
extern "C" int chatts_ragged_decode_attention_int8(const void* q, const void* k, const void* v,
                                                   const void* k_scale, const void* v_scale,
                                                   const void* lengths, void* out, int B, int H,
                                                   int KVH, int S, float scale, void* stream) {
  const int G = H / KVH;
  auto st = static_cast<cudaStream_t>(stream);
  if (G <= 4) return launch<4>(q, k, v, k_scale, v_scale, lengths, out, B, H, KVH, S, scale, st);
  if (G <= 8) return launch<8>(q, k, v, k_scale, v_scale, lengths, out, B, H, KVH, S, scale, st);
  if (G <= 16) return launch<16>(q, k, v, k_scale, v_scale, lengths, out, B, H, KVH, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
