// Split-KV decode attention (flash-decoding): what the decode kernels share.
//
// A decode kernel launches a grid of (splits, KVH, B) blocks.  Block z of a
// (batch row, kv head) attends the keys [z * chunk, min((z + 1) * chunk,
// length)) and writes, for each of the G query heads of its kv head, an
// unnormalised accumulator (128 f32), the running max and the sum of p to a
// workspace the caller allocates.  `decode_merge_kernel` then joins the parts
// of every (batch row, kv head) by logsumexp, in split order, and writes the
// output in bf16.  No atomics: the same inputs give the same bits every run.
//
// The plan (how many splits, how long a chunk) is made by the caller from the
// shapes alone (ops/ragged_decode_attention.py::split_plan): never from
// `lengths`, which stay on the device.  A block whose chunk starts at or past
// its row's length returns at once and writes nothing; the merge reads only
// the splits below the length.
//
// Workspace layout, f32, for P = (b * KVH + kvh) * splits + z:
//   acc  [B * KVH * splits][G][128]   at  ws
//   m, l [B * KVH * splits][G][2]     at  ws + B * KVH * splits * G * 128
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_split {

constexpr int kD = 128;
constexpr int kKeyTile = 128;  // a chunk is a multiple of this many keys
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 min, as the reference

// True when `chunk` and `splits` cover a cache of capacity S.
inline bool plan_ok(int S, int splits, int chunk) {
  return splits >= 1 && chunk >= kKeyTile && chunk % kKeyTile == 0 &&
         static_cast<long long>(splits) * chunk >= S &&
         static_cast<long long>(splits - 1) * chunk < S;
}

__device__ __forceinline__ float* part_acc(float* ws, size_t part, int G, int g) {
  return ws + (part * G + g) * kD;
}

__device__ __forceinline__ float* part_ml(float* ws, size_t n_parts, size_t part, int G, int g) {
  return ws + n_parts * G * kD + (part * G + g) * 2;
}

// Grid (H, B), 128 threads: thread d owns output column d of one head.  The
// loads of a pass do not depend on one another, so they overlap.
__global__ void __launch_bounds__(kD) decode_merge_kernel(
    const float* __restrict__ ws, const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int H, int KVH, int S, int splits, int chunk) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int kvh = h / G;
  const int g = h - kvh * G;
  const int d = threadIdx.x;
  const int length = min(max(lengths[b], 0), S);
  const int used = min(splits, (length + chunk - 1) / chunk);
  const size_t n_parts = static_cast<size_t>(gridDim.y) * KVH * splits;
  const size_t part0 = (static_cast<size_t>(b) * KVH + kvh) * splits;
  float* base = const_cast<float*>(ws);
  float m = kNegInf;
#pragma unroll 8
  for (int z = 0; z < used; ++z) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml(base, n_parts, part0 + z, G, g));
    if (ml.y > 0.f) m = fmaxf(m, ml.x);
  }
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int z = 0; z < used; ++z) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml(base, n_parts, part0 + z, G, g));
    const float a = part_acc(base, part0 + z, G, g)[d];
    const float w = ml.y > 0.f ? expf(ml.x - m) : 0.f;  // a part with sum 0 is absent
    l += ml.y * w;
    acc += a * w;
  }
  out[(static_cast<size_t>(b) * H + h) * kD + d] = __float2bfloat16_rn(acc / (l > 0.f ? l : 1.f));
}

}  // namespace decode_split
