// The decoder layer's elementwise glue, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the decoder's elementwise
// ops (chatts_tpu/models/qwen.py: rms_norm, apply_rope, _quantize_kv, the
// bias add, silu, the residual adds) into their neighbours.  PyTorch runs them
// op by op, about 76 launches a layer in a ChatTS-14B decode step, each a few
// microseconds of launch for a few kilobytes of work.  These kernels take
// their place on CUDA tensors (models/qwen.py decides where):
//
//   chatts_add_rms_norm  the residual add and the RMSNorm after it
//   chatts_silu_mul      SiLU(gate) * up
//   chatts_qkv_decode    a decode step's qkv epilogue: the bias, the Qwen3
//                        q/k norms, RoPE, q for the decode attention, and the
//                        new K/V written into the cache (int8 codes and
//                        scales, or bf16 values) at each row's position
//
// Arithmetic: each keeps every rounding of the eager composition in
// models/qwen.py, so that a kernel's output equals the eager one's bits but
// where a reduction is summed in another order (the norms' sums of squares):
//   * a bf16 + bf16 add (the residual, Dense's f32 bias add) is the f32 sum
//     rounded once to bf16, as PyTorch's opmath adds;
//   * rms_norm: f32 x, x * rsqrtf(sum(x*x) * (1/H) + eps) (PyTorch's mean
//     multiplies the sum by 1/H), times weight, one rounding to bf16;
//   * apply_rope: x * cos and rotate_half(x) * sin each rounded to f32, then
//     their sum rounded to f32, then to bf16.  __fmul_rn / __fadd_rn keep
//     the three roundings: nvcc would contract them to an FMA;
//   * silu: x / (1 + expf(-x)) in f32 (PyTorch's kernel), rounded to bf16,
//     then times up rounded to bf16;
//   * quantize_kv: scale = max(amax / 127, 1e-8) and codes rint(x / scale)
//     clamped to [-127, 127], IEEE division and round half to even.
//
// What bounds them: bytes, each input read once and each output written
// once; at a decode step's 32 rows the launch itself (a few microseconds)
// is far above that bound, which is why one kernel takes the place of many.
//
// Design:
//   * add_rms_norm: one block a row; a thread holds up to 4 vectors of 8
//     bf16 in registers (16-byte loads), so H <= 32,768 at 1,024 threads.
//     The sum of squares is reduced by warp shuffles, then across warps.
//   * silu_mul: one thread per 8 outputs, 16-byte loads of gate and up,
//     each with its own row stride (the two halves of gate_up, or two
//     tensors).
//   * qkv_decode: one warp a (row, head) of q, k or v; a lane holds the head's
//     elements lane, lane + 32, ...  For D a multiple of 64 the RoPE partner
//     of element d (d +- D/2) lies in the same lane, and the norm's sum and
//     the int8 scale's amax are warp reductions.  8 warps a block, the grid
//     (B, heads / 8).  Inactive rows write too, at their stale position, as
//     the eager step writes every row.
//
// Every launcher runs on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;         // bf16 a 16-byte vector
constexpr int kMaxVecs = 4;     // vectors a thread of add_rms_norm holds
constexpr int kMaxThreads = 1024;
constexpr int kQkvWarps = 8;    // heads a block of qkv_decode

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's sum of v, returned to every thread.
__device__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int warps = (blockDim.x + 31) / 32;
  float s = lane < warps ? part[lane] : 0.0f;
  s = warp_sum(s);
  return s;
}

// ---------------------------------------------------------------------------
// Residual add + RMSNorm
// ---------------------------------------------------------------------------

template <bool kAdd>
__global__ void add_rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ branch,
                                    const bf16* __restrict__ weight, bf16* __restrict__ resid,
                                    bf16* __restrict__ normed, int H, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const int nvec = H / kVec;
  float v[kMaxVecs][kVec];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nvec) {
      const uint4 xa = *reinterpret_cast<const uint4*>(x + base + j * kVec);
      const bf16* xe = reinterpret_cast<const bf16*>(&xa);
      if (kAdd) {
        const uint4 ba = *reinterpret_cast<const uint4*>(branch + base + j * kVec);
        const bf16* be = reinterpret_cast<const bf16*>(&ba);
        uint4 ra;
        bf16* re = reinterpret_cast<bf16*>(&ra);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          re[e] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(xe[e]), __bfloat162float(be[e])));
          v[i][e] = __bfloat162float(re[e]);
        }
        *reinterpret_cast<uint4*>(resid + base + j * kVec) = ra;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[i][e] = __bfloat162float(xe[e]);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss = __fadd_rn(ss, __fmul_rn(v[i][e], v[i][e]));
    }
  }
  ss = block_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, __fdiv_rn(1.0f, static_cast<float>(H))), eps));
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nvec) {
      const uint4 wa = *reinterpret_cast<const uint4*>(weight + j * kVec);
      const bf16* we = reinterpret_cast<const bf16*>(&wa);
      uint4 oa;
      bf16* oe = reinterpret_cast<bf16*>(&oa);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        oe[e] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(v[i][e], r), __bfloat162float(we[e])));
      *reinterpret_cast<uint4*>(normed + base + j * kVec) = oa;
    }
  }
}

// ---------------------------------------------------------------------------
// SiLU(gate) * up
// ---------------------------------------------------------------------------

__global__ void silu_mul_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                                bf16* __restrict__ out, long long total_vecs, int I,
                                long long gate_stride, long long up_stride) {
  const int row_vecs = I / kVec;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < total_vecs; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = t / row_vecs;
    const int col = static_cast<int>(t - row * row_vecs) * kVec;
    const uint4 ga = *reinterpret_cast<const uint4*>(gate + row * gate_stride + col);
    const uint4 ua = *reinterpret_cast<const uint4*>(up + row * up_stride + col);
    const bf16* ge = reinterpret_cast<const bf16*>(&ga);
    const bf16* ue = reinterpret_cast<const bf16*>(&ua);
    uint4 oa;
    bf16* oe = reinterpret_cast<bf16*>(&oa);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float g = __bfloat162float(ge[e]);
      const float s = round_bf16(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
      oe[e] = __float2bfloat16_rn(__fmul_rn(s, __bfloat162float(ue[e])));
    }
    *reinterpret_cast<uint4*>(out + row * I + col) = oa;
  }
}

// ---------------------------------------------------------------------------
// The decode step's qkv epilogue
// ---------------------------------------------------------------------------

struct QkvArgs {
  const bf16* src[3];       // q, k, v rows of the projection's output
  long long src_stride[3];  // their row strides, in elements
  const bf16* bias[3];      // (heads * D) each, or null
  const bf16* q_norm;       // (D,) or null
  const bf16* k_norm;       // (D,) or null
  float eps;
  const float* cos;         // (B, D)
  const float* sin;         // (B, D)
  const int* write_pos;     // (B,)
  bf16* q_out;              // (B, H, D)
  void* k_cache;            // (Bc, KVH, S, D) int8 or bf16
  void* v_cache;
  float* k_scale;           // (Bc, KVH, S), null for a bf16 cache
  float* v_scale;
  int H, KVH, D, S;
};

template <int E>
__global__ void qkv_decode_kernel(QkvArgs a) {
  const int b = blockIdx.x;
  const int head = blockIdx.y * kQkvWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (head >= a.H + 2 * a.KVH) return;
  const int kind = head < a.H ? 0 : (head < a.H + a.KVH ? 1 : 2);
  const int hh = kind == 0 ? head : (kind == 1 ? head - a.H : head - a.H - a.KVH);
  const int D = a.D;
  const bf16* src = a.src[kind] + b * a.src_stride[kind] + hh * D;
  const bf16* bias = a.bias[kind] == nullptr ? nullptr : a.bias[kind] + hh * D;
  float v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int d = i * 32 + lane;
    float y = __bfloat162float(src[d]);
    if (bias != nullptr) y = round_bf16(__fadd_rn(y, __bfloat162float(bias[d])));
    v[i] = y;
  }
  const bf16* norm = kind == 0 ? a.q_norm : (kind == 1 ? a.k_norm : nullptr);
  if (norm != nullptr) {
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < E; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
    ss = warp_sum(ss);
    const float r =
        rsqrtf(__fadd_rn(__fmul_rn(ss, __fdiv_rn(1.0f, static_cast<float>(D))), a.eps));
#pragma unroll
    for (int i = 0; i < E; ++i)
      v[i] = round_bf16(__fmul_rn(__fmul_rn(v[i], r), __bfloat162float(norm[i * 32 + lane])));
  }
  if (kind != 2) {
    // rotate_half: element d < D/2 pairs with -x[d + D/2], d >= D/2 with x[d - D/2].
    const float* cs = a.cos + static_cast<size_t>(b) * D;
    const float* sn = a.sin + static_cast<size_t>(b) * D;
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const int lo = i * 32 + lane, hi = lo + D / 2;
      const float xl = v[i], xh = v[i + E / 2];
      v[i] = round_bf16(__fadd_rn(__fmul_rn(xl, cs[lo]), __fmul_rn(-xh, sn[lo])));
      v[i + E / 2] = round_bf16(__fadd_rn(__fmul_rn(xh, cs[hi]), __fmul_rn(xl, sn[hi])));
    }
  }
  if (kind == 0) {
    bf16* q = a.q_out + (static_cast<size_t>(b) * a.H + hh) * D;
#pragma unroll
    for (int i = 0; i < E; ++i) q[i * 32 + lane] = __float2bfloat16_rn(v[i]);
    return;
  }
  const size_t slot = (static_cast<size_t>(b) * a.KVH + hh) * a.S + a.write_pos[b];
  void* cache = kind == 1 ? a.k_cache : a.v_cache;
  float* scales = kind == 1 ? a.k_scale : a.v_scale;
  if (scales == nullptr) {
    bf16* dst = static_cast<bf16*>(cache) + slot * D;
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i * 32 + lane] = __float2bfloat16_rn(v[i]);
    return;
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = warp_max(amax);
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  int8_t* dst = static_cast<int8_t*>(cache) + slot * D;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.0f), 127.0f);
    dst[i * 32 + lane] = static_cast<int8_t>(c);
  }
  if (lane == 0) scales[slot] = scale;
}

template <int E>
cudaError_t launch_qkv(const QkvArgs& a, int B, cudaStream_t st) {
  const dim3 grid(B, (a.H + 2 * a.KVH + kQkvWarps - 1) / kQkvWarps);
  qkv_decode_kernel<E><<<grid, kQkvWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Requires H % 8 == 0, H <= 32,768, contiguous (R, H) rows and 16-byte
// aligned pointers.  branch null: the norm of x alone, resid not written.
extern "C" int chatts_add_rms_norm(const void* x, const void* branch, const void* weight,
                                   void* resid, void* normed, int R, int H, float eps,
                                   void* stream) {
  if (H % kVec != 0 || H > kVec * kMaxVecs * kMaxThreads || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int needed = (H / kVec + kMaxVecs - 1) / kMaxVecs;  // threads of kMaxVecs vectors
  const int threads = ((needed + 31) / 32) * 32;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(branch);
  const auto* wb = static_cast<const bf16*>(weight);
  auto* rb = static_cast<bf16*>(resid);
  auto* nb = static_cast<bf16*>(normed);
  if (branch != nullptr)
    add_rms_norm_kernel<true><<<R, threads, 0, st>>>(xb, bb, wb, rb, nb, H, eps);
  else
    add_rms_norm_kernel<false><<<R, threads, 0, st>>>(xb, bb, wb, rb, nb, H, eps);
  return static_cast<int>(cudaGetLastError());
}

// out (R, I) contiguous; gate and up rows at their strides (elements).
// Requires I % 8 == 0, strides multiples of 8 and 16-byte aligned pointers.
extern "C" int chatts_silu_mul(const void* gate, const void* up, void* out, int R, int I,
                               long long gate_stride, long long up_stride, void* stream) {
  if (I % kVec != 0 || gate_stride % kVec != 0 || up_stride % kVec != 0 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(R) * (I / kVec);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const unsigned int blocks = static_cast<unsigned int>(want < 65535LL * 32 ? want : 65535LL * 32);
  silu_mul_kernel<<<blocks, threads, 0, st>>>(static_cast<const bf16*>(gate),
                                              static_cast<const bf16*>(up),
                                              static_cast<bf16*>(out), total, I, gate_stride,
                                              up_stride);
  return static_cast<int>(cudaGetLastError());
}

// One decode token a row b < B.  q, k, v: the (B, heads * D) bf16 outputs of
// the projections before their bias, rows at their strides; biases, norms
// nullable; cos, sin (B, D) f32; write_pos (B,) int32; q_out (B, H, D); the
// caches (Bc, KVH, S, D) int8 with (Bc, KVH, S) f32 scales, or bf16 with null
// scales.  Requires D % 64 == 0 and D <= 256.
extern "C" int chatts_qkv_decode(const void* q, const void* k, const void* v,
                                 long long q_stride, long long k_stride, long long v_stride,
                                 const void* q_bias, const void* k_bias, const void* v_bias,
                                 const void* q_norm, const void* k_norm, float eps,
                                 const void* cos, const void* sin, const void* write_pos,
                                 void* q_out, void* k_cache, void* v_cache, void* k_scale,
                                 void* v_scale, int B, int H, int KVH, int D, int S,
                                 void* stream) {
  if (D % 64 != 0 || D > 256 || B < 1 || (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  QkvArgs a;
  a.src[0] = static_cast<const bf16*>(q);
  a.src[1] = static_cast<const bf16*>(k);
  a.src[2] = static_cast<const bf16*>(v);
  a.src_stride[0] = q_stride;
  a.src_stride[1] = k_stride;
  a.src_stride[2] = v_stride;
  a.bias[0] = static_cast<const bf16*>(q_bias);
  a.bias[1] = static_cast<const bf16*>(k_bias);
  a.bias[2] = static_cast<const bf16*>(v_bias);
  a.q_norm = static_cast<const bf16*>(q_norm);
  a.k_norm = static_cast<const bf16*>(k_norm);
  a.eps = eps;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.write_pos = static_cast<const int*>(write_pos);
  a.q_out = static_cast<bf16*>(q_out);
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.H = H;
  a.KVH = KVH;
  a.D = D;
  a.S = S;
  auto st = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
    case 2: return static_cast<int>(launch_qkv<2>(a, B, st));
    case 4: return static_cast<int>(launch_qkv<4>(a, B, st));
    case 6: return static_cast<int>(launch_qkv<6>(a, B, st));
    default: return static_cast<int>(launch_qkv<8>(a, B, st));
  }
}
