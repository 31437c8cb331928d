// Absorbed decode attention of multi-head latent attention (MLA) over the
// latent cache, for Hopper (sm_90a): ops/mla.py::mla_decode.
//
// What it computes, bf16 in and out, f32 sums: each query row r attends the
// first lengths[r] positions of cache row rows[r].  A cache row is 576 bf16:
// the token's normed c_kv (512) and its roped key (64), shared by the 16
// heads.  Three steps:
//   1. `mla_decode_bmm_kernel`: q_lat[r, h] = q_nope[r, h] (128) @ w_uk[h]
//      (128 x 512), written beside q_pe into q (R, 16, 576).
//   2. `mla_decode_split_kernel` + decode_split.cuh's merge: per head,
//      softmax(q . row * scale) over the positions, times each position's
//      c_kv -> o (R, 16, 512), split over the positions and merged by
//      logsumexp, as B2 splits (the merge's heads are 128 wide, so a head's
//      512 columns are four of them, sharing its max and sum).
//   3. `mla_decode_bmm_kernel`: out[r, h] = o[r, h] (512) @ w_uv[h] (512 x
//      128).
//
// What bounds it on the H100: the cache rows, 1,152 bytes a position, read
// once for 16 heads; with 16 x (576 + 512) multiply-adds a position the
// products must run on the tensor cores to stay under the bytes.
//
// Design of the split kernel (m16n8k16 bf16 mma.sync, f32 sums):
//   * The 16 heads of one query are exactly one m16 tile: q (16 x 576) is
//     the A operand for the scores, and p (16 heads x 64 positions) the A
//     operand of the output.  A block of 4 warps takes one query row and
//     one chunk of its positions (a split); tiles of 64 positions, each
//     576 bf16 wide (72 chunks of 16 bytes, XOR-swizzled by row as B1's),
//     arrive by cp.async in a ring of two stages.  Shared memory: q 18 KB,
//     two tiles 144 KB, the partial scores 18 KB: one block an SM.
//   * Scores: warp w computes the 16 heads x 64 positions of the tile over
//     columns [144 w, 144 w + 144) (9 k16 steps, eight independent n8
//     accumulator tiles) and writes its partial sums to shared memory.
//   * Softmax: after a barrier every warp adds the four partials (in warp
//     order) of the whole 16 x 64 tile into the A-fragment layout, scales
//     and masks them past the chunk's end, and runs the same online softmax
//     (the same operations, so every warp holds the same max and sums).
//   * Output: warp w owns latent columns [128 w, 128 w + 128) (16 n8
//     tiles), the value rows read from the same tile with ldmatrix.trans:
//     the latent is both key and value, so each position is loaded once.
//   * A split writes its unnormalised sums, its max (natural log units) and
//     its sum of p to the workspace; a split that starts at or past its
//     row's length returns at once, and the merge reads only those below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

constexpr int kH = 16;            // heads: one m16 tile
constexpr int kL = 512;           // the latent c_kv: the output's width
constexpr int kDL = 576;          // a cache row: c_kv and the rope key
constexpr int kRB = kDL * 2;      // bytes a row
constexpr int kChunks = kDL / 8;  // 16-byte chunks a row
constexpr int kBK = 64;           // positions a tile
constexpr int kThreads = 128;
constexpr int kSStride = kBK + 8;  // f32 scores a row in shared memory
constexpr int kQBytes = kH * kRB;
constexpr int kTileBytes = kBK * kRB;
constexpr int kStepsAWarp = kDL / 16 / (kThreads / 32);  // k16 steps of the scores a warp
constexpr int kSmemBytes = kQBytes + 2 * kTileBytes + (kThreads / 32) * kH * kSStride * 4;
constexpr float kNegInf = -3.4028234663852886e38f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int swz(int r, int c) { return r * kRB + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// `rows` rows of 576 bf16 into a swizzled tile: row r from src + (first + r)
// * kDL; rows at or past `limit` zero-filled.
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int first,
                                          int limit, int rows) {
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = first + r < limit;
    cp_async16(dst + swz(r, c), src + static_cast<size_t>(in ? first + r : 0) * kDL + c * 8,
               in ? 16 : 0);
  }
}

// Grid (splits, R): block (z, r) takes positions [z * chunk, min((z + 1) *
// chunk, length)) of query row r.
__global__ void __launch_bounds__(kThreads, 1) mla_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
    const int* __restrict__ rows, const int* __restrict__ lengths, float* __restrict__ ws, int S,
    int splits, int chunk, float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t kv0 = qs + kQBytes;
  float* sc = reinterpret_cast<float*>(smem + kQBytes + 2 * kTileBytes);

  const int z = blockIdx.x;
  const int r = blockIdx.y;
  const int length = min(max(lengths[r], 0), S);
  const int begin = z * chunk;
  if (begin >= length) return;
  const int end = min(begin + chunk, length);
  const __nv_bfloat16* src = cache + static_cast<size_t>(rows[r]) * S * kDL;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fg = lane >> 2;
  const int ft = lane & 3;
  const float scale_log2 = scale * 1.4426950408889634f;

  load_rows(qs, q + static_cast<size_t>(r) * kH * kDL, 0, kH, kH);
  cp_async_commit();
  load_rows(kv0, src, begin, end, kBK);
  cp_async_commit();

  // ldmatrix addressing, as B1's (flash_attention.cu).
  const int a_row = lane & 15;
  const int a_half = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_half = (lane >> 3) & 1;
  const int vb_row = lane & 15;
  const int vb_half = lane >> 4;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int stage = 0;
  for (int k0 = begin; k0 < end; k0 += kBK) {
    cp_async_wait_all();
    __syncthreads();  // this tile visible; the other stage and the scores free
    if (k0 + kBK < end) {
      load_rows(kv0 + (stage ^ 1) * kTileBytes, src, k0 + kBK, end, kBK);
      cp_async_commit();
    }
    const uint32_t ks = kv0 + stage * kTileBytes;

    // Scores split over the columns: warp w sums the k16 steps [9 w, 9 w +
    // 9) of all 64 positions (eight independent accumulator tiles), and
    // leaves its partial sums in shared memory.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kStepsAWarp; ++i) {
      const int kk = warp * kStepsAWarp + i;
      uint32_t a[4];
      ldmatrix_x4(a, qs + swz(a_row, 2 * kk + a_half));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + swz(np * 16 + kb_row, 2 * kk + kb_half));
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    {
      float* mine = sc + warp * kH * kSStride;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(mine + fg * kSStride + 8 * n + 2 * ft) =
            make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(mine + (fg + 8) * kSStride + 8 * n + 2 * ft) =
            make_float2(s[n][2], s[n][3]);
      }
    }
    __syncthreads();

    // The whole tile's scores, the four partials added in warp order, in
    // the A-fragment layout: p[n][e] is head fg + 8 (e >> 1), position
    // 8 n + 2 ft + (e & 1); scaled by scale * log2(e), masked past the end.
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        const float* part = sc + w * kH * kSStride;
        const float2 a = *reinterpret_cast<const float2*>(part + fg * kSStride + 8 * n + 2 * ft);
        const float2 b =
            *reinterpret_cast<const float2*>(part + (fg + 8) * kSStride + 8 * n + 2 * ft);
        lo.x += a.x;
        lo.y += a.y;
        hi.x += b.x;
        hi.y += b.y;
      }
      const int key = k0 + 8 * n + 2 * ft;
      p[n][0] = key < end ? lo.x * scale_log2 : kNegInf;
      p[n][1] = key + 1 < end ? lo.y * scale_log2 : kNegInf;
      p[n][2] = key < end ? hi.x * scale_log2 : kNegInf;
      p[n][3] = key + 1 < end ? hi.y * scale_log2 : kNegInf;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(p[n][2 * hh], p[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = ex2(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float v = p[n][e] > kNegInf ? ex2(p[n][e] - m_new) : 0.f;
          p[n][e] = v;
          rs += v;
        }
      l[hh] = l[hh] * alpha + rs;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // o += p c_kv over the warp's 128 latent columns, p rounded to bf16.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(p[2 * j][0], p[2 * j][1]);
      pa[1] = pack_bf16x2(p[2 * j][2], p[2 * j][3]);
      pa[2] = pack_bf16x2(p[2 * j + 1][0], p[2 * j + 1][1]);
      pa[3] = pack_bf16x2(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, ks + swz(j * 16 + vb_row, warp * 16 + 2 * dp + vb_half));
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    stage ^= 1;
  }

  // The part: sums [part][head][512], then (max, sum) for each of the
  // merge's four 128-wide heads of a head.
  const size_t part = static_cast<size_t>(r) * splits + z;
  const size_t n_parts = static_cast<size_t>(gridDim.y) * splits;
  float* acc = ws + part * kH * kL;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
    const int head = fg + 8 * hh;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<float2*>(acc + head * kL + warp * 128 + 8 * n + 2 * ft) =
          make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
    if (warp == 0 && ft == 0) {
      const float2 ml = make_float2(m[hh] * kLn2, l[hh]);
#pragma unroll
      for (int g = 0; g < kL / 128; ++g) {
        *reinterpret_cast<float2*>(decode_split::part_ml(ws, n_parts, part, kH * kL / 128,
                                                         head * (kL / 128) + g)) = ml;
      }
    }
  }
}

// y[r, h, :N] = x[r, h, :K] @ w[h] (K x N), bf16 in and out, f32 sums, on
// the tensor cores; x's and y's rows (r, h) are ldx and ldy elements apart.
// A block of 4 warps takes 64 rows x 64 columns of one head, K in steps of
// 64 through shared memory (rows of 128 bytes, swizzled as above); warp w
// owns rows [16 w, 16 w + 16): x is the A operand (ldmatrix), w the B
// operand (ldmatrix.trans of its k-major rows, as B1 reads v).
constexpr int kBmmTile = 64;
constexpr int kBmmRow = kBmmTile * 2;  // bytes a row of a tile

__device__ __forceinline__ int bswz(int r, int c) { return r * kBmmRow + ((c ^ (r & 7)) << 4); }

__global__ void __launch_bounds__(128) mla_decode_bmm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ y, int R, int H, int K, int N, int ldx, int ldy) {
  __shared__ __align__(128) uint8_t as[kBmmTile * kBmmRow];
  __shared__ __align__(128) uint8_t bs[kBmmTile * kBmmRow];
  const int h = blockIdx.z;
  const int n0 = blockIdx.x * kBmmTile;
  const int r0 = blockIdx.y * kBmmTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fg = lane >> 2;
  const int ft = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBmmTile) {
    for (int i = tid; i < kBmmTile * 8; i += 128) {
      const int rr = i >> 3;
      const int c = i & 7;
      const int row = r0 + rr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < R) {
        v = *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(row) * H + h) * ldx + k0 +
                                            c * 8);
      }
      *reinterpret_cast<uint4*>(as + bswz(rr, c)) = v;
      *reinterpret_cast<uint4*>(bs + bswz(rr, c)) = *reinterpret_cast<const uint4*>(
          w + (static_cast<size_t>(h) * K + k0 + rr) * N + n0 + c * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBmmTile / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(as) + bswz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(bs) + bswz(kk * 16 + (lane & 15), 2 * dp + (lane >> 4)));
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + warp * 16 + fg + 8 * hh;
    if (row >= R) continue;
    __nv_bfloat16* dst = y + (static_cast<size_t>(row) * H + h) * ldy + n0 + 2 * ft;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16x2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

}  // namespace

// Requires K % 64 == 0, N % 64 == 0, ldx % 8 == 0, ldy % 2 == 0 and
// 16-byte aligned x and w.  Returns cudaGetLastError().
extern "C" int chatts_mla_bmm(const void* x, const void* w, void* y, int R, int H, int K, int N,
                              int ldx, int ldy, void* stream) {
  if (K % 64 || N % 64 || ldx % 8 || ldy % 2 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(N / kBmmTile, (R + kBmmTile - 1) / kBmmTile, H);
  mla_decode_bmm_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), R, H, K, N, ldx, ldy);
  return static_cast<int>(cudaGetLastError());
}

// q (R, 16, 576) bf16 (q_lat then q_pe), cache (B, S, 576) bf16, rows and
// lengths (R,) int32, ws f32 of R * splits * 64 * 130 elements, out (R, 16,
// 512) bf16.  (splits, chunk) must cover S (decode_split::plan_ok).
// Returns cudaGetLastError() after the two launches, or the error of setting
// the kernel's shared-memory size.
extern "C" int chatts_mla_decode(const void* q, const void* cache, const void* rows,
                                 const void* lengths, void* ws, void* out, int R, int S,
                                 int splits, int chunk, float scale, void* stream) {
  if (R < 1 || !decode_split::plan_ok(S, splits, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  auto st = static_cast<cudaStream_t>(stream);
  mla_decode_split_kernel<<<dim3(splits, R), kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache),
      static_cast<const int*>(rows), static_cast<const int*>(lengths), static_cast<float*>(ws), S,
      splits, chunk, scale);
  decode_split::decode_merge_kernel<<<dim3(kH * kL / decode_split::kD, R), decode_split::kD, 0,
                                      st>>>(static_cast<const float*>(ws),
                                            static_cast<const int*>(lengths),
                                            static_cast<__nv_bfloat16*>(out), kH * kL / 128, 1, S,
                                            splits, chunk);
  return static_cast<int>(cudaGetLastError());
}
