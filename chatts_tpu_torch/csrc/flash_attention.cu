// Prefill attention for Hopper (sm_90a): grouped-query attention with a
// position mask and an online softmax, on the bf16 tensor cores.
//
// Replaces chatts_tpu/ops/flash_attention.py::flash_attention (Pallas body
// `_flash_kernel`).
//
// The body is generic over the widths of q/k (DQK) and of v (DV): the
// head_dim 128 instance (`flash_mma_kernel`, both widths 128) is the main
// path's, and `mla_prefill_mma_kernel` (qk 192, v 128, one kv head a query
// head) is multi-head latent attention's prefill (ops/mla.py::mla_prefill).
// Everything below is said of the 128 instance; the other differs only in
// the row widths of q, k and v in shared memory (chunks of 16 bytes a row:
// DQK / 8 and DV / 8, swizzled alike) and in its shared memory: 107 KB
// (MT = 1) or 131 KB (MT = 2).
//
// What it computes, for bf16 and head_dim 128:
//   q (B, T, H, D), k/v (B, S, KVH, D), q_positions (B, T) int32,
//   kv_positions (B, S) int32, kv_valid (B, S) bool  ->  out (B, T, H, D).
//   Query i attends key j when kv_valid[j] and kv_positions[j] <= q_positions[i].
//   The kv head of query head h is h / (H / KVH).  The f32 product is
//   multiplied by `scale`; the softmax is online in f32; p is rounded to bf16
//   for the PV product, as in the reference, while the denominator sums the
//   unrounded p.  A row with no visible key gives 0.  Positions are below
//   2**31 - 1 (that value marks an invalid key inside the kernel).
//
// What bounds it on the H100: arithmetic.  A query tile reuses every key and
// value it loads 64 or 128 times, so the 4 * D operations of each (query,
// visible key) pair dominate, at the tensor cores' 989 TFLOP/s.
//
// What held the first version back: both products ran as f32 FMAs on the
// CUDA cores with every operand read from shared memory, q, k, v and p sat in
// shared memory as f32, the k/v tiles were loaded and then stored between
// block barriers with nothing in flight during the compute, every thread
// scanned 64 positions a tile, and only the position rule skipped a tile.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 2; B4 H40 KVH8
// T = S = 1152): 0.246 ms, 203 TFLOP/s of visible work, the first version
// 2.390 ms, SDPA with the same mask 0.347 ms, the bound 0.0505 ms.
//
// Design (FlashAttention-2's shape on mma.sync.m16n8k16 bf16, f32 sums):
//   * A block of 4 warps takes a tile of 64 * MT query rows of one head
//     (MT = 1 or 2); a warp owns MT m16 row tiles.  The grid is one dimension,
//     ordered so that the last query tiles (the heaviest of a causal prefill)
//     start first and the heads of one kv group are neighbours, to share k
//     and v in L2.
//   * q, and 64-key tiles of k and v, are bf16 in shared memory, rows of 256
//     bytes whose 16-byte chunks are XOR-swizzled by row (chunk ^ (row & 7)),
//     so that ldmatrix (and ldmatrix.trans for v) is free of bank conflicts.
//     k/v tiles arrive by cp.async in a ring of two stages: the next live
//     tile loads while this one is multiplied.  One block barrier a tile.
//     Shared memory: 80 KB (MT = 1) or 96 KB (MT = 2), two blocks an SM.
//   * S = q k^T accumulates in registers; the mask, the running max, exp and
//     the row sum are done on the accumulators.  The f32 scores are
//     multiplied by scale * log2(e), so exp is one ex2; a tile that every
//     row of the warp sees whole skips the mask.  The max is reduced over the
//     four lanes that share a row (two shuffles); the row sum stays a
//     per-lane partial until the end (every lane of a row scales by the same
//     alpha).  Two neighbouring n8 accumulator tiles, packed to bf16x2, are
//     one k16 A fragment of the PV product, so p never touches shared memory.
//   * The running max starts at a finite sentinel (float32 min) and p is
//     zeroed by the mask explicitly, so a row whose first tiles are wholly
//     masked gets alpha = 1 and p = 0.
//   * A tile is skipped when no key in it is valid or its smallest valid key
//     position is above the tile's largest query position: an invalid key's
//     position is replaced by 2**31 - 1 and each warp takes the minimum over
//     the tile with one warp reduction, so every warp reaches the same
//     verdict without a barrier and a skipped tile is never loaded.
//     Positions decide, never indices.
//   * T and S may be any length: rows and keys past the end are zero-filled
//     and masked.  The output tile is staged through the warp's own q rows in
//     shared memory and stored 16 bytes a lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;                       // keys a tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 min, as the reference
constexpr int kIntMin = -2147483647 - 1;
constexpr int kIntMax = 2147483647;           // the position of an invalid key
constexpr unsigned kFull = 0xffffffffu;

template <int MT, int DQK, int DV>
struct Cfg {
  static constexpr int kBQ = kWarps * MT * 16;
  static constexpr int kQRowBytes = DQK * 2;  // one row of q or k
  static constexpr int kVRowBytes = DV * 2;   // one row of v
  static constexpr int kQBytes = kBQ * kQRowBytes;
  static constexpr int kKTileBytes = kBK * kQRowBytes;
  static constexpr int kVTileBytes = kBK * kVRowBytes;
  static constexpr int kStageBytes = kKTileBytes + kVTileBytes;
  // q, two stages of (k, v), two stages of key positions.
  static constexpr int kSmemBytes = kQBytes + 2 * kStageBytes + 2 * kBK * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a swizzled tile of rows of
// RB bytes (at least 8 chunks a row).
template <int RB>
__device__ __forceinline__ int swz(int r, int c) { return r * RB + ((c ^ (r & 7)) << 4); }

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
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

// 2**x in one instruction; 0 for -inf and for anything below -126.
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

// Copy `rows` rows of D bf16 into a swizzled tile.  Row r comes from
// src + (first + r) * stride; rows at or past `limit` are zero-filled.
__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// i / n and i % n, by a shift and a mask where n is a power of two.
template <int N>
__device__ __forceinline__ int div_n(int i) {
  if constexpr ((N & (N - 1)) == 0) return i >> ilog2(N);
  return i / N;
}
template <int N>
__device__ __forceinline__ int mod_n(int i) {
  if constexpr ((N & (N - 1)) == 0) return i & (N - 1);
  return i % N;
}

template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, size_t stride,
                                          int first, int limit, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = div_n<kChunks>(i);
    const int c = mod_n<kChunks>(i);
    const bool in = first + r < limit;
    cp_async16(dst + swz<D * 2>(r, c),
               src + static_cast<size_t>(in ? first + r : 0) * stride + c * 8, in ? 16 : 0);
  }
}

template <int MT, int DQK, int DV>
__device__ __forceinline__ void flash_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_positions,
    const int* __restrict__ kv_positions, const uint8_t* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ out, int B, int T, int S, int H, int KVH, float scale) {
  using C = Cfg<MT, DQK, DV>;
  constexpr int QRB = C::kQRowBytes;
  constexpr int VRB = C::kVRowBytes;
  constexpr int kOut = DV / 8;  // n8 tiles (and 16-byte chunks) of an output row
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t kv0 = qs + C::kQBytes;  // stage s: k at kv0 + s stage, v after it
  int* kpos = reinterpret_cast<int*>(smem + C::kQBytes + 2 * C::kStageBytes);  // [2][kBK]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fg = lane >> 2;  // fragment row
  const int ft = lane & 3;   // thread in the row's group of four

  // The last query tiles first; within a tile, batch rows, then heads.
  const int n_q = (T + C::kBQ - 1) / C::kBQ;
  const int per_tile = B * H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int b = rem / H;
  const int h = rem % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * C::kBQ;
  const int wrow0 = warp * MT * 16;  // the warp's first row in the tile

  const int* qpos_b = q_positions + static_cast<size_t>(b) * T;
  const int* kpos_b = kv_positions + static_cast<size_t>(b) * S;
  const uint8_t* kok_b = kv_valid + static_cast<size_t>(b) * S;

  // q: one cp.async group of its own (the first tile's group follows).
  load_rows<DQK>(qs, q + (static_cast<size_t>(b) * T * H + h) * DQK, static_cast<size_t>(H) * DQK,
                 q0, T, C::kBQ);
  cp_async_commit();

  // The largest query position of the tile, by every warp for itself.
  int qmax = kIntMin;
  for (int r = lane; r < C::kBQ; r += 32) {
    if (q0 + r < T) qmax = max(qmax, min(qpos_b[q0 + r], kIntMax - 1));
  }
  qmax = __reduce_max_sync(kFull, qmax);

  // The positions of this thread's rows: wrow0 + mt*16 + fg (+ 8).
  int qp[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = q0 + wrow0 + mt * 16 + fg + 8 * hh;
      qp[mt][hh] = t < T ? min(qpos_b[t], kIntMax - 1) : kIntMin;
    }

  // The smallest query position among the warp's rows (a row past T: never
  // wholly visible).
  int warp_qmin = kIntMax;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) warp_qmin = min(warp_qmin, min(qp[mt][0], qp[mt][1]));
  warp_qmin = __reduce_min_sync(kFull, warp_qmin);
  const float scale_log2 = scale * 1.4426950408889634f;

  const int n_tiles = (S + kBK - 1) / kBK;
  const __nv_bfloat16* k_base = k + (static_cast<size_t>(b) * S * KVH + kvh) * DQK;
  const __nv_bfloat16* v_base = v + (static_cast<size_t>(b) * S * KVH + kvh) * DV;
  const size_t k_stride = static_cast<size_t>(KVH) * DQK;
  const size_t v_stride = DQK == DV ? k_stride : static_cast<size_t>(KVH) * DV;

  // The first live tile at or after `kt` (n_tiles if none), with this lane's
  // two key positions of it (kIntMax for an invalid key or one past S).
  int e0 = kIntMax, e1 = kIntMax;
  auto next_live = [&](int kt) {
    for (; kt < n_tiles; ++kt) {
      const int s0 = kt * kBK + lane;
      const int s1 = s0 + 32;
      e0 = (s0 < S && kok_b[s0]) ? kpos_b[s0] : kIntMax;
      e1 = (s1 < S && kok_b[s1]) ? kpos_b[s1] : kIntMax;
      if (__reduce_min_sync(kFull, min(e0, e1)) <= qmax) break;
    }
    return kt;
  };
  // Starts the copies of tile kt; returns the tile's largest key position.
  auto start_tile = [&](int kt, int stage) {
    const uint32_t ks = kv0 + stage * C::kStageBytes;
    load_rows<DQK>(ks, k_base, k_stride, kt * kBK, S, kBK);
    load_rows<DV>(ks + C::kKTileBytes, v_base, v_stride, kt * kBK, S, kBK);
    if (warp == 0) {
      kpos[stage * kBK + lane] = e0;
      kpos[stage * kBK + 32 + lane] = e1;
    }
    cp_async_commit();
    return __reduce_max_sync(kFull, max(e0, e1));
  };

  float m[MT][2], l[MT][2], o[MT][kOut][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = kNegInf;
      l[mt][hh] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kOut; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  // ldmatrix lane addressing.  A (q): lanes 0-15 rows 0-15 at the k16 step's
  // first chunk, lanes 16-31 the same rows at its second.  B from k: lanes
  // 0-7 keys 0-7 first chunk, 8-15 keys 0-7 second chunk, 16-23 keys 8-15
  // first chunk, 24-31 keys 8-15 second chunk (two n8 tiles of one k16
  // step).  B from v, transposed: lanes 0-15 keys 0-15 at the first of two d
  // chunks, lanes 16-31 at the second (two n8 tiles of d for one k16 step).
  const int a_row = wrow0 + (lane & 15);
  const int a_half = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_half = (lane >> 3) & 1;
  const int vb_row = lane & 15;
  const int vb_half = lane >> 4;

  int kt = next_live(0);
  int stage = 0;
  int kmax = kIntMax, kmax_next = kIntMax;  // of the tile in hand, of the one in flight
  if (kt < n_tiles) kmax = start_tile(kt, 0);
  while (kt < n_tiles) {
    cp_async_wait_all();
    __syncthreads();  // tile kt (and q) visible; the other stage is no longer read
    const int nxt = next_live(kt + 1);
    if (nxt < n_tiles) kmax_next = start_tile(nxt, stage ^ 1);

    const uint32_t ks = kv0 + stage * C::kStageBytes;
    const uint32_t vs = ks + C::kKTileBytes;
    const int* kp = kpos + stage * kBK;

    // S = q k^T.
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], qs + swz<QRB>(a_row + mt * 16, 2 * kk + a_half));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + swz<QRB>(np * 16 + kb_row, 2 * kk + kb_half));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // Mask, running max, p and the row sums, on the accumulators.  Element e
    // of n8 tile n is row fg + 8 (e >> 1), key 8 n + 2 ft + (e & 1).  The
    // scores are kept times log2(e), so that exp is one ex2.  A tile whose
    // every key every row of the warp sees (its largest key position, invalid
    // keys counted as 2**31 - 1, is at most the warp's smallest query
    // position) needs no mask.
    const bool all_visible = kmax <= warp_qmin;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {kNegInf, kNegInf};
      if (all_visible) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][n][e] *= scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int2 p2 = *reinterpret_cast<const int2*>(kp + 8 * n + 2 * ft);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = ((e & 1) ? p2.y : p2.x) <= qp[mt][e >> 1];
            s[mt][n][e] = ok ? s[mt][n][e] * scale_log2 : kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 2));
        const float m_new = fmaxf(m[mt][hh], mx[hh]);
        const float alpha = ex2(m[mt][hh] - m_new);
        m[mt][hh] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            // A masked element holds the sentinel: zero it explicitly.
            const float p = (all_visible || s[mt][n][e] > kNegInf) ? ex2(s[mt][n][e] - m_new) : 0.f;
            s[mt][n][e] = p;
            rs += p;
          }
        l[mt][hh] = l[mt][hh] * alpha + rs;
#pragma unroll
        for (int n = 0; n < kOut; ++n) {
          o[mt][n][2 * hh] *= alpha;
          o[mt][n][2 * hh + 1] *= alpha;
        }
      }
    }

    // O += p v, p rounded to bf16 straight from the accumulators.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16x2(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[mt][1] = pack_bf16x2(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[mt][2] = pack_bf16x2(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[mt][3] = pack_bf16x2(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + swz<VRB>(j * 16 + vb_row, 2 * dp + vb_half));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }

    kt = nxt;
    kmax = kmax_next;
    stage ^= 1;
  }

  // Every copy into q's rows has landed and every warp is done with q.
  cp_async_wait_all();
  __syncthreads();

  // Normalise, stage the warp's rows in its own q rows, store 16 bytes a lane.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[mt][hh];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float inv = 1.f / (sum > 0.f ? sum : 1.f);
      const int r = wrow0 + mt * 16 + fg + 8 * hh;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        *reinterpret_cast<uint32_t*>(smem + swz<QRB>(r, n) + ft * 4) =
            pack_bf16x2(o[mt][n][2 * hh] * inv, o[mt][n][2 * hh + 1] * inv);
      }
    }
  __syncwarp();
  for (int i = lane; i < MT * 16 * kOut; i += 32) {
    const int r = wrow0 + div_n<kOut>(i);
    const int c = mod_n<kOut>(i);
    const int t = q0 + r;
    if (t < T) {
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * T + t) * H + h) * DV + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<QRB>(r, c));
    }
  }
}

#define FLASH_ARGS                                                                          \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k,                 \
      const __nv_bfloat16 *__restrict__ v, const int *__restrict__ q_positions,             \
      const int *__restrict__ kv_positions, const uint8_t *__restrict__ kv_valid,           \
      __nv_bfloat16 *__restrict__ out, int B, int T, int S, int H, int KVH, float scale

// The main path's instance: head_dim 128.
template <int MT>
__global__ void __launch_bounds__(kThreads, 2) flash_mma_kernel(FLASH_ARGS) {
  flash_body<MT, 128, 128>(q, k, v, q_positions, kv_positions, kv_valid, out, B, T, S, H, KVH,
                           scale);
}

// Multi-head latent attention's prefill: qk 192 (nope 128 + rope 64), v 128.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1) mla_prefill_mma_kernel(FLASH_ARGS) {
  flash_body<MT, 192, 128>(q, k, v, q_positions, kv_positions, kv_valid, out, B, T, S, H, KVH,
                           scale);
}

template <int MT, int DQK, int DV, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v, const void* q_positions,
           const void* kv_positions, const void* kv_valid, void* out, int B, int T, int S, int H,
           int KVH, float scale, cudaStream_t stream) {
  using C = Cfg<MT, DQK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((T + C::kBQ - 1) / C::kBQ) * B * H;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_positions),
      static_cast<const int*>(kv_positions), static_cast<const uint8_t*>(kv_valid),
      static_cast<__nv_bfloat16*>(out), B, T, S, H, KVH, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,T,H,128), k/v (B,S,KVH,128) bf16, contiguous and 16-byte aligned;
// q_positions (B,T) and kv_positions (B,S) int32; kv_valid (B,S) one byte each.
// Requires H % KVH == 0 and T, S >= 1.  block_q is the query tile, 64 or 128
// rows (ops/flash_attention.py picks it by T).  Returns cudaGetLastError();
// 1 (cudaErrorInvalidValue) for another block_q.
extern "C" int chatts_flash_attention(const void* q, const void* k, const void* v,
                                      const void* q_positions, const void* kv_positions,
                                      const void* kv_valid, void* out, int B, int T, int S,
                                      int H, int KVH, float scale, int block_q, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (block_q == 64) {
    return launch<1, 128, 128>(flash_mma_kernel<1>, q, k, v, q_positions, kv_positions, kv_valid,
                               out, B, T, S, H, KVH, scale, st);
  }
  if (block_q == 128) {
    return launch<2, 128, 128>(flash_mma_kernel<2>, q, k, v, q_positions, kv_positions, kv_valid,
                               out, B, T, S, H, KVH, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same at qk width 192 and v width 128: q (B,T,H,192), k (B,S,KVH,192),
// v (B,S,KVH,128) bf16, out (B,T,H,128); the rest as above.
extern "C" int chatts_mla_prefill(const void* q, const void* k, const void* v,
                                  const void* q_positions, const void* kv_positions,
                                  const void* kv_valid, void* out, int B, int T, int S, int H,
                                  int KVH, float scale, int block_q, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (block_q == 64) {
    return launch<1, 192, 128>(mla_prefill_mma_kernel<1>, q, k, v, q_positions, kv_positions,
                               kv_valid, out, B, T, S, H, KVH, scale, st);
  }
  if (block_q == 128) {
    return launch<2, 192, 128>(mla_prefill_mma_kernel<2>, q, k, v, q_positions, kv_positions,
                               kv_valid, out, B, T, S, H, KVH, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
