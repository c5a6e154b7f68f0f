// Paged ragged decode attention for NVIDIA Hopper (sm_90a), two lanes.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention/kernel.py:
//   * `paged_attention_kernel` (body `_kernel`), the scratch lane, by
//     `paged_scratch_mma_kernel` (bf16) and `paged_scratch_kernel`
//     (float32): gather a row's pages through its page table, then
//     grouped SDPA with an exact softmax;
//   * `paged_attention_streamed` (body `_stream_body`), the streamed lane,
//     by `paged_split_kernel` + `paged_combine_kernel`: an online softmax
//     over the row's pages, split along the KV axis (flash-decoding).
//
// Shapes: q (B, sq, hq, hd); k/v pages (P + 1, ps, kv, hd), page 0 the
// null page; page_table (B, P_seq) int32; kv_len, q_offset (B,) int32;
// out (B, sq, hq, hd) in q's type.  T is float or bf16.  The g = hq / kv
// query heads of a KV head and the sq queries form g * sq "rows" r =
// j * sq + s that share every K/V element.
//
// Numerics, as in the reference: logits in f32 (bf16 products are exact
// in f32), times hd^-0.5; -1e30 for causal (q_offset + s < t) and length
// (t >= kv_len) masking.  The scratch lane takes max, exp, sum and
// divides, rounds the weights to T and accumulates P.V in f32 (over t in
// order at float32, in the tensor cores' order at bf16) before rounding
// to T.  The streamed lane keeps a running max m,
// denominator l and f32 accumulator per row and normalises at the end.
//
// What bounds both lanes on the H100: the bytes of K/V pages a row
// attends over (2 * tokens * kv * hd * sizeof(T) per row) against 3.35
// TB/s; the arithmetic is 4 * sq * hq * hd flops per attended token, far
// below the tensor cores' rate.  Both lanes read only the tokens the
// length mask keeps: once a row has a valid position (kv_len >= 1, and
// position 0 is never causally masked) every token t >= kv_len has weight
// exp(-1e30 - max) = 0 exactly, so skipping it changes nothing.  A row
// with kv_len = 0 reads its whole table and comes out as the uniform
// average, as in the reference.  The gather is read-only: aliased page
// tables are in contract.
//
// What the streamed design does about the bound:
//   * grid (B, kv, n_split * row groups): each block takes a contiguous
//     run of whole page blocks of one (row, KV head) and 16 query rows (the
//     mma M), so a long row is read by many SMs at once; the wrapper picks
//     n_split from B * kv, the table width and the SM count.  A split that
//     starts at or past the row's valid depth exits at once with the
//     sentinel partial m = -1e30, l = 0, acc = 0; `paged_combine_kernel`
//     rescales the f32 partials by exp(m - max m), sums and divides by l;
//   * K/V tiles of 64 tokens travel by 16-byte cp.async.cg into a two-stage
//     ring: the next tile's copies fly while the block computes on this
//     one, and three blocks share an SM.  A block first copies its split's
//     page-table entries into shared memory, so issuing a tile waits on no
//     global load.  Shared rows are 16-byte chunks XOR-swizzled by row, so
//     ldmatrix reads them without bank conflicts;
//   * at bf16 Q.K^T and P.V run on the tensor cores
//     (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, operands by ldmatrix);
//     each warp owns 16 tokens of a tile and keeps its own m, l and
//     accumulator in registers, the four warps merged once per split.  P
//     enters the second product as bf16 hi + lo (two mma), so the f32
//     weights keep ~16 bits; Q.K^T is exact products summed in f32;
//   * at float32 the math stays on the CUDA cores with 16-byte shared
//     loads (TF32 would break the float32 contract of 1e-5).
//
// What the scratch design does: only Q and the f32 logits of the window
// stay resident in shared memory; K, then V, stream through a cp.async
// ring of token tiles, so it holds windows up to about (227 KB - Q - ring)
// / (4 * g * sq) tokens.  At bf16 (`paged_scratch_mma_kernel`) both
// products run on the tensor cores (mma.sync m16n8k16, P from the rounded
// logits, V by ldmatrix.trans, the P.V sums in registers across tiles),
// the ring has two to four stages, and a window of 512 tokens or more is
// split over a cluster of 2 to 8 CTAs whose row max and sum meet in
// distributed shared memory, so the softmax stays exact over the window.
// At float32 (`paged_scratch_kernel`) the arithmetic and its order are
// the lane's from before the ring: an fmaf chain over d, then over t
// (TF32 would break the float32 contract).  Both take any head dim of
// whole 16-byte chunks; the streamed lane is compiled for widths 16, 32,
// 64, 80, 96, 128, 192 and 256 and runs any head dim up to 256 on the next
// width up, the extra columns zero in shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: expf and the divides are exact).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_grant.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;
constexpr int kGroupRows = 16;      // query rows per streamed block (mma M)
constexpr int kWarpTokens = 16;     // tokens per warp per tile
constexpr int kTileTokens = kWarps * kWarpTokens;
constexpr int kScratchTileBytes = 16384;
constexpr int kScratchAcc = 8;      // P.V sums a scratch thread keeps
// streamed ring depth: two stages (68 KB at bf16, hd 128) let three blocks
// share an SM; a three-stage ring measured slower, as fewer warps then hide
// the copies' latency.  Where two stages would pass 192 KB (float32 at hd
// 256) the ring has one, and copies no longer overlap the math.
constexpr int kTwoStageMaxBytes = 192 * 1024;
__host__ __device__ constexpr int ring_stages(int hd, int elem_bytes) {
  return 2 * 2 * kTileTokens * hd * elem_bytes <= kTwoStageMaxBytes ? 2 : 1;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// the weights of the scratch lane are cast to the value type before P.V
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// the 16 bytes of a shared chunk as four f32 values, in order
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Shared tiles hold one token (or query row) per row of hd elements, in
// 16-byte chunks; chunk c of row t sits at c ^ (t & mask), where mask + 1
// is the largest power of two <= 8 that divides the chunks per row.
__host__ __device__ constexpr int swz_mask(int chunks) {
  return ((chunks & -chunks) < 8 ? (chunks & -chunks) : 8) - 1;
}
template <typename T>
__device__ __forceinline__ int swz(int row, int chunk, int hd, int mask) {
  constexpr int kVec = 16 / sizeof(T);
  return row * hd + ((chunk ^ (row & mask)) * kVec);
}

struct Geom {
  int sq, hq, kv, hd, ps, p_seq, causal;
  float scale;
};

// tokens a row must read: the valid depth, or the whole table when the
// row holds no valid position
__device__ __forceinline__ int tokens_needed(int len, int depth) {
  return len > 0 ? min(len, depth) : depth;
}

__device__ __forceinline__ float mask_logit(float v, int ta, int s, int qo,
                                            int len, int causal) {
  if (causal && qo + s < ta) v = kNegBig;
  if (ta >= len) v = kNegBig;
  return v;
}

// -- cp.async, ldmatrix, mma ------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with full == false nothing is read and the
// destination is zero-filled
// (no memory clobber: the destination is read only after
// cp_async_wait and a barrier, so nothing around the issue needs ordering)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Copy the page-table entries of tokens [t_base, t_end) into shared
// memory (pages[i] = the entry of page t_base / ps + i), so that issuing a
// tile waits on no global load.
__device__ __forceinline__ void load_pages(const int32_t* __restrict__ pt_row,
                                           int t_base, int t_end, int ps,
                                           int* pages) {
  const int p0 = t_base / ps;
  const int np = t_end > t_base ? (t_end - 1) / ps - p0 + 1 : 0;
  for (int i = threadIdx.x; i < np; i += blockDim.x) pages[i] = pt_row[p0 + i];
}

// Issue the copies of tokens [t0, t0 + tt) of pool a (and of pool b, if
// given: the same rows of V beside K), KV head h, into swizzled tiles of
// width hd; tokens at or past t_end, and the columns past the pools' own
// head dim src_hd (<= hd), are zero-filled without a load.  pages[i] is
// the physical page of page index t_base / ps + i.  A thread's copies
// are kThreads apart; their (token, chunk, page, offset) advance by
// additions, not divides.
template <typename T>
__device__ __forceinline__ void issue_tile(
    const T* __restrict__ pool_a, const T* __restrict__ pool_b,
    const int* pages, int t_base, int h, int ps, int kv, int hd, int t0,
    int tt, int t_end, T* dst_a, T* dst_b, int src_hd = 0) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = hd / kVec;
  const int mask = swz_mask(cpr);
  if (src_hd == 0) src_hd = hd;
  const int src_cpr = src_hd / kVec;
  const int total = tt * cpr;
  int i = threadIdx.x;
  if (i >= total) return;
  int t = i / cpr;
  int c = i - t * cpr;
  const int dt = kThreads / cpr;
  const int dc = kThreads - dt * cpr;
  int ta = t0 + t;
  int pg = ta / ps - t_base / ps;  // index into pages[]
  int po = ta % ps;
  for (; i < total; i += kThreads) {
    const bool in = ta < t_end && c < src_cpr;
    size_t off = 0;
    if (in) {
      off = ((static_cast<size_t>(pages[pg]) * ps + po) * kv + h) * src_hd +
            c * kVec;
    }
    const int d = swz<T>(t, c, hd, mask);
    cp_async16(dst_a + d, pool_a + off, in);
    if (pool_b != nullptr) cp_async16(dst_b + d, pool_b + off, in);
    int adv = dt;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++adv;
    }
    t += adv;
    ta += adv;
    po += adv;
    while (po >= ps) {
      po -= ps;
      ++pg;
    }
  }
}

// Q rows r = j * sq + s of the group, as f32, qst floats apart
template <typename T>
__device__ void load_q(const T* __restrict__ q, int b, int h, const Geom& gm,
                       int qst, float* Qs) {
  const int g = gm.hq / gm.kv;
  for (int i = threadIdx.x; i < g * gm.sq * gm.hd; i += blockDim.x) {
    const int r = i / gm.hd;
    const int d = i - r * gm.hd;
    const int j = r / gm.sq;
    const int s = r - j * gm.sq;
    Qs[r * qst + d] = to_f(q[((static_cast<size_t>(b) * gm.sq + s) * gm.hq +
                              h * g + j) * gm.hd + d]);
  }
}

template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, int b, int h,
                                          const Geom& gm, int r, int d,
                                          float v) {
  const int g = gm.hq / gm.kv;
  const int j = r / gm.sq;
  const int s = r - j * gm.sq;
  out[((static_cast<size_t>(b) * gm.sq + s) * gm.hq + h * g + j) * gm.hd +
      d] = from_f<T>(v);
}

// -- scratch lane -----------------------------------------------------------

// tokens per scratch tile: a multiple of 4 (the P.V loop reads weights
// four tokens at a time), at most 64
__host__ __device__ inline int scratch_tile(int hd, int elem_bytes) {
  const int t = (kScratchTileBytes / (hd * elem_bytes)) & ~3;
  return t < 64 ? (t > 4 ? t : 4) : 64;
}

// Stream tokens [0, n) of one pool through a two-stage ring of tt-token
// tiles whose tile 0 was already issued into slot s0; body(tile, t0,
// count) runs on each tile once every thread's copies have landed.  The
// last iteration issues tile 0 of `next` (if any) into the following
// slot, so its copies fly while the caller works between two streams.
template <typename T, typename F>
__device__ void scratch_ring(const T* __restrict__ pool, const T* next,
                             const int* pages, int h, const Geom& gm, int n,
                             int tt, T* ring, int s0, F&& body) {
  const int n_tiles = (n + tt - 1) / tt;
  const int stage = tt * gm.hd;
  for (int it = 0; it < n_tiles; ++it) {
    T* following = ring + ((s0 + it + 1) & 1) * stage;
    if (it + 1 < n_tiles)
      issue_tile<T>(pool, nullptr, pages, 0, h, gm.ps, gm.kv, gm.hd,
                    (it + 1) * tt, tt, n, following, nullptr);
    else if (next != nullptr)
      issue_tile<T>(next, nullptr, pages, 0, h, gm.ps, gm.kv, gm.hd, 0, tt,
                    n, following, nullptr);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    body(ring + ((s0 + it) & 1) * stage, it * tt, min(tt, n - it * tt));
    __syncthreads();  // the slot is refilled by the next iteration
  }
}

// The float32 scratch lane (bf16 runs paged_scratch_mma_kernel).
__global__ void __launch_bounds__(kThreads) paged_scratch_kernel(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    float* __restrict__ out, Geom gm) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = gm.hq / gm.kv;
  const int rows = g * gm.sq;
  const int hd = gm.hd;
  const int depth = gm.p_seq * gm.ps;
  const int len = kv_len[b];
  const int qo = q_off[b];
  const int n = tokens_needed(len, depth);
  const int tt = scratch_tile(hd, sizeof(T));
  const int mask = swz_mask(hd / kVec);
  // layout: ring (2 tiles) | Qs (rows x (hd + 4): 16-byte rows, four
  // banks apart) | L (rows x lst, lst = n rounded up to 4) | the row's
  // page table
  const int qst = hd + 4;
  const int lst = (n + 3) & ~3;
  T* ring = reinterpret_cast<T*>(smem);
  float* Qs = reinterpret_cast<float*>(ring + 2 * tt * hd);
  float* L = Qs + rows * qst;
  int* pages = reinterpret_cast<int*>(L + rows * ((depth + 3) & ~3));
  load_pages(pt + static_cast<size_t>(b) * gm.p_seq, 0, n, gm.ps, pages);
  load_q(q, b, h, gm, qst, Qs);
  __syncthreads();
  issue_tile<T>(kp, nullptr, pages, 0, h, gm.ps, gm.kv, hd, 0, tt, n, ring,
                nullptr);
  cp_async_commit();
  const int n_tiles = (n + tt - 1) / tt;
  // logits L[r][t] of every row against each K tile.  A thread runs four
  // dots at once (independent fmaf chains, each over d in order) from
  // 16-byte loads; the rows of one token are neighbouring threads, so a
  // warp reads few K rows.
  scratch_ring(kp, vp, pages, h, gm, n, tt, ring, 0,
               [&](const T* Ks, int t0, int cnt) {
                 const int total = rows * cnt;
                 for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
                   float dot[4];
                   int tk[4], rk[4];
#pragma unroll
                   for (int u = 0; u < 4; ++u) {
                     const int i = min(i0 + u * kThreads, total - 1);
                     tk[u] = i / rows;
                     rk[u] = i - tk[u] * rows;
                     dot[u] = 0.0f;
                   }
                   for (int c = 0; c < hd / kVec; ++c) {
#pragma unroll
                     for (int u = 0; u < 4; ++u) {
                       float kf[kVec];
                       unpack(*reinterpret_cast<const uint4*>(
                                     Ks + swz<T>(tk[u], c, hd, mask)),
                                 kf);
                       const float* qr = Qs + rk[u] * qst + c * kVec;
#pragma unroll
                       for (int e4 = 0; e4 < kVec; e4 += 4) {
                         const float4 qv =
                             *reinterpret_cast<const float4*>(qr + e4);
                         dot[u] = fmaf(qv.x, kf[e4], dot[u]);
                         dot[u] = fmaf(qv.y, kf[e4 + 1], dot[u]);
                         dot[u] = fmaf(qv.z, kf[e4 + 2], dot[u]);
                         dot[u] = fmaf(qv.w, kf[e4 + 3], dot[u]);
                       }
                     }
                   }
#pragma unroll
                   for (int u = 0; u < 4; ++u) {
                     if (i0 + u * kThreads < total)
                       L[rk[u] * lst + t0 + tk[u]] = mask_logit(
                           __fmul_rn(dot[u], gm.scale), t0 + tk[u],
                           rk[u] % gm.sq, qo, len, gm.causal);
                   }
                 }
               });
  // exact softmax per row: max, exp, sum, divide (one warp per row),
  // while V's first tile is on its way
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* lr = L + r * lst;
    float mx = kNegBig;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, lr[t]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(lr[t] - mx);
      lr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < n; t += 32) lr[t] = round_to<T>(lr[t] / sum);
  }
  __syncthreads();
  // P.V: each thread keeps the kScratchAcc outputs base + tid + k *
  // kThreads in registers while V streams by (wider groups take more
  // passes over V), each summed over t in order.  When hd divides the
  // block a thread's outputs share column d, so one V load feeds all of
  // them; the weights come four tokens to a 16-byte load.
  const bool one_col = kThreads % hd == 0;
  int s0 = n_tiles & 1;
  for (int base = 0; base < rows * hd; base += kThreads * kScratchAcc) {
    int rk[kScratchAcc], dk[kScratchAcc];
    float acc[kScratchAcc];
#pragma unroll
    for (int k = 0; k < kScratchAcc; ++k) {
      const int o = base + threadIdx.x + k * kThreads;
      rk[k] = o / hd;
      dk[k] = o - rk[k] * hd;
      acc[k] = 0.0f;
    }
    const bool more = base + kThreads * kScratchAcc < rows * hd;
    scratch_ring(vp, more ? vp : nullptr, pages, h, gm, n, tt, ring, s0,
                 [&](const T* Vs, int t0, int cnt) {
      // V[t][d] of this tile
      auto vat = [&](int t, int d) {
        return to_f(Vs[swz<T>(t, d / kVec, hd, mask) + d % kVec]);
      };
      int t = 0;
      for (; t + 4 <= cnt; t += 4) {
        float v[4];
        if (one_col) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = vat(t + e, dk[0]);
        }
#pragma unroll
        for (int k = 0; k < kScratchAcc; ++k) {
          if (rk[k] < rows) {
            if (!one_col) {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] = vat(t + e, dk[k]);
            }
            const float4 w =
                *reinterpret_cast<const float4*>(L + rk[k] * lst + t0 + t);
            acc[k] = fmaf(w.x, v[0], acc[k]);
            acc[k] = fmaf(w.y, v[1], acc[k]);
            acc[k] = fmaf(w.z, v[2], acc[k]);
            acc[k] = fmaf(w.w, v[3], acc[k]);
          }
        }
      }
      for (; t < cnt; ++t) {
#pragma unroll
        for (int k = 0; k < kScratchAcc; ++k) {
          if (rk[k] < rows)
            acc[k] = fmaf(L[rk[k] * lst + t0 + t], vat(t, dk[k]), acc[k]);
        }
      }
    });
    s0 = (s0 + n_tiles) & 1;
#pragma unroll
    for (int k = 0; k < kScratchAcc; ++k) {
      if (rk[k] < rows) store_out(out, b, h, gm, rk[k], dk[k], acc[k]);
    }
  }
  cp_async_wait<0>();
}

// -- scratch lane, bf16: tensor cores, the window split over a cluster -------

constexpr int kMmaMaxStages = 4;
constexpr int kPvItems = 8;          // 16 x 16 output tiles a warp keeps
constexpr int kSmemLimit = 232448;   // dynamic shared memory per block

// head dim rounded up to the mma's 16 (the extra columns are zero)
__host__ __device__ inline int scratch_hdp(int hd) { return (hd + 15) & ~15; }
// rows of Q kept: 8 (the upper half of the m16 tile reads them again) or
// whole m16 tiles
__host__ __device__ inline int scratch_qrows(int rows) {
  return rows <= 8 ? 8 : (rows + 15) & ~15;
}
// logit row stride for n tokens: at least n rounded up to 16 (P.V reads
// whole k16 steps, zero past n), and 8 mod 16, so that the 8-byte P
// fragment loads of a half-warp (rows gr = 0..3) fall on distinct banks
__host__ __device__ inline int scratch_lst(int n) {
  return ((n + 15) & ~15) + 8;
}
// tokens of a row's n that each CTA of a cs-CTA cluster takes: whole
// 64-token tiles, the last CTAs possibly fewer or none
__host__ __device__ inline int scratch_share(int n, int cs) {
  return cs == 1 ? n : ((n + cs - 1) / cs + kTileTokens - 1) / kTileTokens *
                           kTileTokens;
}
// CTAs per (row, KV head): windows of 4096 tokens and more are split
// eight ways, of 2048 four ways, of 512 two ways, so that the long rows'
// blocks do not serialise (measured on the H100 at B 4 x kv 16: PERF.md);
// halved while the grid of `blocks` (B x kv) clusters would pass four
// CTAs per SM, where the batch already fills the card
inline int scratch_cluster(int depth, int blocks, int sms) {
  int cs = depth >= 4096 ? 8 : depth >= 2048 ? 4 : depth >= 512 ? 2 : 1;
  while (cs > 1 && static_cast<long long>(blocks) * cs > 4LL * sms) cs /= 2;
  return cs;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// layout: ring | Qs | L | row max and sum (cs > 1) | P.V partials (cs > 1)
// | the CTA's page-table entries
struct ScratchLayout {
  size_t ring, qs, l, red, part, pages, total;
};
__host__ __device__ inline ScratchLayout scratch_layout(int rows, int hd,
                                                        int depth, int ps,
                                                        int stages, int cs) {
  const size_t hdp = scratch_hdp(hd);
  const int share = scratch_share(depth, cs);
  ScratchLayout o;
  o.ring = 0;
  o.qs = o.ring + static_cast<size_t>(stages) * kTileTokens * hdp * 2;
  o.l = o.qs + static_cast<size_t>(scratch_qrows(rows)) * hdp * 2;
  o.red = o.l + static_cast<size_t>(rows) * scratch_lst(share) * 4;
  o.part = o.red + (cs > 1 ? static_cast<size_t>(2 * rows) * 4 : 0);
  o.pages = o.part + (cs > 1 ? static_cast<size_t>(rows) * hdp * 4 : 0);
  o.total = o.pages + static_cast<size_t>((share + ps - 1) / ps + 1) * 4;
  return o;
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

__device__ __forceinline__ uint32_t bf16x2_of(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The bf16 scratch lane.  The same function as paged_scratch_kernel: the
// f32 logits of the whole window resident in shared memory, an exact
// softmax per row (max, exp, sum, divide), the weights rounded to bf16,
// then P.V.  Both products run on the tensor cores
// (mma.sync.m16n8k16 bf16 -> f32): bf16 products are exact in f32, so
// only the order of the f32 sums differs from the CUDA-core lane.
//   * Q.K^T: Q (rows padded to the m16 tile) and K tiles by ldmatrix from
//     swizzled shared memory; each warp scores 16 tokens of a 64-token
//     tile; the logits are scaled (__fmul_rn), masked and stored in L;
//   * P.V: P from L (already rounded to bf16, so one mma), V by
//     ldmatrix.trans; a warp keeps up to kPvItems 16 x 16 output tiles in
//     registers while V streams by once (more items take more passes);
//   * K tiles, then V tiles, flow through one cp.async ring of `stages`
//     64-token tiles (up to 4 for one CTA, 3 in a cluster, fewer where the
//     logits leave no room), so V's first tiles land while the softmax
//     runs;
//   * a long window is split over a cluster of cs CTAs (gridDim.z), each
//     scoring a share of the tokens into its own L.  The softmax stays
//     exact over the whole window: each row's max, then its sum of exp,
//     are combined across the cluster through distributed shared memory
//     (the sums in rank order), and the CTAs' P.V partials are summed in
//     rank order before the one rounding to bf16.
__global__ void __launch_bounds__(kThreads) paged_scratch_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    __nv_bfloat16* __restrict__ out, Geom gm, int stages) {
  using T = __nv_bfloat16;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int cs = gridDim.z;           // the cluster spans blockIdx.z
  const int rank = blockIdx.z;
  const int g = gm.hq / gm.kv;
  const int rows = g * gm.sq;
  const int hd = gm.hd;
  const int hdp = scratch_hdp(hd);
  const int cpr = hdp / 8;
  const int mask = swz_mask(cpr);
  const int depth = gm.p_seq * gm.ps;
  const int len = kv_len[b];
  const int qo = q_off[b];
  const int n = tokens_needed(len, depth);
  const int share = scratch_share(n, cs);
  const int tb0 = min(n, rank * share);       // this CTA's tokens [tb0, te0)
  const int te0 = min(n, tb0 + share);
  const int m = te0 - tb0;
  const int lst = scratch_lst(m);
  const int qrows = scratch_qrows(rows);
  const int n_mt = (rows + 15) / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2;
  const int t4 = lane & 3;
  const int mat = lane >> 3;
  const ScratchLayout lay = scratch_layout(rows, hd, depth, gm.ps, stages,
                                           cs);
  const int stage = kTileTokens * hdp;
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  T* Qs = reinterpret_cast<T*>(smem + lay.qs);
  float* L = reinterpret_cast<float*>(smem + lay.l);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  int* pages = reinterpret_cast<int*>(smem + lay.pages);
  load_pages(pt + static_cast<size_t>(b) * gm.p_seq, tb0, te0, gm.ps, pages);
  for (int i = threadIdx.x; i < qrows * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && c * 8 < hd) {
      const int j = r / gm.sq;
      const int s = r - j * gm.sq;
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * gm.sq + s) * gm.hq + h * g + j) * hd +
          c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + swz<T>(r, c, hdp, mask)) = v;
  }
  if (cs > 1)  // a CTA with no tokens adds zero partials
    for (int i = threadIdx.x; i < rows * hdp; i += kThreads) part[i] = 0.0f;
  __syncthreads();  // the page entries, before the first issue

  const int n_tiles = (m + kTileTokens - 1) / kTileTokens;
  const int n16 = hdp / 16;
  const int items = n_mt * n16;
  const int per_pass = kWarps * kPvItems;
  const int passes = (items + per_pass - 1) / per_pass;
  const int total = n_tiles * (1 + passes);
  auto issue = [&](int it) {
    if (it < total) {
      const T* pool = it < n_tiles ? kp : vp;
      const int tile = it < n_tiles ? it : (it - n_tiles) % n_tiles;
      issue_tile<T>(pool, nullptr, pages, tb0, h, gm.ps, gm.kv, hdp,
                    tb0 + tile * kTileTokens, kTileTokens, te0,
                    ring + (it % stages) * stage, nullptr, hd);
    }
    cp_async_commit();
  };
  // every logit is in L: exact softmax per row (one warp per row), the max
  // and the sum over the whole window, weights rounded to bf16, zeros past
  // the CTA's tokens for P.V's last k16 step.  Every CTA of the cluster
  // runs it once.
  auto softmax = [&]() {
    if (cs == 1) {
      for (int r = warp; r < rows; r += kWarps) {
        float* lr = L + r * lst;
        float mx = kNegBig;
        for (int t = lane; t < m; t += 32) mx = fmaxf(mx, lr[t]);
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int t = lane; t < m; t += 32) {
          const float e = expf(lr[t] - mx);
          lr[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int t = lane; t < lst; t += 32)
          lr[t] = t < m ? round_to<T>(lr[t] / sum) : 0.0f;
      }
      return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    for (int r = warp; r < rows; r += kWarps) {  // this CTA's row max
      const float* lr = L + r * lst;
      float mx = -INFINITY;
      for (int t = lane; t < m; t += 32) mx = fmaxf(mx, lr[t]);
      mx = warp_max(mx);
      if (lane == 0) red[r] = mx;
    }
    cluster.sync();
    for (int r = warp; r < rows; r += kWarps) {  // exp, this CTA's sum
      float* lr = L + r * lst;
      float mx = -INFINITY;
      for (int k = 0; k < cs; ++k)
        mx = fmaxf(mx, *cluster.map_shared_rank(red + r, k));
      float sum = 0.0f;
      for (int t = lane; t < m; t += 32) {
        const float e = expf(lr[t] - mx);
        lr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) red[rows + r] = sum;
    }
    cluster.sync();
    for (int r = warp; r < rows; r += kWarps) {  // the window's sum, divide
      float* lr = L + r * lst;
      float sum = 0.0f;
      for (int k = 0; k < cs; ++k)  // rank order
        sum += *cluster.map_shared_rank(red + rows + r, k);
      for (int t = lane; t < lst; t += 32)
        lr[t] = t < m ? round_to<T>(lr[t] / sum) : 0.0f;
    }
  };
  for (int s = 0; s < stages - 1; ++s) issue(s);

  float acc[kPvItems][2][4];
  for (int it = 0; it < total; ++it) {
    issue(it + stages - 1);
    if (it == n_tiles) softmax();
    cp_async_wait_upto(stages - 1);
    __syncthreads();
    const T* st = ring + (it % stages) * stage;
    if (it < n_tiles) {
      // logits of this warp's 16 tokens against every row
      const int t0 = it * kTileTokens;      // within the CTA's share
      const int tw = warp * kWarpTokens;
      if (t0 + tw < m) {
        for (int mt = 0; mt < n_mt; ++mt) {
          float s[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
          int qrow = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          if (qrow >= qrows) qrow -= 8;
          const int krow = tw + (lane & 7) + (mat >> 1) * 8;
          for (int kc = 0; kc < cpr; kc += 2) {
            uint32_t a[4], bk[4];
            ldsm_x4(a, Qs + swz<T>(qrow, kc + (lane >> 4), hdp, mask));
            ldsm_x4(bk, st + swz<T>(krow, kc + (mat & 1), hdp, mask));
            mma_bf16(s[0], a, bk[0], bk[1]);
            mma_bf16(s[1], a, bk[2], bk[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = mt * 16 + gr + (e >> 1) * 8;
              const int t = t0 + tw + j * 8 + 2 * t4 + (e & 1);
              if (row < rows && t < m)
                L[row * lst + t] = mask_logit(__fmul_rn(s[j][e], gm.scale),
                                              tb0 + t, row % gm.sq, qo, len,
                                              gm.causal);
            }
        }
      }
    } else {
      const int vt = (it - n_tiles) % n_tiles;
      const int base = ((it - n_tiles) / n_tiles) * per_pass;
      if (vt == 0) {
#pragma unroll
        for (int i = 0; i < kPvItems; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      }
      const int t0 = vt * kTileTokens;
      const int cnt = min(kTileTokens, m - t0);
      for (int tok = 0; tok < cnt; tok += 16) {
        const int vrow = tok + (lane & 7) + (mat & 1) * 8;
#pragma unroll
        for (int i = 0; i < kPvItems; ++i) {
          const int idx = base + warp + kWarps * i;
          if (idx < items) {
            const int mt = idx / n16;
            const int nt = idx - mt * n16;
            const int r_lo = min(mt * 16 + gr, rows - 1);
            const int r_hi = min(mt * 16 + gr + 8, rows - 1);
            const float* p_lo = L + r_lo * lst + t0 + tok + 2 * t4;
            const float* p_hi = L + r_hi * lst + t0 + tok + 2 * t4;
            uint32_t a[4];
            a[0] = bf16x2_of(*reinterpret_cast<const float2*>(p_lo));
            a[1] = bf16x2_of(*reinterpret_cast<const float2*>(p_hi));
            a[2] = bf16x2_of(*reinterpret_cast<const float2*>(p_lo + 8));
            a[3] = bf16x2_of(*reinterpret_cast<const float2*>(p_hi + 8));
            uint32_t bv[4];
            ldsm_x4_t(bv, st + swz<T>(vrow, 2 * nt + (mat >> 1), hdp, mask));
            mma_bf16(acc[i][0], a, bv[0], bv[1]);
            mma_bf16(acc[i][1], a, bv[2], bv[3]);
          }
        }
      }
      if (vt == n_tiles - 1) {  // the pass's outputs (or partials)
#pragma unroll
        for (int i = 0; i < kPvItems; ++i) {
          const int idx = base + warp + kWarps * i;
          if (idx < items) {
            const int mt = idx / n16;
            const int nt = idx - mt * n16;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = mt * 16 + gr + (e >> 1) * 8;
                const int col = nt * 16 + j * 8 + 2 * t4 + (e & 1);
                if (row < rows && col < hd) {
                  if (cs > 1) part[row * hdp + col] = acc[i][j][e];
                  else store_out(out, b, h, gm, row, col, acc[i][j][e]);
                }
              }
          }
        }
      }
    }
    __syncthreads();  // the slot is refilled stages - 1 tiles later
  }
  if (n_tiles == 0) softmax();  // a CTA past the row's tokens
  cp_async_wait<0>();
  if (cs > 1) {
    // out = the CTAs' partials summed in rank order; CTA `rank` stores
    // every cs-th output
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int i = rank + cs * threadIdx.x; i < rows * hd; i += cs * kThreads) {
      const int row = i / hd;
      const int col = i - row * hd;
      float v = 0.0f;
      for (int k = 0; k < cs; ++k)
        v += *cluster.map_shared_rank(part + row * hdp + col, k);
      store_out(out, b, h, gm, row, col, v);
    }
    cluster.sync();  // the partials stay until every CTA has read them
  }
}

// -- streamed lane: per-warp math -------------------------------------------

// where a streamed tile sits: the rows of this block and the token range
// of this split
struct TileCtx {
  int r0, sq, qo, len, t_end, causal;
  float scale;
};

// per-warp merge area, laid over the ring once the split's tiles are done
struct WarpSums {
  float* m;    // [kWarps][kGroupRows]
  float* l;    // [kWarps][kGroupRows]
  float* acc;  // [kWarps][kGroupRows][hd]
};

template <typename T, int HD> struct WarpMath;

// bf16: tensor cores.  A thread holds the mma accumulator fragments of
// rows gr = lane / 4 and gr + 8: acc[n][0..1] at columns 8n + 2 (lane % 4)
// (+1) of row gr, acc[n][2..3] of row gr + 8.
template <int HD> struct WarpMath<__nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr int kMask = swz_mask(HD / 8);
  float acc[HD / 8][4];
  float m[2], l[2];

  __device__ void init() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    m[0] = m[1] = kNegBig;
    l[0] = l[1] = 0.0f;
  }

  // tokens [tw, tw + 16) of the tile (absolute position ta0 + 0..15)
  __device__ void tile(const T* Qs, const T* Ks, const T* Vs, int tw,
                       int ta0, const TileCtx& cx, float*, float*) {
    const int lane = threadIdx.x & 31;
    const int gr = lane >> 2;
    const int t4 = lane & 3;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4], bk[4];
      const int qrow = (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4(a, Qs + swz<T>(qrow, (kk >> 3) + (lane >> 4), HD, kMask));
      const int mat = lane >> 3;
      const int krow = tw + (lane & 7) + (mat >> 1) * 8;
      ldsm_x4(bk, Ks + swz<T>(krow, (kk >> 3) + (mat & 1), HD, kMask));
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gr + (e >> 1) * 8;
        const int ta = ta0 + j * 8 + 2 * t4 + (e & 1);
        const float v = mask_logit(__fmul_rn(s[j][e], cx.scale), ta,
                                   (cx.r0 + row) % cx.sq, cx.qo, cx.len,
                                   cx.causal);
        s[j][e] = ta < cx.t_end ? v : -INFINITY;
      }
    // online softmax for rows gr (hr = 0) and gr + 8 (hr = 1); a row's 16
    // logits sit in the four threads of a quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = fmaxf(fmaxf(s[0][2 * hr], s[0][2 * hr + 1]),
                       fmaxf(s[1][2 * hr], s[1][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = expf(m[hr] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          sum += s[j][e];
        }
      sum += __shfl_xor_sync(~0u, sum, 1);
      sum += __shfl_xor_sync(~0u, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * hr] *= alpha;
        acc[n][2 * hr + 1] *= alpha;
      }
    }
    // P as the A operand (16 rows x 16 tokens): the two accumulator tiles
    // are its two k halves; p = hi + lo, both bf16
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1;
      const int e = (i & 1) * 2;
      const __nv_bfloat16 h0 = __float2bfloat16_rn(s[j][e]);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(s[j][e + 1]);
      ph[i] = pack_bf16(h0, h1);
      pl[i] = pack_bf16(__float2bfloat16_rn(s[j][e] - __bfloat162float(h0)),
                        __float2bfloat16_rn(s[j][e + 1] -
                                            __bfloat162float(h1)));
    }
#pragma unroll
    for (int n0 = 0; n0 < HD; n0 += 16) {
      uint32_t bv[4];
      const int mat = lane >> 3;
      const int vrow = tw + (lane & 7) + (mat & 1) * 8;
      ldsm_x4_t(bv, Vs + swz<T>(vrow, (n0 >> 3) + (mat >> 1), HD, kMask));
      mma_bf16(acc[n0 / 8], ph, bv[0], bv[1]);
      mma_bf16(acc[n0 / 8], pl, bv[0], bv[1]);
      mma_bf16(acc[n0 / 8 + 1], ph, bv[2], bv[3]);
      mma_bf16(acc[n0 / 8 + 1], pl, bv[2], bv[3]);
    }
  }

  __device__ void save(const WarpSums& w, int warp) const {
    const int lane = threadIdx.x & 31;
    const int gr = lane >> 2;
    const int t4 = lane & 3;
    if (t4 == 0) {
      w.m[warp * kGroupRows + gr] = m[0];
      w.l[warp * kGroupRows + gr] = l[0];
      w.m[warp * kGroupRows + gr + 8] = m[1];
      w.l[warp * kGroupRows + gr + 8] = l[1];
    }
    float* a = w.acc + static_cast<size_t>(warp) * kGroupRows * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      a[gr * HD + col] = acc[n][0];
      a[gr * HD + col + 1] = acc[n][1];
      a[(gr + 8) * HD + col] = acc[n][2];
      a[(gr + 8) * HD + col + 1] = acc[n][3];
    }
  }
};

// float32: CUDA cores.  Lane = (token tk = lane % 16, row half rh =
// lane / 16); a lane scores rows rh + 2i (i < 8) against its token, then
// owns output columns lane + 32c for every row in P.V.
template <int HD> struct WarpMath<float, HD> {
  using T = float;
  static constexpr int kMask = swz_mask(HD / 4);
  static constexpr int kCols = (HD + 31) / 32;
  float acc[kGroupRows][kCols];
  float m[8], l[8];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = kNegBig;
      l[i] = 0.0f;
    }
  }

  // Pw: this warp's [16 rows][16 tokens] weights; Aw: its 16 rescales
  __device__ void tile(const T* Qs, const T* Ks, const T* Vs, int tw,
                       int ta0, const TileCtx& cx, float* Pw, float* Aw) {
    const int lane = threadIdx.x & 31;
    const int tk = lane & 15;
    const int rh = lane >> 4;
    const int ta = ta0 + tk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = rh + 2 * i;
      float dot = 0.0f;
#pragma unroll 8
      for (int c = 0; c < HD / 4; ++c) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + swz<T>(rr, c, HD, kMask));
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + swz<T>(tw + tk, c, HD, kMask));
        dot = fmaf(qv.x, kv.x, dot);
        dot = fmaf(qv.y, kv.y, dot);
        dot = fmaf(qv.z, kv.z, dot);
        dot = fmaf(qv.w, kv.w, dot);
      }
      float v = mask_logit(__fmul_rn(dot, cx.scale), ta,
                           (cx.r0 + rr) % cx.sq, cx.qo, cx.len, cx.causal);
      v = ta < cx.t_end ? v : -INFINITY;
      float mx = v;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p = expf(v - m_new);
      float sum = p;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(~0u, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      Pw[rr * kWarpTokens + tk] = p;
      if (tk == 0) Aw[rr] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
#pragma unroll
        for (int rr = 0; rr < kGroupRows; ++rr) {
          float a = acc[rr][c] * Aw[rr];
#pragma unroll
          for (int t = 0; t < kWarpTokens; ++t)
            a = fmaf(Pw[rr * kWarpTokens + t],
                     Vs[swz<T>(tw + t, d / 4, HD, kMask) + d % 4], a);
          acc[rr][c] = a;
        }
      }
    }
    __syncwarp();  // Pw / Aw are rewritten by the next tile
  }

  __device__ void save(const WarpSums& w, int warp) const {
    const int lane = threadIdx.x & 31;
    const int tk = lane & 15;
    const int rh = lane >> 4;
    if (tk == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        w.m[warp * kGroupRows + rh + 2 * i] = m[i];
        w.l[warp * kGroupRows + rh + 2 * i] = l[i];
      }
    }
    float* a = w.acc + static_cast<size_t>(warp) * kGroupRows * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
#pragma unroll
        for (int rr = 0; rr < kGroupRows; ++rr) a[rr * HD + d] = acc[rr][c];
      }
    }
  }
};

// split_pages: the most page-table entries one split reads
size_t streamed_smem(int hd, int elem_bytes, int split_pages) {
  size_t s = static_cast<size_t>(ring_stages(hd, elem_bytes)) * 2 *
                 kTileTokens * hd * elem_bytes +
             static_cast<size_t>(kGroupRows) * hd * elem_bytes +
             static_cast<size_t>(split_pages) * 4;
  if (elem_bytes == 4) s += (kWarps * kGroupRows * (kWarpTokens + 1)) * 4;
  return s;
}

// -- streamed lane: split and combine kernels -------------------------------

// part_ml[(((b * kv + h) * n_split + split) * R + r) * 2 + {0, 1}] = m, l;
// part_acc[... * hd + d] = the unnormalised f32 accumulator; R = g * sq.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    float* __restrict__ part_ml, float* __restrict__ part_acc, Geom gm,
    int n_blocks, int block_tokens, int n_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStages = ring_stages(HD, sizeof(T));
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCpr = HD / kVec;
  constexpr int kMask = swz_mask(kCpr);
  constexpr int kStage = 2 * kTileTokens * HD;  // K tile then V tile
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z % n_split;
  const int r0 = (blockIdx.z / n_split) * kGroupRows;
  const int g = gm.hq / gm.kv;
  const int R = g * gm.sq;
  const int rows_here = min(kGroupRows, R - r0);
  const int len = kv_len[b];
  const int n = tokens_needed(len, gm.p_seq * gm.ps);
  const int t_begin = (split * n_blocks / n_split) * block_tokens;
  const int t_end = min(((split + 1) * n_blocks / n_split) * block_tokens, n);
  const size_t pbase =
      (static_cast<size_t>(b * gm.kv + h) * n_split + split) * R + r0;
  if (t_begin >= n) {  // wholly past the valid depth: the sentinel partial
    for (int i = threadIdx.x; i < rows_here * gm.hd; i += kThreads) {
      part_acc[pbase * gm.hd + i] = 0.0f;
      if (i % gm.hd == 0) {
        part_ml[(pbase + i / gm.hd) * 2] = kNegBig;
        part_ml[(pbase + i / gm.hd) * 2 + 1] = 0.0f;
      }
    }
    return;
  }
  // layout: ring (kStages x [K tile | V tile]) | Qs [16][HD] | Pw | Aw
  // (float32) | the split's page-table entries
  T* ring = reinterpret_cast<T*>(smem);
  T* Qs = ring + kStages * kStage;
  float* Pw = reinterpret_cast<float*>(Qs + kGroupRows * HD);
  float* Aw = Pw + kWarps * kGroupRows * kWarpTokens;
  int* pages = reinterpret_cast<int*>(
      Pw + (sizeof(T) == 4 ? kWarps * kGroupRows * (kWarpTokens + 1) : 0));
  load_pages(pt + static_cast<size_t>(b) * gm.p_seq, t_begin, t_end, gm.ps,
             pages);
  const int warp = threadIdx.x / 32;
  const int hd = gm.hd;  // the pools' head dim, <= HD; columns past it are 0
  // Q rows r0 .. r0 + 15 of the group (zero past R)
  for (int i = threadIdx.x; i < kGroupRows * kCpr; i += kThreads) {
    const int rr = i / kCpr;
    const int c = i - rr * kCpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + rr < R && c * kVec < hd) {
      const int j = (r0 + rr) / gm.sq;
      const int s = (r0 + rr) % gm.sq;
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * gm.sq + s) * gm.hq + h * g + j) *
                  hd + c * kVec);
    }
    *reinterpret_cast<uint4*>(Qs + swz<T>(rr, c, HD, kMask)) = v;
  }
  __syncthreads();  // the page entries, before the first issue
  const int n_tiles = (t_end - t_begin + kTileTokens - 1) / kTileTokens;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      T* st = ring + (it % kStages) * kStage;
      const int t0 = t_begin + it * kTileTokens;
      issue_tile(kp, vp, pages, t_begin, h, gm.ps, gm.kv, HD, t0,
                 kTileTokens, t_end, st, st + kTileTokens * HD, hd);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const TileCtx cx{r0, gm.sq, q_off[b], len, t_end, gm.causal, gm.scale};
  WarpMath<T, HD> wm;
  wm.init();
  for (int it = 0; it < n_tiles; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* st = ring + (it % kStages) * kStage;
    const int ta0 = t_begin + it * kTileTokens + warp * kWarpTokens;
    // a warp whose tokens all lie past t_end would leave its sums as
    // they are (p = 0, alpha = 1): skip it
    if (ta0 < t_end)
      wm.tile(Qs, st, st + kTileTokens * HD, warp * kWarpTokens, ta0, cx,
              Pw + warp * kGroupRows * kWarpTokens, Aw + warp * kGroupRows);
    __syncthreads();  // the slot is refilled kStages - 1 tiles later
  }
  cp_async_wait<0>();
  // merge the four warps' (m, l, acc) over the drained ring
  float* wbuf = reinterpret_cast<float*>(smem);
  const WarpSums ws{wbuf, wbuf + kWarps * kGroupRows,
                    wbuf + 2 * kWarps * kGroupRows};
  wm.save(ws, warp);
  __syncthreads();
  for (int i = threadIdx.x; i < rows_here * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ws.m[w * kGroupRows + r]);
    float a = 0.0f, l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = expf(ws.m[w * kGroupRows + r] - mx);
      a += sc * ws.acc[(w * kGroupRows + r) * HD + d];
      l += sc * ws.l[w * kGroupRows + r];
    }
    part_acc[pbase * hd + i] = a;
    if (d == 0) {
      part_ml[(pbase + r) * 2] = mx;
      part_ml[(pbase + r) * 2 + 1] = l;
    }
  }
}

// out = sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s, M = max_s m_s
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, Geom gm, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / gm.kv;
  const int h = bh - b * gm.kv;
  const int R = (gm.hq / gm.kv) * gm.sq;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= R * gm.hd) return;
  const int r = i / gm.hd;
  const size_t base = static_cast<size_t>(bh) * n_split * R + r;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_ml[(base + static_cast<size_t>(s) * R) * 2]);
  float a = 0.0f, l = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const size_t p = base + static_cast<size_t>(s) * R;
    const float sc = expf(part_ml[p * 2] - mx);
    l += sc * part_ml[p * 2 + 1];
    a += sc * part_acc[p * gm.hd + (i - r * gm.hd)];
  }
  store_out(out, b, h, gm, r, i - r * gm.hd, a / l);
}


struct SplitArgs {
  const void *q, *kp, *vp, *pt, *kv_len, *q_off;
  float *part_ml, *part_acc;
  Geom gm;
  int B, n_blocks, block_tokens, n_split, groups, split_pages;
  cudaStream_t st;
};

template <typename T, int HD>
cudaError_t launch_split(const SplitArgs& a) {
  const size_t smem = streamed_smem(HD, sizeof(T), a.split_pages);
  static smem::SmemGrant grant;
  cudaError_t err = grant.allow(paged_split_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.gm.kv, a.n_split * a.groups);
  paged_split_kernel<T, HD><<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.kv_len),
      static_cast<const int32_t*>(a.q_off), a.part_ml, a.part_acc, a.gm,
      a.n_blocks, a.block_tokens, a.n_split);
  return cudaGetLastError();
}

// the compiled widths of the split kernel; a head dim runs on the next
// width up, its extra columns zero in shared memory
inline int streamed_width(int hd) {
  static const int widths[] = {16, 32, 64, 80, 96, 128, 192, 256};
  for (int w : widths)
    if (hd <= w) return w;
  return 0;
}

template <typename T> cudaError_t split_by_hd(const SplitArgs& a) {
  if (a.gm.hd <= 0 || (a.gm.hd * static_cast<int>(sizeof(T))) % 16 != 0)
    return cudaErrorInvalidValue;
  switch (streamed_width(a.gm.hd)) {
    case 16: return launch_split<T, 16>(a);
    case 32: return launch_split<T, 32>(a);
    case 64: return launch_split<T, 64>(a);
    case 80: return launch_split<T, 80>(a);
    case 96: return launch_split<T, 96>(a);
    case 128: return launch_split<T, 128>(a);
    case 192: return launch_split<T, 192>(a);
    case 256: return launch_split<T, 256>(a);
    default: break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes each lane needs per block (the wrapper checks them
// against the card's per-block limit before launching).  depth is the
// table's token depth P_seq * ps.  At bf16 this is the least the lane
// takes (a two-stage ring); the launch deepens the ring where room is left.
size_t paged_scratch_smem(int sq, int hq, int kv, int hd, int depth,
                          int ps, int elem_bytes) {
  const size_t rows = static_cast<size_t>(hq / kv) * sq;
  if (elem_bytes == 2)  // one CTA, a two-stage ring: what the lane holds
    return scratch_layout(static_cast<int>(rows), hd, depth, ps, 2, 1).total;
  return 2 * static_cast<size_t>(scratch_tile(hd, elem_bytes)) * hd *
             elem_bytes +
         rows * (hd + 4) * 4 + rows * ((depth + 3) & ~3) * 4 +
         static_cast<size_t>((depth + ps - 1) / ps) * 4;
}

// split_pages: ceil(blocks / n_split) * block_pages; hd is the pools'
// head dim (0 when no compiled width holds it)
size_t paged_streamed_smem(int hd, int elem_bytes, int split_pages) {
  const int w = streamed_width(hd);
  return w == 0 ? 0 : streamed_smem(w, elem_bytes, split_pages);
}

// scale is hd^-0.5 rounded to f32 by the caller; dtype: 0 = float32,
// 1 = bfloat16.  Each returns a cudaError_t (0 = launched).
int paged_scratch_launch(const void* q, const void* kp, const void* vp,
                         const void* pt, const void* kv_len,
                         const void* q_off, void* out, int B, int sq, int hq,
                         int kv, int hd, int ps, int p_seq, int causal,
                         float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || kv <= 0 || hq % kv != 0 || (dtype != 0 && dtype != 1) ||
      hd <= 0 || (hd * (dtype == 0 ? 4 : 2)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom gm{sq, hq, kv, hd, ps, p_seq, causal, scale};
  const dim3 grid(B, kv);
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const int rows = hq / kv * sq;
    const int depth = p_seq * ps;
    const int cs = scratch_cluster(depth, B * kv, sm_count());
    // a split window has parallelism enough: a three-stage ring keeps more
    // of the cluster's CTAs resident at once
    int stages = cs > 1 ? 3 : kMmaMaxStages;
    while (stages > 2 && scratch_layout(rows, hd, depth, ps, stages, cs).total >
                             static_cast<size_t>(kSmemLimit))
      --stages;
    const size_t smem = scratch_layout(rows, hd, depth, ps, stages, cs).total;
    static smem::SmemGrant mma_grant;
    err = mma_grant.allow(paged_scratch_mma_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B, kv, cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = cs;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, paged_scratch_mma_kernel, static_cast<const T*>(q),
        static_cast<const T*>(kp), static_cast<const T*>(vp),
        static_cast<const int32_t*>(pt), static_cast<const int32_t*>(kv_len),
        static_cast<const int32_t*>(q_off), static_cast<T*>(out), gm, stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = paged_scratch_smem(sq, hq, kv, hd, p_seq * ps, ps, 4);
  static smem::SmemGrant grant;
  err = grant.allow(paged_scratch_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_scratch_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(kv_len),
      static_cast<const int32_t*>(q_off), static_cast<float*>(out), gm);
  return static_cast<int>(cudaGetLastError());
}

// The split kernel: partials of n_split contiguous runs of whole blocks of
// block_pages pages into part_ml (B, kv, n_split, g * sq, 2) and part_acc
// (B, kv, n_split, g * sq, hd), float32.  hd is a whole number of 16-byte
// chunks, at most 256; it runs on the next compiled width up (16, 32, 64,
// 80, 96, 128, 192, 256); p_seq % block_pages == 0; 1 <= n_split <= the
// number of blocks.
int paged_split_launch(const void* q, const void* kp, const void* vp,
                       const void* pt, const void* kv_len, const void* q_off,
                       void* part_ml, void* part_acc, int B, int sq, int hq,
                       int kv, int hd, int ps, int p_seq, int causal,
                       float scale, int dtype, int block_pages, int n_split,
                       void* stream) {
  if (B <= 0 || kv <= 0 || sq <= 0 || hq % kv != 0 || block_pages <= 0 ||
      p_seq % block_pages != 0 || n_split < 1 ||
      n_split > p_seq / block_pages || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = (hq / kv) * sq;
  const int n_blocks = p_seq / block_pages;
  const SplitArgs a{q, kp, vp, pt, kv_len, q_off,
                    static_cast<float*>(part_ml),
                    static_cast<float*>(part_acc),
                    Geom{sq, hq, kv, hd, ps, p_seq, causal, scale}, B,
                    n_blocks, block_pages * ps, n_split,
                    (rows + kGroupRows - 1) / kGroupRows,
                    (n_blocks + n_split - 1) / n_split * block_pages,
                    static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      dtype == 0 ? split_by_hd<float>(a) : split_by_hd<__nv_bfloat16>(a);
  return static_cast<int>(err);
}

// The combine kernel: out (B, sq, hq, hd) in q's type from the partials.
int paged_combine_launch(const void* part_ml, const void* part_acc, void* out,
                         int B, int sq, int hq, int kv, int hd, int dtype,
                         int n_split, void* stream) {
  if (B <= 0 || kv <= 0 || hq % kv != 0 || n_split < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom gm{sq, hq, kv, hd, 0, 0, 0, 0.0f};
  const int per_bh = (hq / kv) * sq * hd;
  const dim3 grid(B * kv, (per_bh + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ml = static_cast<const float*>(part_ml);
  const float* acc = static_cast<const float*>(part_acc);
  if (dtype == 0) {
    paged_combine_kernel<float><<<grid, kThreads, 0, st>>>(
        ml, acc, static_cast<float*>(out), gm, n_split);
  } else {
    paged_combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        ml, acc, static_cast<__nv_bfloat16*>(out), gm, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
