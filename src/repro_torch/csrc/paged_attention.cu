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
// divides, rounds the weights to T and accumulates P.V in f32 (at float32
// eight fixed subsets of t, each in order, then the subsets and the
// cluster's partials added in a fixed order; in the tensor cores' order at
// bf16) before rounding to T.  The streamed lane keeps a running max m,
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
// ring of token tiles.  A window of 512 tokens or more is split over a
// cluster of 2 to 8 CTAs (fewer where B x kv fills the card), each
// scoring its share of the tokens into its own logits; each row's max
// and sum meet in distributed shared memory, so the softmax stays exact
// over the window (max, exp, sum, divide), and the CTAs' P.V partials are
// added in rank order.  So a cluster holds windows up to about 8 x (227 KB
// - Q - ring) / (4 * g * sq) tokens.  At bf16 (`paged_scratch_mma_kernel`)
// both products run on the tensor cores (mma.sync m16n8k16, P from the
// rounded logits, V by ldmatrix.trans, the P.V sums in registers across
// tiles) over 64-token tiles.  At float32 (`paged_scratch_kernel`) both
// run as fmaf on the CUDA cores (TF32 would break the float32 contract)
// over 16 KB tiles, the reused operand in registers: a lane holds two Q
// chunks of 8 rows, so each K chunk it loads feeds 32 fmaf (a half-warp's
// partial dots meet in a shuffle butterfly), and 8 rows x 8 columns of
// P.V sums, so each V chunk feeds 32 fmaf and each weight 8.
// Both take any head dim of whole 16-byte chunks; the streamed lane is
// compiled for widths 16, 32, 64, 80, 96, 128, 192 and 256 and runs any
// head dim up to 256 on the next width up, the extra columns zero in
// shared memory.
//
// Past the on-chip layout's capacity (the window's f32 logits no longer
// fit beside the ring and Q), each scratch kernel keeps the logits in a
// global workspace the wrapper allocates, one region per (row, KV head,
// cluster rank), and reads the row's page table from device memory;
// ring, Q and the cluster's row sums stay on chip, and the softmax is the
// same exact max, exp, sum and divide over the whole window (at float32
// each V tile's weights are divided and staged in shared memory once per
// pass).  The lane never reroutes to the streamed lane.
//
// fp8 K/V (float8_e4m3fn pages, q in float32 or bf16): every kernel
// copies the e4m3 tiles (16 values per 16-byte cp.async) into a staging
// ring of half the bytes, then widens each landed tile once in shared
// memory into the q-type tile its math already reads; products, sums and
// their order are those of the same lane at q's type.  An e4m3 value is
// exact in bf16 and in f32, so each lane at fp8 equals the same lane on
// the pages upcast to q's type bit for bit.  The reference upcasts K/V to
// q's type inside the dot and never rounds q to fp8, so fp8 tensor-core
// instructions (which take both operands in fp8) do not apply.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: expf and the divides are exact).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

// -- fp8 (e4m3) K/V ------------------------------------------------------------

// K/V element type of the pools: the q type T, or e4m3 bytes
using Fp8 = uint8_t;

// two e4m3 values (the low byte first) as floats, exactly
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}
// 16 bytes of T values from 16 / sizeof(T) floats (exact: e4m3 values)
__device__ __forceinline__ uint4 pack_chunk(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack_chunk(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack_bf16(__float2bfloat16_rn(f[2 * i]),
                     __float2bfloat16_rn(f[2 * i + 1]));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Widen a landed tile of `tt` token rows x `hd` e4m3 values (16-byte
// chunks at swz<Fp8>, as issue_tile<Fp8> wrote them) into the T tile the
// math reads (chunks at swz<T>).  Rows issue_tile zero-filled widen to
// zeros.  hd is a multiple of 16.
template <typename T>
__device__ __forceinline__ void widen_tile(const Fp8* src, T* dst, int tt,
                                           int hd) {
  constexpr int kVec = 16 / sizeof(T);   // T values per 16-byte chunk
  const int cpr8 = hd / 16;
  const int mask8 = swz_mask(cpr8);
  const int mask = swz_mask(hd / kVec);
  for (int i = threadIdx.x; i < tt * cpr8; i += kThreads) {
    const int t = i / cpr8;
    const int c = i - t * cpr8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + swz<Fp8>(t, c, hd, mask8));
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 lo = e4m3x2_to_float2(words[j]);
      const float2 hi = e4m3x2_to_float2(words[j] >> 16);
      f[4 * j] = lo.x;
      f[4 * j + 1] = lo.y;
      f[4 * j + 2] = hi.x;
      f[4 * j + 3] = hi.y;
    }
    // values 16 c .. 16 c + 15 are T chunks 16 c / kVec ..
#pragma unroll
    for (int k = 0; k < 16 / kVec; ++k)
      *reinterpret_cast<uint4*>(dst + swz<T>(t, 16 * c / kVec + k, hd,
                                             mask)) =
          pack_chunk(f + k * kVec, T());
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

// tokens per scratch tile of the float32 lane (16 KB of f32): a multiple
// of 4 (a warp takes tokens two at a time), at most 64
__host__ __device__ inline int scratch_tile(int hd, int elem_bytes) {
  const int t = (kScratchTileBytes / (hd * elem_bytes)) & ~3;
  return t < 64 ? (t > 4 ? t : 4) : 64;
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

// layout: ring (kv_bytes per element) | the widened bf16 tile (e4m3
// pools) | Qs | on chip: L | row max and sum (cs > 1) | P.V partials
// (cs > 1) | on chip: the CTA's page-table entries.  With global_l the
// logits and the page table stay in device memory.
struct ScratchLayout {
  size_t ring, wide, qs, l, red, part, pages, total;
};
__host__ __device__ inline ScratchLayout scratch_layout(
    int rows, int hd, int depth, int ps, int stages, int cs,
    int kv_bytes = 2, bool global_l = false) {
  const size_t hdp = scratch_hdp(hd);
  const int share = scratch_share(depth, cs);
  ScratchLayout o;
  o.ring = 0;
  o.wide = o.ring + static_cast<size_t>(stages) * kTileTokens * hdp *
                        kv_bytes;
  o.qs = o.wide + (kv_bytes != 2 ? kTileTokens * hdp * 2 : 0);
  o.l = o.qs + static_cast<size_t>(scratch_qrows(rows)) * hdp * 2;
  o.red = o.l + (global_l ? 0
                          : static_cast<size_t>(rows) * scratch_lst(share) *
                                4);
  o.part = o.red + (cs > 1 ? static_cast<size_t>(2 * rows) * 4 : 0);
  o.pages = o.part + (cs > 1 ? static_cast<size_t>(rows) * hdp * 4 : 0);
  o.total = o.pages + (global_l ? 0
                                : static_cast<size_t>((share + ps - 1) / ps +
                                                      1) * 4);
  return o;
}
// floats of the global logits workspace of one (row, KV head, rank)
__host__ __device__ inline size_t scratch_global_l(int rows, int depth,
                                                   int cs) {
  return static_cast<size_t>(rows) * scratch_lst(scratch_share(depth, cs));
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
//   * KV = Fp8: e4m3 tiles land in a ring of half the bytes and are
//     widened into one bf16 tile before the math; kGlobalL: the logits
//     live in the workspace `logits` (scratch_global_l floats per CTA)
//     and the page table in device memory, past the on-chip capacity.
template <typename KV, bool kGlobalL>
__global__ void __launch_bounds__(kThreads) paged_scratch_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    __nv_bfloat16* __restrict__ out, float* __restrict__ logits, Geom gm,
    int stages) {
  using T = __nv_bfloat16;
  constexpr bool kWiden = sizeof(KV) != sizeof(T);
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
                                           cs, sizeof(KV), kGlobalL);
  const int stage = kTileTokens * hdp;
  KV* ring = reinterpret_cast<KV*>(smem + lay.ring);
  T* wide = reinterpret_cast<T*>(smem + lay.wide);
  T* Qs = reinterpret_cast<T*>(smem + lay.qs);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* L;
  const int* pages;
  if constexpr (kGlobalL) {
    L = logits + ((static_cast<size_t>(b) * gm.kv + h) * cs + rank) *
                     scratch_global_l(rows, depth, cs);
    pages = pt + static_cast<size_t>(b) * gm.p_seq + tb0 / gm.ps;
  } else {
    L = reinterpret_cast<float*>(smem + lay.l);
    int* cta_pages = reinterpret_cast<int*>(smem + lay.pages);
    load_pages(pt + static_cast<size_t>(b) * gm.p_seq, tb0, te0, gm.ps,
               cta_pages);
    pages = cta_pages;
  }
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
      const KV* pool = it < n_tiles ? kp : vp;
      const int tile = it < n_tiles ? it : (it - n_tiles) % n_tiles;
      issue_tile<KV>(pool, nullptr, pages, tb0, h, gm.ps, gm.kv, hdp,
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
    const T* st;
    if constexpr (kWiden) {
      widen_tile<T>(ring + (it % stages) * stage, wide, kTileTokens, hdp);
      __syncthreads();
      st = wide;
    } else {
      st = ring + (it % stages) * stage;
    }
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

// -- scratch lane, float32: CUDA cores, the window split over a cluster ------

constexpr int kRowTile = 8;   // rows a thread keeps: a token's logits (Q.K),
                              // a column's sums (P.V)
constexpr int kDBlock = 32;   // 16-byte chunks a half-warp spans, two a lane
constexpr int kQLoads = 4;    // 16-byte Q loads a thread keeps in flight
// ring stages: a deeper ring measured no faster (the tiles had landed
// when waited for) and keeps fewer CTAs on an SM
constexpr int kF32Stages = 2;

// f32 logit row stride for m tokens: whole tiles of tt tokens (P.V reads a
// tile's weights, zero past m), plus 4, so that the kRowTile rows of one
// token fall on distinct banks (rows stay 16-byte aligned)
__host__ __device__ inline int scratch_f32_lst(int m, int tt) {
  return (m + tt - 1) / tt * tt + 4;
}

// layout: ring (stages tiles of K/V elements) | the widened f32 tile
// (e4m3 pools) | Qs (rows x hd), later the P.V partials (Q is read only
// before the first V tile, the partials written only after) | on chip: L
// (rows x lst) | row max, sum and the window's sum | global: the staged
// weights of a tile (kRowTile x tt) | on chip: the CTA's page-table
// entries.  With global_l the logits and the page table stay in device
// memory.
struct F32Layout {
  size_t ring, wide, qs, l, red, pw, pages, total;
};
__host__ __device__ inline F32Layout scratch_f32_layout(
    int rows, int hd, int depth, int ps, int stages, int cs, int kv_bytes,
    bool global_l) {
  const size_t tt = scratch_tile(hd, 4);
  const int share = scratch_share(depth, cs);
  F32Layout o;
  o.ring = 0;
  o.wide = o.ring + static_cast<size_t>(stages) * tt * hd * kv_bytes;
  o.qs = o.wide + (kv_bytes != 4 ? tt * hd * 4 : 0);
  o.l = o.qs + static_cast<size_t>(rows) * hd * 4;
  o.red = o.l + (global_l ? 0
                          : static_cast<size_t>(rows) *
                                scratch_f32_lst(share, static_cast<int>(tt)) *
                                4);
  o.pw = o.red + static_cast<size_t>((3 * rows + 3) & ~3) * 4;
  o.pages = o.pw + (global_l ? kRowTile * tt * 4 : 0);
  o.total = o.pages + (global_l ? 0
                                : static_cast<size_t>((share + ps - 1) / ps +
                                                      1) * 4);
  return o;
}

// floats of the global logits workspace of one (row, KV head, rank)
__host__ __device__ inline size_t scratch_f32_global_l(int rows, int hd,
                                                       int depth, int cs) {
  return static_cast<size_t>(rows) *
         scratch_f32_lst(scratch_share(depth, cs), scratch_tile(hd, 4));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The sums over the 16 lanes of each half-warp of p[0..7] (the half's
// partial dots of 8 rows): lane l ends with row (l >> 1) & 7's, in a fixed
// butterfly (the lanes differing in bit 3, then 2, 1 and 0), so every
// call sums in the same order
__device__ __forceinline__ float half_warp_rows8(const float (&p)[kRowTile],
                                                 int lane) {
  const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float v4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float give = b3 ? p[i] : p[4 + i];
    v4[i] = (b3 ? p[4 + i] : p[i]) + __shfl_xor_sync(~0u, give, 8);
  }
  float v2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float give = b2 ? v4[i] : v4[2 + i];
    v2[i] = (b2 ? v4[2 + i] : v4[i]) + __shfl_xor_sync(~0u, give, 4);
  }
  const float v = (b1 ? v2[1] : v2[0]) +
                  __shfl_xor_sync(~0u, b1 ? v2[0] : v2[1], 2);
  return v + __shfl_xor_sync(~0u, v, 1);
}

// The float32 scratch lane.  The same function as paged_scratch_mma_kernel
// at float32: the f32 logits of the window, an exact softmax per row (max,
// exp, sum, divide), then P.V, every product an fmaf on the CUDA cores
// (TF32 would break the float32 contract of 1e-5).
//   * a window is split over a cluster of cs CTAs (gridDim.z,
//     scratch_cluster), each scoring a share of the tokens
//     (scratch_share) into its own logits; each row's max, then its sum
//     of exp, are combined across the cluster through distributed shared
//     memory (the sums in rank order), and the CTAs' P.V partials are
//     summed in rank order;
//   * K tiles, then V tiles (once per P.V pass), flow through one
//     cp.async ring of `stages` tiles of scratch_tile tokens, so V's
//     first tiles land while the softmax runs;
//   * shared memory delivers 128 bytes a cycle, a warp's 16-byte load 512,
//     so both products keep their reused operand in registers and load
//     each K or V element once per warp: a warp takes two tokens at a time,
//     one to each half, and each lane of a half two 16-byte chunks (4 dp
//     and 4 dp + 64 of each 128 columns).  Q.K: the lane's Q chunks of 8
//     rows stay in registers (loaded once where rows <= 8 and hd <= 128),
//     each K chunk feeds 32 fmaf, and the half's 16 partial dots of each
//     row meet in a fixed shuffle butterfly before __fmul_rn by the scale
//     and the masks; P.V: the lane keeps 8 rows x 8 columns of sums, each
//     weight (one 4-byte load for the half) feeds 8 fmaf and each V chunk
//     32; at a pass's end the two halves, then the four warps in order,
//     are added (more rows, or more than 128 columns, take more passes
//     over V);
//   * KV = Fp8: e4m3 tiles land in a ring of a quarter of the bytes and
//     are widened into one f32 tile before the math (the same sums: fp8
//     pages give the lane on upcast pages bit for bit); kGlobalL: the
//     logits live in the workspace `logits` (scratch_f32_global_l floats
//     per CTA) and the page table in device memory, past the on-chip
//     capacity, and each V tile's weights of the pass are divided and
//     staged in shared memory once, read from there by every column.
template <typename KV, bool kGlobalL>
__global__ void __launch_bounds__(kThreads) paged_scratch_kernel(
    const float* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    float* __restrict__ out, float* __restrict__ logits, Geom gm,
    int stages) {
  using T = float;
  constexpr bool kWiden = sizeof(KV) != sizeof(T);
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int cs = gridDim.z;           // the cluster spans blockIdx.z
  const int rank = blockIdx.z;
  const int g = gm.hq / gm.kv;
  const int rows = g * gm.sq;
  const int hd = gm.hd;
  const int cpr = hd / 4;
  const int mask = swz_mask(cpr);
  // Q (rows x hd f32, 16-byte chunk i at Qs + 4 i): a thread's first
  // kQLoads chunks are in flight while kv_len and the page table are read
  const int q_chunks = rows * cpr;
  auto q_src = [&](int i) {
    const int r = i / cpr;
    const int j = r / gm.sq;
    return q + ((static_cast<size_t>(b) * gm.sq + r - j * gm.sq) * gm.hq +
                h * g + j) * hd + (i - r * cpr) * 4;
  };
  float4 qv[kQLoads];
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < q_chunks) qv[u] = ld4(q_src(i));
  }
  const int depth = gm.p_seq * gm.ps;
  const int len = kv_len[b];
  const int qo = q_off[b];
  const int n = tokens_needed(len, depth);
  const int share = scratch_share(n, cs);
  const int tb0 = min(n, rank * share);       // this CTA's tokens [tb0, te0)
  const int te0 = min(n, tb0 + share);
  const int m = te0 - tb0;
  const int tt = scratch_tile(hd, 4);
  const int lst = scratch_f32_lst(m, tt);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = lane >> 4;         // the token of a pair this lane takes
  const int dp = lane & 15;           // its chunks dp and dp + 16 of each 32
  const F32Layout lay = scratch_f32_layout(rows, hd, depth, gm.ps, stages,
                                           cs, sizeof(KV), kGlobalL);
  const int stage = tt * hd;
  KV* ring = reinterpret_cast<KV*>(smem + lay.ring);
  T* wide = reinterpret_cast<T*>(smem + lay.wide);
  float* Qs = reinterpret_cast<float*>(smem + lay.qs);
  float* part = Qs;  // the P.V partials, once Q is no longer read
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  float* L;
  const int* pages;
  if constexpr (kGlobalL) {
    L = logits + ((static_cast<size_t>(b) * gm.kv + h) * cs + rank) *
                     scratch_f32_global_l(rows, hd, depth, cs);
    pages = pt + static_cast<size_t>(b) * gm.p_seq + tb0 / gm.ps;
  } else {
    L = reinterpret_cast<float*>(smem + lay.l);
    int* cta_pages = reinterpret_cast<int*>(smem + lay.pages);
    load_pages(pt + static_cast<size_t>(b) * gm.p_seq, tb0, te0, gm.ps,
               cta_pages);
    pages = cta_pages;
  }
  if (m > 0) {
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < q_chunks) *reinterpret_cast<float4*>(Qs + 4 * i) = qv[u];
    }
    for (int i = threadIdx.x + kQLoads * kThreads; i < q_chunks;
         i += kThreads)
      *reinterpret_cast<float4*>(Qs + 4 * i) = ld4(q_src(i));
  } else if (cs > 1) {  // a CTA with no tokens adds zero partials
    for (int i = threadIdx.x; i < rows * hd; i += kThreads) part[i] = 0.0f;
  }
  __syncthreads();  // the page entries, before the first issue

  const int n_tiles = (m + tt - 1) / tt;
  const int col_blocks = (cpr + kDBlock - 1) / kDBlock;
  const int passes = (rows + kRowTile - 1) / kRowTile * col_blocks;
  const int total = n_tiles * (1 + passes);
  auto issue = [&](int it) {
    if (it < total) {
      const KV* pool = it < n_tiles ? kp : vp;
      const int tile = it < n_tiles ? it : (it - n_tiles) % n_tiles;
      issue_tile<KV>(pool, nullptr, pages, tb0, h, gm.ps, gm.kv, hd,
                     tb0 + tile * tt, tt, te0, ring + (it % stages) * stage,
                     nullptr);
    }
    cp_async_commit();
  };
  // tile `it` once every thread's copies have landed (widened from e4m3)
  auto landed = [&](int it) -> const T* {
    cp_async_wait_upto(stages - 1);
    __syncthreads();
    if constexpr (kWiden) {
      widen_tile<T>(ring + (it % stages) * stage, wide, tt, hd);
      __syncthreads();
      return wide;
    } else {
      return ring + (it % stages) * stage;
    }
  };
  // every logit is in L: exact softmax per row (one warp per row), the
  // max and the sum over the whole window (red: this CTA's max, its sum,
  // the window's sum).  On chip the weights are divided in place, zero
  // past the CTA's tokens; in the global workspace the division waits for
  // the staging of each tile.  Every CTA of the cluster runs it once.
  auto softmax = [&]() {
    cg::cluster_group cluster = cg::this_cluster();
    for (int r = warp; r < rows; r += kWarps) {  // this CTA's row max
      const float* lr = L + static_cast<size_t>(r) * lst;
      float mx = -INFINITY;
      for (int t = lane; t < m; t += 32) mx = fmaxf(mx, lr[t]);
      mx = warp_max(mx);
      if (lane == 0) red[r] = mx;
    }
    if (cs > 1) cluster.sync();
    else __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {  // exp, this CTA's sum
      float* lr = L + static_cast<size_t>(r) * lst;
      float mx = red[r];
      if (cs > 1) {
        mx = -INFINITY;
        for (int k = 0; k < cs; ++k)
          mx = fmaxf(mx, *cluster.map_shared_rank(red + r, k));
      }
      float sum = 0.0f;
      for (int t = lane; t < m; t += 32) {
        const float e = expf(lr[t] - mx);
        lr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) red[rows + r] = sum;
    }
    if (cs > 1) cluster.sync();
    else __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {  // the window's sum, divide
      float sum = red[rows + r];
      if (cs > 1) {
        sum = 0.0f;
        for (int k = 0; k < cs; ++k)  // rank order
          sum += *cluster.map_shared_rank(red + rows + r, k);
      }
      if constexpr (kGlobalL) {
        if (lane == 0) red[2 * rows + r] = sum;
      } else {
        float* lr = L + static_cast<size_t>(r) * lst;
        for (int t = lane; t < lst; t += 32)
          lr[t] = t < m ? lr[t] / sum : 0.0f;
      }
    }
  };
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < stages - 1; ++s) issue(s);

  // Q.K: the lane's Q chunks of rows [qb, qb + 8), chunks db + dp (+ 16)
  float4 qr[kRowTile][2];
  auto load_qr = [&](int qb, int db) {
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = db + dp + 16 * e;
        qr[r][e] = qb + r < rows && c < cpr ? ld4(Qs + (qb + r) * hd + 4 * c)
                                            : zero4;
      }
  };
  const bool one_db = cpr <= kDBlock;
  const bool q_resident = one_db && rows <= kRowTile;
  if (q_resident) load_qr(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    issue(it + stages - 1);
    const T* st = landed(it);
    const int t0 = it * tt;                    // within the CTA's share
    const int cnt = min(tt, m - t0);
    for (int qb = 0; qb < rows; qb += kRowTile) {
      if (one_db && !q_resident) load_qr(qb, 0);
      for (int pr = warp; 2 * pr < cnt; pr += kWarps) {
        const int t = 2 * pr + half;           // < tt
        float p[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) p[r] = 0.0f;
        for (int db = 0; db < cpr; db += kDBlock) {
          if (!one_db) load_qr(qb, db);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = db + dp + 16 * e;
            const float4 k = c < cpr ? ld4(st + swz<T>(t, c, hd, mask))
                                     : zero4;
#pragma unroll
            for (int r = 0; r < kRowTile; ++r) {
              p[r] = fmaf(qr[r][e].x, k.x, p[r]);
              p[r] = fmaf(qr[r][e].y, k.y, p[r]);
              p[r] = fmaf(qr[r][e].z, k.z, p[r]);
              p[r] = fmaf(qr[r][e].w, k.w, p[r]);
            }
          }
        }
        const float v = half_warp_rows8(p, lane);
        const int r = qb + ((lane >> 1) & 7);
        if ((lane & 1) == 0 && r < rows && t < cnt)
          L[static_cast<size_t>(r) * lst + t0 + t] =
              mask_logit(__fmul_rn(v, gm.scale), tb0 + t0 + t, r % gm.sq, qo,
                         len, gm.causal);
      }
    }
    __syncthreads();  // the slot is refilled stages - 1 tiles later
  }

  // P.V: pass by pass (rows [rb, rb + 8) x chunks [cb, cb + 32)), each
  // over every V tile
  float4 acc[kRowTile][2];
  for (int it = n_tiles; it < total; ++it) {
    issue(it + stages - 1);
    if (it == n_tiles) softmax();
    const T* st = landed(it);
    const int vi = it - n_tiles;
    const int vt = vi % n_tiles;
    const int pass = vi / n_tiles;
    const int rb = pass / col_blocks * kRowTile;
    const int cb = pass % col_blocks * kDBlock;
    const int nr = min(kRowTile, rows - rb);
    const int t0 = vt * tt;
    const int cnt = min(tt, m - t0);
    const float* P;
    int pst;
    if constexpr (kGlobalL) {  // this tile's weights of the pass's rows
      for (int i = threadIdx.x; i < kRowTile * tt; i += kThreads) {
        const int rr = i / tt;
        const int t = i - rr * tt;
        pw[i] = rr < nr && t < cnt
                    ? L[static_cast<size_t>(rb + rr) * lst + t0 + t] /
                          red[2 * rows + rb + rr]
                    : 0.0f;
      }
      __syncthreads();
      P = pw;
      pst = tt;
    } else {
      P = L + static_cast<size_t>(rb) * lst + t0;
      pst = lst;
    }
    if (vt == 0) {
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) acc[r][0] = acc[r][1] = zero4;
    }
    for (int pr = warp; 2 * pr < cnt; pr += kWarps) {
      const int t = 2 * pr + half;             // < tt; zero past cnt
      float4 v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cb + dp + 16 * e;
        v[e] = c < cpr ? ld4(st + swz<T>(t, c, hd, mask)) : zero4;
      }
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float w = r < nr ? P[r * pst + t] : 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[r][e].x = fmaf(w, v[e].x, acc[r][e].x);
          acc[r][e].y = fmaf(w, v[e].y, acc[r][e].y);
          acc[r][e].z = fmaf(w, v[e].z, acc[r][e].z);
          acc[r][e].w = fmaf(w, v[e].w, acc[r][e].w);
        }
      }
    }
    if (vt == n_tiles - 1) {
      // the pass's sums: the two halves of each warp, then the four warps
      // in order, into part (the CTA's partial) or, alone in the window,
      // into out
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4& a = acc[r][e];
          a.x += __shfl_xor_sync(~0u, a.x, 16);
          a.y += __shfl_xor_sync(~0u, a.y, 16);
          a.z += __shfl_xor_sync(~0u, a.z, 16);
          a.w += __shfl_xor_sync(~0u, a.w, 16);
        }
      for (int w = 0; w < kWarps; ++w) {
        if (warp == w && half == 0) {
#pragma unroll
          for (int r = 0; r < kRowTile; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = cb + dp + 16 * e;
              if (r < nr && c < cpr) {
                float* pp = part + (rb + r) * hd + 4 * c;
                float4 a = acc[r][e];
                if (w > 0) {
                  const float4 o = ld4(pp);
                  a = make_float4(o.x + a.x, o.y + a.y, o.z + a.z,
                                  o.w + a.w);
                }
                if (cs == 1 && w == kWarps - 1) {
                  store_out(out, b, h, gm, rb + r, 4 * c, a.x);
                  store_out(out, b, h, gm, rb + r, 4 * c + 1, a.y);
                  store_out(out, b, h, gm, rb + r, 4 * c + 2, a.z);
                  store_out(out, b, h, gm, rb + r, 4 * c + 3, a.w);
                } else {
                  *reinterpret_cast<float4*>(pp) = a;
                }
              }
            }
        }
        if (w + 1 < kWarps) __syncthreads();
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
      float v = 0.0f;
      for (int k = 0; k < cs; ++k)
        v += *cluster.map_shared_rank(part + i, k);
      store_out(out, b, h, gm, i / hd, i % hd, v);
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

// split_pages: the most page-table entries one split reads; kv_bytes: 1
// for e4m3 pools (a ring of e4m3 tiles, then one widened K and V tile)
size_t streamed_smem(int hd, int elem_bytes, int kv_bytes, int split_pages) {
  size_t s = static_cast<size_t>(ring_stages(hd, elem_bytes)) * 2 *
                 kTileTokens * hd * kv_bytes +
             (kv_bytes != elem_bytes
                  ? static_cast<size_t>(2) * kTileTokens * hd * elem_bytes
                  : 0) +
             static_cast<size_t>(kGroupRows) * hd * elem_bytes +
             static_cast<size_t>(split_pages) * 4;
  if (elem_bytes == 4) s += (kWarps * kGroupRows * (kWarpTokens + 1)) * 4;
  return s;
}

// -- streamed lane: split and combine kernels -------------------------------

// part_ml[(((b * kv + h) * n_split + split) * R + r) * 2 + {0, 1}] = m, l;
// part_acc[... * hd + d] = the unnormalised f32 accumulator; R = g * sq.
// KV = Fp8: the ring holds e4m3 tiles, each widened into one T tile pair
// before the math.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    float* __restrict__ part_ml, float* __restrict__ part_acc, Geom gm,
    int n_blocks, int block_tokens, int n_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStages = ring_stages(HD, sizeof(T));
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCpr = HD / kVec;
  constexpr int kMask = swz_mask(kCpr);
  constexpr int kStage = 2 * kTileTokens * HD;  // K tile then V tile
  constexpr bool kWiden = sizeof(KV) != sizeof(T);
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
  // layout: ring (kStages x [K tile | V tile] of KV) | the widened [K | V]
  // T tiles (e4m3 pools) | Qs [16][HD] | Pw | Aw (float32) | the split's
  // page-table entries
  KV* ring = reinterpret_cast<KV*>(smem);
  T* wide = reinterpret_cast<T*>(ring + kStages * kStage);
  T* Qs = wide + (kWiden ? kStage : 0);
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
      KV* st = ring + (it % kStages) * kStage;
      const int t0 = t_begin + it * kTileTokens;
      issue_tile<KV>(kp, vp, pages, t_begin, h, gm.ps, gm.kv, HD, t0,
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
    const T* st;
    if constexpr (kWiden) {  // K and V rows alike: 2 x kTileTokens rows
      widen_tile<T>(ring + (it % kStages) * kStage, wide, 2 * kTileTokens,
                    HD);
      __syncthreads();
      st = wide;
    } else {
      st = ring + (it % kStages) * kStage;
    }
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

template <typename T, typename KV, int HD>
cudaError_t launch_split(const SplitArgs& a) {
  const size_t smem =
      streamed_smem(HD, sizeof(T), sizeof(KV), a.split_pages);
  static smem::SmemGrant grant;
  cudaError_t err = grant.allow(paged_split_kernel<T, KV, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.gm.kv, a.n_split * a.groups);
  paged_split_kernel<T, KV, HD><<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), static_cast<const int32_t*>(a.pt),
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

template <typename T, typename KV>
cudaError_t split_by_hd(const SplitArgs& a) {
  if (a.gm.hd <= 0 || (a.gm.hd * static_cast<int>(sizeof(T))) % 16 != 0 ||
      (a.gm.hd * static_cast<int>(sizeof(KV))) % 16 != 0)
    return cudaErrorInvalidValue;
  switch (streamed_width(a.gm.hd)) {
    case 16: return launch_split<T, KV, 16>(a);
    case 32: return launch_split<T, KV, 32>(a);
    case 64: return launch_split<T, KV, 64>(a);
    case 80: return launch_split<T, KV, 80>(a);
    case 96: return launch_split<T, KV, 96>(a);
    case 128: return launch_split<T, KV, 128>(a);
    case 192: return launch_split<T, KV, 192>(a);
    case 256: return launch_split<T, KV, 256>(a);
    default: break;
  }
  return cudaErrorInvalidValue;
}

struct ScratchArgs {
  const void *q, *kp, *vp, *pt, *kv_len, *q_off;
  void* out;
  float* logits;
  Geom gm;
  int B;
  cudaStream_t st;
};

// either scratch kernel (T: q's and out's type): a cluster of cs CTAs per
// (row, KV head) along z
template <typename T, typename KV, typename K>
cudaError_t launch_scratch(K kernel, smem::SmemGrant& grant,
                           const ScratchArgs& a, int cs, int stages,
                           size_t smem) {
  cudaError_t err = grant.allow(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B, a.gm.kv, cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.kv_len),
      static_cast<const int32_t*>(a.q_off), static_cast<T*>(a.out), a.logits,
      a.gm, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename KV, bool kGlobalL>
cudaError_t launch_scratch_mma(const ScratchArgs& a, int cs, int stages,
                               size_t smem) {
  static smem::SmemGrant grant;
  return launch_scratch<__nv_bfloat16, KV>(
      paged_scratch_mma_kernel<KV, kGlobalL>, grant, a, cs, stages, smem);
}

template <typename KV, bool kGlobalL>
cudaError_t launch_scratch_f32(const ScratchArgs& a, int cs, size_t smem) {
  static smem::SmemGrant grant;
  return launch_scratch<float, KV>(paged_scratch_kernel<KV, kGlobalL>, grant,
                                   a, cs, kF32Stages, smem);
}

// bytes of an element for a dtype code: 0 float32, 1 bfloat16, 2 e4m3
inline int dtype_bytes(int code) {
  return code == 0 ? 4 : code == 1 ? 2 : code == 2 ? 1 : 0;
}
// q in float32 or bf16; K/V in q's type or e4m3
inline bool dtype_pair_ok(int dtype, int kv_dtype) {
  return (dtype == 0 || dtype == 1) && (kv_dtype == dtype || kv_dtype == 2);
}

}  // namespace

extern "C" {

// Shared-memory bytes the scratch lane's on-chip layout needs per block
// (the wrapper compares them with the card's per-block limit).  depth is
// the table's token depth P_seq * ps, blocks the launch's B * kv,
// kv_bytes the K/V element size (1 for e4m3).  Each CTA of the cluster
// the launch splits the window over (scratch_cluster) holds its share of
// the logits, and this is the least it takes (a two-stage ring; the bf16
// launch deepens its ring where room is left).
size_t paged_scratch_smem(int sq, int hq, int kv, int hd, int depth,
                          int ps, int elem_bytes, int kv_bytes, int blocks) {
  const int rows = hq / kv * sq;
  const int cs = scratch_cluster(depth, blocks, sm_count());
  if (elem_bytes == 2)
    return scratch_layout(rows, hd, depth, ps, 2, cs, kv_bytes, false).total;
  return scratch_f32_layout(rows, hd, depth, ps, kF32Stages, cs, kv_bytes,
                            false)
      .total;
}

// The deepest table (whole pages, in tokens) the on-chip layout holds at
// this shape: the largest depth whose paged_scratch_smem fits a block.
// The bytes grow with depth between the cluster's steps and fall at each
// step, so every depth from the largest a cluster of 8 could hold down is
// tried.  Deeper tables keep their logits in the global workspace.
int paged_scratch_capacity(int sq, int hq, int kv, int hd, int ps,
                           int elem_bytes, int kv_bytes, int blocks) {
  const long long rows = static_cast<long long>(hq / kv) * sq;
  if (rows <= 0 || ps <= 0) return 0;
  // each CTA holds at least depth / 8 tokens of f32 logits per row
  for (long long pages = 8LL * kSmemLimit / (4 * rows * ps) + 1; pages > 0;
       --pages) {
    if (paged_scratch_smem(sq, hq, kv, hd, static_cast<int>(pages * ps), ps,
                           elem_bytes, kv_bytes, blocks) <=
        static_cast<size_t>(kSmemLimit))
      return static_cast<int>(pages * ps);
  }
  return 0;
}

// Bytes of the global logits workspace a scratch launch at this shape
// needs: 0 while the on-chip layout fits, else one f32 region per (row,
// KV head, cluster rank).
size_t paged_scratch_workspace(int B, int sq, int hq, int kv, int hd,
                               int depth, int ps, int elem_bytes,
                               int kv_bytes) {
  if (paged_scratch_smem(sq, hq, kv, hd, depth, ps, elem_bytes, kv_bytes,
                         B * kv) <= static_cast<size_t>(kSmemLimit))
    return 0;
  const int rows = hq / kv * sq;
  const size_t bk = static_cast<size_t>(B) * kv;
  const int cs = scratch_cluster(depth, B * kv, sm_count());
  if (elem_bytes == 2) return bk * cs * scratch_global_l(rows, depth, cs) * 4;
  return bk * cs * scratch_f32_global_l(rows, hd, depth, cs) * 4;
}

// split_pages: ceil(blocks / n_split) * block_pages; hd is the pools'
// head dim (0 when no compiled width holds it)
size_t paged_streamed_smem(int hd, int elem_bytes, int kv_bytes,
                           int split_pages) {
  const int w = streamed_width(hd);
  return w == 0 ? 0 : streamed_smem(w, elem_bytes, kv_bytes, split_pages);
}

// scale is hd^-0.5 rounded to f32 by the caller; dtype (q and out): 0 =
// float32, 1 = bfloat16; kv_dtype: dtype, or 2 = float8_e4m3fn.  logits:
// the workspace of paged_scratch_workspace bytes, or null when that is 0.
// Each returns a cudaError_t (0 = launched).
int paged_scratch_launch(const void* q, const void* kp, const void* vp,
                         const void* pt, const void* kv_len,
                         const void* q_off, void* out, void* logits, int B,
                         int sq, int hq, int kv, int hd, int ps, int p_seq,
                         int causal, float scale, int dtype, int kv_dtype,
                         void* stream) {
  const int qb = dtype_bytes(dtype);
  const int kvb = dtype_bytes(kv_dtype);
  if (B <= 0 || kv <= 0 || hq % kv != 0 || !dtype_pair_ok(dtype, kv_dtype) ||
      hd <= 0 || (hd * qb) % 16 != 0 || (hd * kvb) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScratchArgs a{q, kp, vp, pt, kv_len, q_off, out,
                      static_cast<float*>(logits),
                      Geom{sq, hq, kv, hd, ps, p_seq, causal, scale}, B,
                      static_cast<cudaStream_t>(stream)};
  const int rows = hq / kv * sq;
  const int depth = p_seq * ps;
  const bool fp8 = kv_dtype == 2;
  cudaError_t err;
  if (dtype == 1) {
    const int cs = scratch_cluster(depth, B * kv, sm_count());
    const bool global_l =
        scratch_layout(rows, hd, depth, ps, 2, cs, kvb, false).total >
        static_cast<size_t>(kSmemLimit);
    if (global_l && logits == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    // a split window has parallelism enough: a three-stage ring keeps more
    // of the cluster's CTAs resident at once
    int stages = cs > 1 ? 3 : kMmaMaxStages;
    while (stages > 2 &&
           scratch_layout(rows, hd, depth, ps, stages, cs, kvb, global_l)
                   .total > static_cast<size_t>(kSmemLimit))
      --stages;
    const size_t smem =
        scratch_layout(rows, hd, depth, ps, stages, cs, kvb, global_l).total;
    using T = __nv_bfloat16;
    if (fp8)
      err = global_l ? launch_scratch_mma<Fp8, true>(a, cs, stages, smem)
                     : launch_scratch_mma<Fp8, false>(a, cs, stages, smem);
    else
      err = global_l ? launch_scratch_mma<T, true>(a, cs, stages, smem)
                     : launch_scratch_mma<T, false>(a, cs, stages, smem);
    return static_cast<int>(err);
  }
  const int cs = scratch_cluster(depth, B * kv, sm_count());
  const bool global_l =
      scratch_f32_layout(rows, hd, depth, ps, kF32Stages, cs, kvb, false)
          .total > static_cast<size_t>(kSmemLimit);
  if (global_l && logits == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      scratch_f32_layout(rows, hd, depth, ps, kF32Stages, cs, kvb, global_l)
          .total;
  if (fp8)
    err = global_l ? launch_scratch_f32<Fp8, true>(a, cs, smem)
                   : launch_scratch_f32<Fp8, false>(a, cs, smem);
  else
    err = global_l ? launch_scratch_f32<float, true>(a, cs, smem)
                   : launch_scratch_f32<float, false>(a, cs, smem);
  return static_cast<int>(err);
}

// The split kernel: partials of n_split contiguous runs of whole blocks of
// block_pages pages into part_ml (B, kv, n_split, g * sq, 2) and part_acc
// (B, kv, n_split, g * sq, hd), float32.  dtype and kv_dtype as for
// paged_scratch_launch.  hd is a whole number of 16-byte chunks at q's
// type and at K/V's, at most 256; it runs on the next compiled width up (16, 32, 64,
// 80, 96, 128, 192, 256); p_seq % block_pages == 0; 1 <= n_split <= the
// number of blocks.
int paged_split_launch(const void* q, const void* kp, const void* vp,
                       const void* pt, const void* kv_len, const void* q_off,
                       void* part_ml, void* part_acc, int B, int sq, int hq,
                       int kv, int hd, int ps, int p_seq, int causal,
                       float scale, int dtype, int kv_dtype,
                       int block_pages, int n_split, void* stream) {
  if (B <= 0 || kv <= 0 || sq <= 0 || hq % kv != 0 || block_pages <= 0 ||
      p_seq % block_pages != 0 || n_split < 1 ||
      n_split > p_seq / block_pages || !dtype_pair_ok(dtype, kv_dtype)) {
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
  using T = __nv_bfloat16;
  const bool fp8 = kv_dtype == 2;
  const cudaError_t err =
      dtype == 0 ? (fp8 ? split_by_hd<float, Fp8>(a)
                        : split_by_hd<float, float>(a))
                 : (fp8 ? split_by_hd<T, Fp8>(a) : split_by_hd<T, T>(a));
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
