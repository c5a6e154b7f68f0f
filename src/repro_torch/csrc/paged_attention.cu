// Paged ragged decode attention for NVIDIA Hopper (sm_90a), two lanes.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention/kernel.py:
//   * `paged_attention_kernel` (body `_kernel`), the scratch lane:
//     gather a row's pages through its page table, then grouped SDPA with
//     an exact softmax;
//   * `paged_attention_streamed` (body `_stream_body`), the streamed lane:
//     online softmax over blocks of `block_pages` pages.
//
// Shapes: q (B, sq, hq, hd); k/v pages (P + 1, ps, kv, hd), page 0 the
// null page; page_table (B, P_seq) int32; kv_len, q_offset (B,) int32;
// out (B, sq, hq, hd) in q's type.  T is float or bf16.
//
// Numerics, as in the reference: logits in f32 (bf16 products are exact
// in f32), times hd^-0.5; -1e30 for causal (q_offset + s < t) and length
// (t >= kv_len) masking; the scratch lane takes max, exp, sum and divides,
// rounds the weights to T and accumulates P.V in f32 before rounding to
// T; the streamed lane keeps running max m, denominator l and an f32
// accumulator and normalises at the end.
//
// What bounds it on the H100: the bytes of K/V pages a row attends over
// (2 * kv_len * kv * hd * sizeof(T) per row) against 3.35 TB/s; the
// arithmetic is 4 * sq * hq * hd flops per attended token.
//
// What the design does about it:
//   * one block per (row, KV head); it reads its own page-table entries
//     and covers the g = hq / kv query heads of that group, so each K/V
//     element is read from device memory once for all g heads and all sq
//     queries of the window;
//   * it stages per KV head only (a whole row at full width would not fit
//     in shared memory), with 16-byte loads, and with the K rows padded by
//     one word so the per-token dot products hit distinct banks;
//   * it reads only the tokens the length mask keeps: once a row has a
//     valid position (kv_len >= 1, and position 0 is never causally
//     masked), every token t >= kv_len has weight exp(-1e30 - max) = 0
//     exactly, so skipping it changes no bit of the result.  A row with
//     kv_len = 0 reads its whole table, as the reference does.
//   * the gather is read-only: aliased page tables are in contract.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: expf and the divides are exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegBig = -1e30f;

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

// K row stride in elements: one extra 32-bit word per token row
template <typename T> __host__ __device__ constexpr int k_stride(int hd) {
  return hd + static_cast<int>(4 / sizeof(T));
}

struct Geom {
  int sq, hq, kv, hd, ps, p_seq, causal;
  float scale;
};

// stage tokens [t0, t0 + n) of row b, head h into Ks / Vs, 16 bytes per
// load (a head row is a whole number of 16-byte chunks; the wrapper
// checks it), unrolled so that a thread's loads are in flight together
template <typename T>
__device__ void stage_kv(const T* __restrict__ kp, const T* __restrict__ vp,
                         const int32_t* __restrict__ pt_row, int h,
                         const Geom& gm, int t0, int n, T* Ks, T* Vs) {
  constexpr int kVec = 16 / sizeof(T);
  const int kst = k_stride<T>(gm.hd);
  const int chunks = gm.hd / kVec;
#pragma unroll 4
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = i - t * chunks;
    const int ta = t0 + t;
    const int page = pt_row[ta / gm.ps];
    const size_t src =
        ((static_cast<size_t>(page) * gm.ps + ta % gm.ps) * gm.kv + h) *
            gm.hd + c * kVec;
    const uint4 kq = *reinterpret_cast<const uint4*>(kp + src);
    const uint4 vq = *reinterpret_cast<const uint4*>(vp + src);
    // shared rows are only 4-byte aligned (K rows carry one pad word)
    uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + t * kst + c * kVec);
    uint32_t* vd = reinterpret_cast<uint32_t*>(Vs + t * gm.hd + c * kVec);
    kd[0] = kq.x; kd[1] = kq.y; kd[2] = kq.z; kd[3] = kq.w;
    vd[0] = vq.x; vd[1] = vq.y; vd[2] = vq.z; vd[3] = vq.w;
  }
}

// logits L[r][t] for rows r = j * sq + s of the group, tokens t0 + t
template <typename T>
__device__ void logits(const float* Qs, const T* Ks, const Geom& gm,
                       int t0, int n, int q_off, int len, float* L) {
  const int kst = k_stride<T>(gm.hd);
  const int g = gm.hq / gm.kv;
  for (int i = threadIdx.x; i < g * gm.sq * n; i += blockDim.x) {
    const int r = i / n;
    const int t = i - r * n;
    const float* qr = Qs + r * gm.hd;
    const T* kr = Ks + t * kst;
    float dot = 0.0f;
    for (int d = 0; d < gm.hd; ++d) dot = fmaf(qr[d], to_f(kr[d]), dot);
    float v = __fmul_rn(dot, gm.scale);
    const int s = r % gm.sq;
    const int ta = t0 + t;
    if (gm.causal && q_off + s < ta) v = kNegBig;
    if (ta >= len) v = kNegBig;
    L[r * n + t] = v;
  }
}

template <typename T>
__device__ void load_q(const T* __restrict__ q, int b, int h, const Geom& gm,
                       float* Qs) {
  const int g = gm.hq / gm.kv;
  for (int i = threadIdx.x; i < g * gm.sq * gm.hd; i += blockDim.x) {
    const int r = i / gm.hd;
    const int d = i - r * gm.hd;
    const int j = r / gm.sq;
    const int s = r - j * gm.sq;
    Qs[i] = to_f(q[((static_cast<size_t>(b) * gm.sq + s) * gm.hq + h * g +
                    j) * gm.hd + d]);
  }
}

template <typename T>
__device__ void store_out(T* __restrict__ out, int b, int h, const Geom& gm,
                          int r, int d, float v) {
  const int g = gm.hq / gm.kv;
  const int j = r / gm.sq;
  const int s = r - j * gm.sq;
  out[((static_cast<size_t>(b) * gm.sq + s) * gm.hq + h * g + j) * gm.hd +
      d] = from_f<T>(v);
}

// tokens a row must read: the valid depth, or the whole table when the
// row holds no valid position
__device__ __forceinline__ int tokens_needed(int len, int depth) {
  return len > 0 ? min(len, depth) : depth;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scratch_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    T* __restrict__ out, Geom gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = gm.hq / gm.kv;
  const int rows = g * gm.sq;
  const int depth = gm.p_seq * gm.ps;
  const int len = kv_len[b];
  const int n = tokens_needed(len, depth);
  const int kst = k_stride<T>(gm.hd);
  // layout: Qs | L | Ks | Vs  (f32 first keeps every region aligned)
  float* Qs = reinterpret_cast<float*>(smem);
  float* L = Qs + rows * gm.hd;
  T* Ks = reinterpret_cast<T*>(L + rows * n);
  T* Vs = Ks + n * kst;
  load_q(q, b, h, gm, Qs);
  stage_kv(kp, vp, pt + static_cast<size_t>(b) * gm.p_seq, h, gm, 0, n, Ks,
           Vs);
  __syncthreads();
  logits(Qs, Ks, gm, 0, n, q_off[b], len, L);
  __syncthreads();
  // exact softmax per row: max, exp, sum, divide (one warp per row)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* lr = L + r * n;
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
  for (int i = threadIdx.x; i < rows * gm.hd; i += blockDim.x) {
    const int r = i / gm.hd;
    const int d = i - r * gm.hd;
    const float* wr = L + r * n;
    float acc = 0.0f;
    for (int t = 0; t < n; ++t) acc = fmaf(wr[t], to_f(Vs[t * gm.hd + d]), acc);
    store_out(out, b, h, gm, r, d, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) streamed_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    T* __restrict__ out, Geom gm, int block_pages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = gm.hq / gm.kv;
  const int rows = g * gm.sq;
  const int bt = block_pages * gm.ps;
  const int n_blocks = gm.p_seq / block_pages;
  const int len = kv_len[b];
  const int qo = q_off[b];
  // blocks past the valid depth leave m, l and acc unchanged exactly
  // (alpha = 1, p = 0) once block 0 has set a finite running max
  const int n_eff = len > 0 ? min(n_blocks, (len + bt - 1) / bt) : n_blocks;
  const int kst = k_stride<T>(gm.hd);
  // layout: Qs | Acc | P | m | l | alpha | Ks | Vs
  float* Qs = reinterpret_cast<float*>(smem);
  float* Acc = Qs + rows * gm.hd;
  float* P = Acc + rows * gm.hd;
  float* M = P + rows * bt;
  float* Lsum = M + rows;
  float* Alpha = Lsum + rows;
  T* Ks = reinterpret_cast<T*>(Alpha + rows);
  T* Vs = Ks + bt * kst;
  const int32_t* pt_row = pt + static_cast<size_t>(b) * gm.p_seq;
  load_q(q, b, h, gm, Qs);
  for (int i = threadIdx.x; i < rows * gm.hd; i += blockDim.x) Acc[i] = 0.0f;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    M[i] = kNegBig;
    Lsum[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int jb = 0; jb < n_eff; ++jb) {
    __syncthreads();  // the previous block's Ks / Vs / P are consumed
    stage_kv(kp, vp, pt_row, h, gm, jb * bt, bt, Ks, Vs);
    __syncthreads();
    logits(Qs, Ks, gm, jb * bt, bt, qo, len, P);
    __syncthreads();
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* pr = P + r * bt;
      float mx = kNegBig;
      for (int t = lane; t < bt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = M[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < bt; t += 32) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Alpha[r] = alpha;
        Lsum[r] = __fadd_rn(__fmul_rn(Lsum[r], alpha), sum);
        M[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * gm.hd; i += blockDim.x) {
      const int r = i / gm.hd;
      const int d = i - r * gm.hd;
      const float* pr = P + r * bt;
      float pv = 0.0f;
      for (int t = 0; t < bt; ++t) pv = fmaf(pr[t], to_f(Vs[t * gm.hd + d]), pv);
      Acc[i] = __fadd_rn(__fmul_rn(Acc[i], Alpha[r]), pv);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * gm.hd; i += blockDim.x) {
    const int r = i / gm.hd;
    store_out(out, b, h, gm, r, i - r * gm.hd, Acc[i] / Lsum[r]);
  }
}

// dynamic shared memory above 48 KB must be opted into per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared-memory bytes each lane needs (the wrapper checks them against
// the card's per-block limit before launching).
size_t paged_scratch_smem(int sq, int hq, int kv, int hd, int depth,
                          int elem_bytes) {
  const size_t rows = static_cast<size_t>(hq / kv) * sq;
  const size_t kst = hd + 4 / elem_bytes;
  return rows * hd * 4 + rows * depth * 4 +
         static_cast<size_t>(depth) * (kst + hd) * elem_bytes;
}

size_t paged_streamed_smem(int sq, int hq, int kv, int hd, int block_tokens,
                           int elem_bytes) {
  const size_t rows = static_cast<size_t>(hq / kv) * sq;
  const size_t kst = hd + 4 / elem_bytes;
  return 2 * rows * hd * 4 + rows * block_tokens * 4 + 3 * rows * 4 +
         static_cast<size_t>(block_tokens) * (kst + hd) * elem_bytes;
}

// scale is hd^-0.5 rounded to f32 by the caller; dtype: 0 = float32,
// 1 = bfloat16.  block_pages <= 0 selects the scratch lane.  Returns a cudaError_t (0 = launched).
int paged_attention_launch(const void* q, const void* kp, const void* vp,
                           const void* pt, const void* kv_len,
                           const void* q_off, void* out, int B, int sq,
                           int hq, int kv, int hd, int ps, int p_seq,
                           int causal, float scale, int dtype,
                           int block_pages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || kv <= 0 || hq % kv != 0 || (dtype != 0 && dtype != 1) ||
      (hd * (dtype == 0 ? 4 : 2)) % 16 != 0 ||
      (block_pages > 0 && p_seq % block_pages != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom gm{sq, hq, kv, hd, ps, p_seq, causal, scale};
  const dim3 grid(B, kv);
  const int eb = dtype == 0 ? 4 : 2;
  cudaError_t err;
#define PA_LAUNCH(T)                                                        \
  do {                                                                      \
    const T* qq = static_cast<const T*>(q);                                 \
    const T* kk = static_cast<const T*>(kp);                                \
    const T* vv = static_cast<const T*>(vp);                                \
    T* oo = static_cast<T*>(out);                                           \
    const int32_t* tt = static_cast<const int32_t*>(pt);                    \
    const int32_t* ll = static_cast<const int32_t*>(kv_len);                \
    const int32_t* ff = static_cast<const int32_t*>(q_off);                 \
    if (block_pages > 0) {                                                  \
      const size_t smem = paged_streamed_smem(sq, hq, kv, hd,               \
                                              block_pages * ps, eb);        \
      err = allow_smem(streamed_kernel<T>, smem);                     \
      if (err != cudaSuccess) return static_cast<int>(err);                 \
      streamed_kernel<T><<<grid, kThreads, smem, st>>>(qq, kk, vv, tt, ll,  \
                                                       ff, oo, gm,          \
                                                       block_pages);        \
    } else {                                                                \
      const size_t smem = paged_scratch_smem(sq, hq, kv, hd, p_seq * ps,    \
                                             eb);                           \
      err = allow_smem(scratch_kernel<T>, smem);                      \
      if (err != cudaSuccess) return static_cast<int>(err);                 \
      scratch_kernel<T><<<grid, kThreads, smem, st>>>(qq, kk, vv, tt, ll,   \
                                                      ff, oo, gm);          \
    }                                                                       \
  } while (0)
  if (dtype == 0) {
    PA_LAUNCH(float);
  } else {
    PA_LAUNCH(__nv_bfloat16);
  }
#undef PA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
