// Deep-net streaming crossbar matmul for NVIDIA Hopper (sm_90a): the
// program step (quantize float weights to differential cell codes) fused
// into the read (bit-serial MAC + ADC), so no cell planes are kept in
// device memory.
//
// Replaces the TPU kernel `deepnet_stream` of
// src/repro/kernels/deepnet_stream/kernel.py (body `_kernel`).
//
// What it computes, for x_int (B, K) int32, a float weight w (K, N)
// (float32 or bfloat16) and per-column scales w_scale (N,) float32:
//
//   w_int = clip(rint(w / w_scale), -qmax, qmax),  qmax = 2^w_bits - 1
//   pos/neg digit s = ((max(+-w_int, 0)) >> (bpc * s)) & (2^bpc - 1)
//
// then the crossbar MAC of crossbar_mac.cu on those codes, with no leak,
// over row groups of `rows` rows.  The result, in code units, equals
// engine.program followed by the crossbar_mac kernel bit for bit: the
// quantization is the reference's arithmetic (correctly rounded divide
// __fdiv_rn, round half to even rintf, clamp), and the MAC, ADC and
// integer shift-add are the same code (xbar_mac.cuh).
//
// What bounds it on the H100: it reads the weight once (4 bytes per weight
// in float32, 2 in bfloat16), against the MAC's 2 * S = 8 bytes of int8
// cell planes, so its bytes are a half or a quarter of the MAC's; its
// integer work (popcount, ADC table reads) is the MAC's, which bounds the
// MAC kernel, so this kernel is expected to be popcount-bound too.
//
// What the design does about it: each block takes its 128 columns of a
// row group from the weight (neighbouring threads read neighbouring
// elements), quantizes them in registers and keeps the signed codes of
// the group as int8 in shared memory (its "programmed tile": one byte per
// weight, 32 KB at 256 rows), from which each slice's bit masks are built
// as crossbar_mac builds them from device memory.  A column is only ever
// touched by its own thread, so the tile needs no barrier.  Ragged edges
// (K not a multiple of `rows`, N not a multiple of 128, B not a multiple
// of 16) are masked here; the caller pads nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the rounding must be exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "xbar_mac.cuh"

namespace {

constexpr int kMaxWBits = 7;   // signed codes of the tile fit in int8

__device__ __forceinline__ float load_w(const float* p) { return *p; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int BPC, int WORDS>
struct StreamCells {
  const T* __restrict__ w;
  int N;
  int col;
  float scale;
  float qmax;
  int8_t (*tile)[xbar::kNT];   // [32 * WORDS][kNT] signed codes

  // the "program" step of the row group: quantize this column's rows
  __device__ __forceinline__ void begin_group(int k0, int kvalid) {
    const T* wc = w + static_cast<size_t>(k0) * N + col;
#pragma unroll 8
    for (int row = 0; row < kvalid; ++row) {
      const float v = load_w(wc + static_cast<size_t>(row) * N);
      float q = rintf(__fdiv_rn(v, scale));
      q = fminf(fmaxf(q, -qmax), qmax);
      tile[row][threadIdx.x] = static_cast<int8_t>(q);
    }
  }

  __device__ __forceinline__ void masks(int s, int, int kvalid,
                                        uint32_t* mp, uint32_t* mn) const {
    const int shift = BPC * s;
    const int digit = (1 << BPC) - 1;
    int8_t (*t)[xbar::kNT] = tile;
    const int c = threadIdx.x;
    xbar::build_masks<BPC, WORDS>(
        [t, c, shift, digit](int row, uint32_t& pv, uint32_t& nv) {
          const int v = t[row][c];
          pv = static_cast<uint32_t>(((v > 0 ? v : 0) >> shift) & digit);
          nv = static_cast<uint32_t>(((v < 0 ? -v : 0) >> shift) & digit);
        },
        kvalid, mp, mn);
  }
};

template <typename T, int BPC, int WORDS>
__global__ void __launch_bounds__(xbar::kNT) deepnet_stream_kernel(
    const int32_t* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ w_scale,
    unsigned long long* __restrict__ acc_out, int B, int K, int N, int S,
    int in_bits, int rows, int groups_per_split, float lsb, float levels,
    float qmax) {
  __shared__ xbar::Shared<WORDS> sm;
  __shared__ int8_t tile[32 * WORDS][xbar::kNT];
  const int n_groups = (K + rows - 1) / rows;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  const int col = static_cast<int>(blockIdx.x) * xbar::kNT +
                  static_cast<int>(threadIdx.x);
  StreamCells<T, BPC, WORDS> cells{w, N, col,
                                   col < N ? w_scale[col] : 1.0f, qmax,
                                   tile};
  xbar::mac_groups<BPC, WORDS>(cells, sm, x, 0.0f, acc_out, B, K, N, S,
                               in_bits, rows, g_begin, g_end, lsb, levels);
}

template <typename T, int BPC, int WORDS>
cudaError_t launch_variant(dim3 grid, cudaStream_t st, const int32_t* x,
                           const void* w, const float* scale,
                           unsigned long long* acc, int B, int K, int N,
                           int S, int in_bits, int rows, int gps, float lsb,
                           float levels, float qmax) {
  deepnet_stream_kernel<T, BPC, WORDS><<<grid, xbar::kNT, 0, st>>>(
      x, static_cast<const T*>(w), scale, acc, B, K, N, S, in_bits, rows,
      gps, lsb, levels, qmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(dim3 grid, cudaStream_t st, const int32_t* x,
                         const void* w, const float* scale,
                         unsigned long long* acc, int B, int K, int N, int S,
                         int in_bits, int bpc, int rows, int gps, float lsb,
                         float levels, float qmax) {
  const int words = (rows + 31) / 32;
#define DS_LAUNCH(BPC, W)                                                 \
  return launch_variant<T, BPC, W>(grid, st, x, w, scale, acc, B, K, N,  \
                                   S, in_bits, rows, gps, lsb, levels,   \
                                   qmax)
  if (bpc == 1) {
    if (words <= 1) DS_LAUNCH(1, 1);
    if (words <= 2) DS_LAUNCH(1, 2);
    if (words <= 4) DS_LAUNCH(1, 4);
    DS_LAUNCH(1, 8);
  }
  if (words <= 1) DS_LAUNCH(2, 1);
  if (words <= 2) DS_LAUNCH(2, 2);
  DS_LAUNCH(2, 4);
#undef DS_LAUNCH
}

}  // namespace

extern "C" {

// x (B, K) int32; w (K, N) float32 (w_dtype 0) or bfloat16 (w_dtype 1);
// w_scale (N,) f32; acc scratch (B, N) int64; out (B, N) f32.  All device
// pointers, contiguous.  Returns a cudaError_t (0 = launched).
int deepnet_stream_launch(const void* x, const void* w, const void* w_scale,
                          void* acc, void* out, int B, int K, int N,
                          int w_dtype, int w_bits, int in_bits,
                          int bits_per_cell, int rows, float lsb,
                          float levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || K <= 0 || rows <= 0 || w_bits < 1 ||
      w_bits > kMaxWBits || in_bits < 1 || in_bits > xbar::kMaxInBits ||
      levels > (1 << xbar::kMaxAdcBits) ||
      rows > xbar::max_rows(bits_per_cell) || (w_dtype != 0 && w_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int S = (w_bits + bits_per_cell - 1) / bits_per_cell;
  const float qmax = static_cast<float>((1 << w_bits) - 1);
  cudaError_t err = xbar::zero_codes(acc, B, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gps = 0;
  const dim3 grid = xbar::grid_for(B, N, (K + rows - 1) / rows, &gps);
  const int32_t* xp = static_cast<const int32_t*>(x);
  const float* sp = static_cast<const float*>(w_scale);
  unsigned long long* ap = static_cast<unsigned long long*>(acc);
  err = w_dtype == 0
            ? launch_typed<float>(grid, st, xp, w, sp, ap, B, K, N, S,
                                  in_bits, bits_per_cell, rows, gps, lsb,
                                  levels, qmax)
            : launch_typed<__nv_bfloat16>(grid, st, xp, w, sp, ap, B, K, N,
                                          S, in_bits, bits_per_cell, rows,
                                          gps, lsb, levels, qmax);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(xbar::codes_to_float(acc, out, B, N, lsb, st));
}

}  // extern "C"
