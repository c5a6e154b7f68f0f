// Bit-sliced differential crossbar MAC for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `crossbar_mac` of
// src/repro/kernels/crossbar_mac/kernel.py (body `_kernel`).
//
// What it computes, for x_int (B, K) int32 and cell planes pos/neg
// (S, K, N) int8, per output (b, n):
//
//   y[b, n] = sum_groups sum_p sum_s bitw[p] * base^s
//             * ( ADC(bits_p(x[b, g]) . pos[s, g, n] + leak)
//               - ADC(bits_p(x[b, g]) . neg[s, g, n] + leak) )
//
// with row groups g of `rows_per_adc` rows, bit p of the two's-complement
// input (MSB weight -2^(b-1)), and ADC(a) = clip(rint(a / lsb), 0, levels)
// * lsb.  The result is returned in code units (the caller applies the
// input and weight scales), exactly as the TPU kernel returns it.
//
// What bounds it on the H100: at decode (B = 16 tokens) the kernel reads
// every cell plane once, 2 * S * K * N bytes (3.1 GB for the 2560 x 152064
// LM head at S = 4), against 3.35 TB/s of device memory.  The arithmetic
// is bit-level: a pre-ADC sum is a popcount of (input bit plane AND cell
// bit plane), which is exact integer arithmetic.
//
// What the design does about it:
//   * one thread owns one output column of a 128-column tile and up to 16
//     batch rows; it reads each of its column's cell codes from device
//     memory exactly once per row group and slice (neighbouring threads
//     read neighbouring bytes, so a warp's load is one 32-byte sector),
//     packs them into 32-row bit masks held in registers, and then loops
//     over all in_bits input bit planes against those registers -- the
//     planes are never re-read per bit;
//   * the input bit planes of a row group are packed once per block into
//     shared memory and read as broadcasts;
//   * the ADC is the reference's, exactly: the host passes
//     lsb = (float)((double)full_scale / levels), and the code of a
//     pre-ADC sum a is clip(rintf(__fdiv_rn(a + leak, lsb)), 0, levels)
//     (correctly rounded divide, round half to even).  A pre-ADC sum is
//     an integer in [0, rows * (2^bpc - 1)], so each block evaluates that
//     formula once per possible sum into a shared-memory table and every
//     conversion is one table read — the divide, not the bytes, bounded
//     the first version of this kernel;
//   * the signed shift-add accumulates integer codes (int32 per slice,
//     int64 across slices and groups), which is exact and independent of
//     order, so the row-group axis may be split across blocks (integer
//     atomics into a zeroed int64 buffer) to fill the card when N is
//     small; a second small kernel multiplies by lsb.
//   * `leak` (the write plane's common-mode pre-ADC offset) is read from a
//     device tensor, so one build serves leak = 0 and leak != 0.
//
// The MAC and ADC live in xbar_mac.cuh, shared with deepnet_stream.cu;
// this file supplies the cell codes from the int8 planes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the ADC rounding must be exact).
#include <cuda_runtime.h>
#include <stdint.h>

#include "xbar_mac.cuh"

namespace {

// One column's cell codes come straight from the int8 planes in device
// memory: each code is read once per row group and slice.
template <int BPC, int WORDS>
struct PlaneCells {
  const int8_t* __restrict__ pos;
  const int8_t* __restrict__ neg;
  size_t kn;
  int N;
  int col;

  __device__ __forceinline__ void begin_group(int, int) {}

  __device__ __forceinline__ void masks(int s, int k0, int kvalid,
                                        uint32_t* mp, uint32_t* mn) const {
    const size_t off = s * kn + static_cast<size_t>(k0) * N + col;
    const int8_t* ps = pos + off;
    const int8_t* ns = neg + off;
    const int n = N;
    xbar::build_masks<BPC, WORDS>(
        [ps, ns, n](int row, uint32_t& pv, uint32_t& nv) {
          pv = static_cast<uint8_t>(ps[static_cast<size_t>(row) * n]);
          nv = static_cast<uint8_t>(ns[static_cast<size_t>(row) * n]);
        },
        kvalid, mp, mn);
  }
};

template <int BPC, int WORDS>
__global__ void __launch_bounds__(xbar::kNT) crossbar_mac_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ pos,
    const int8_t* __restrict__ neg, const float* __restrict__ leak_ptr,
    unsigned long long* __restrict__ acc_out, int B, int K, int N, int S,
    int in_bits, int rows, int groups_per_split, float lsb, float levels) {
  __shared__ xbar::Shared<WORDS> sm;
  const int n_groups = K / rows;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  PlaneCells<BPC, WORDS> cells{pos, neg, static_cast<size_t>(K) * N, N,
                               static_cast<int>(blockIdx.x) * xbar::kNT +
                                   static_cast<int>(threadIdx.x)};
  xbar::mac_groups<BPC, WORDS>(cells, sm, x, *leak_ptr, acc_out, B, K, N,
                               S, in_bits, rows, g_begin, g_end, lsb,
                               levels);
}

template <int BPC, int WORDS>
cudaError_t launch_variant(dim3 grid, cudaStream_t st, const int32_t* x,
                           const int8_t* pos, const int8_t* neg,
                           const float* leak, unsigned long long* acc,
                           int B, int K, int N, int S, int in_bits,
                           int rows, int gps, float lsb, float levels) {
  crossbar_mac_kernel<BPC, WORDS><<<grid, xbar::kNT, 0, st>>>(
      x, pos, neg, leak, acc, B, K, N, S, in_bits, rows, gps, lsb, levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest rows-per-ADC group and bits per cell this build supports.
int crossbar_mac_max_rows(int bits_per_cell) {
  return xbar::max_rows(bits_per_cell);
}

// x (B, K) int32; pos/neg (S, K, N) int8; leak (1,) f32; acc scratch
// (B, N) int64; out (B, N) f32.  All device pointers, contiguous.
// Returns a cudaError_t (0 = launched).
int crossbar_mac_launch(const void* x, const void* pos, const void* neg,
                        const void* leak, void* acc, void* out, int B, int K,
                        int N, int S, int in_bits, int bits_per_cell,
                        int rows, float lsb, float levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || K <= 0 || rows <= 0 || K % rows != 0 ||
      in_bits < 1 || in_bits > xbar::kMaxInBits ||
      levels > (1 << xbar::kMaxAdcBits) ||
      rows > crossbar_mac_max_rows(bits_per_cell)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = xbar::zero_codes(acc, B, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gps = 0;
  const dim3 grid = xbar::grid_for(B, N, K / rows, &gps);
  const int words = (rows + 31) / 32;
  const int32_t* xp = static_cast<const int32_t*>(x);
  const int8_t* pp = static_cast<const int8_t*>(pos);
  const int8_t* np_ = static_cast<const int8_t*>(neg);
  const float* lp = static_cast<const float*>(leak);
  unsigned long long* ap = static_cast<unsigned long long*>(acc);
#define XB_LAUNCH(BPC, W)                                                  \
  err = launch_variant<BPC, W>(grid, st, xp, pp, np_, lp, ap, B, K, N, S,  \
                               in_bits, rows, gps, lsb, levels)
  if (bits_per_cell == 1) {
    if (words <= 1) XB_LAUNCH(1, 1);
    else if (words <= 2) XB_LAUNCH(1, 2);
    else if (words <= 4) XB_LAUNCH(1, 4);
    else XB_LAUNCH(1, 8);
  } else {
    if (words <= 1) XB_LAUNCH(2, 1);
    else if (words <= 2) XB_LAUNCH(2, 2);
    else XB_LAUNCH(2, 4);
  }
#undef XB_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(xbar::codes_to_float(acc, out, B, N, lsb, st));
}

}  // extern "C"
