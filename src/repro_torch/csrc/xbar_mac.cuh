// The bit-serial crossbar MAC and its ADC.  The deepnet_stream kernel
// (cell codes quantized from float weights inside the kernel) runs the
// popcount MAC below; the crossbar_mac kernel (cell planes read from
// device memory, pre-ADC sums on the int8 tensor cores) shares its ADC
// (`adc_code`), launch grid (`grid_for`) and int64 code buffer
// (`zero_codes`, `codes_to_float`), and produces the same integer codes.
//
// One block owns a tile of kNT output columns and kBT batch rows and walks
// a range of row groups of `rows` rows (one ADC conversion each).  One
// thread owns one column.  Per row group:
//   * the block packs the group's input bit planes into shared memory
//     (bit r of xm[b][p][w] = bit p of x[b, k0 + 32 w + r], two's
//     complement; rows past the group's valid rows are 0);
//   * per slice s, the column's cell codes become 32-row bit masks in
//     registers (`Cells::masks`), and every input bit plane is
//     AND-popcounted against them: the popcount is the exact pre-ADC sum;
//   * each sum goes through the ADC table (the reference's rounding,
//     evaluated once per possible sum), and the codes are shift-added as
//     integers: int32 per slice, int64 across slices and groups.
// Integer accumulation is exact and order-free, so the row groups may be
// split across blocks, each adding its partial sums to a zeroed int64
// buffer with atomics; a last small kernel multiplies by the LSB.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xbar {

constexpr int kBT = 16;           // batch rows per block
constexpr int kNT = 128;          // output columns per block (= threads)
constexpr int kMaxInBits = 16;
constexpr int kMaxAdcBits = 15;   // codes x 2^(in_bits-1) stay in int32
constexpr int kMaxLut = 512;      // pre-ADC sums 0 .. rows * (2^bpc - 1)

// The reference's ADC code of one pre-ADC sum: correctly rounded divide,
// round half to even, clamp to [0, levels].
__device__ __forceinline__ int adc_code(int acc, float leak, float lsb,
                                        float levels) {
  float v = __fdiv_rn(__fadd_rn(static_cast<float>(acc), leak), lsb);
  v = rintf(v);
  v = fminf(fmaxf(v, 0.0f), levels);
  return static_cast<int>(v);
}

template <int WORDS>
struct Shared {
  uint32_t xm[kBT][kMaxInBits][WORDS];
  int adc_lut[kMaxLut];
};

// One column's cell bit masks for the rows [0, kvalid) of a group:
// mp[w * BPC + c] bit r = bit c of the positive cell code of row 32 w + r
// (likewise mn), with `code(row, pv, nv)` giving the two codes of a row.
template <int BPC, int WORDS, class Code>
__device__ __forceinline__ void build_masks(const Code& code, int kvalid,
                                            uint32_t* mp, uint32_t* mn) {
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    uint32_t pm[BPC], nm[BPC];
#pragma unroll
    for (int c = 0; c < BPC; ++c) pm[c] = nm[c] = 0u;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int row = 32 * w + r;
      if (row < kvalid) {
        uint32_t pv, nv;
        code(row, pv, nv);
#pragma unroll
        for (int c = 0; c < BPC; ++c) {
          pm[c] |= ((pv >> c) & 1u) << r;
          nm[c] |= ((nv >> c) & 1u) << r;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < BPC; ++c) {
      mp[w * BPC + c] = pm[c];
      mn[w * BPC + c] = nm[c];
    }
  }
}

// The MAC over row groups [g_begin, g_end) of `rows` rows (the last group
// may be ragged: rows past K read as 0).  `cells.begin_group(k0, kvalid)`
// runs once per group for in-range columns, then
// `cells.masks(s, k0, kvalid, mp, mn)` once per slice.  Adds the block's
// integer code sums into acc_out (B, N) with atomics.
template <int BPC, int WORDS, class Cells>
__device__ __forceinline__ void mac_groups(
    Cells& cells, Shared<WORDS>& sm, const int32_t* __restrict__ x,
    float leak, unsigned long long* __restrict__ acc_out, int B, int K,
    int N, int S, int in_bits, int rows, int g_begin, int g_end, float lsb,
    float levels) {
  const int col = blockIdx.x * kNT + threadIdx.x;
  const int b0 = blockIdx.z * kBT;
  const int nb = min(kBT, B - b0);
  const bool col_ok = col < N;
  const uint32_t umask = (1u << in_bits) - 1u;

  // the ADC code of every possible pre-ADC sum (ordered before its first
  // read by the __syncthreads at the top of the group loop)
  for (int a = threadIdx.x; a <= rows * ((1 << BPC) - 1); a += kNT)
    sm.adc_lut[a] = adc_code(a, leak, lsb, levels);

  long long out[kBT];
#pragma unroll
  for (int b = 0; b < kBT; ++b) out[b] = 0;

  for (int g = g_begin; g < g_end; ++g) {
    const int k0 = g * rows;
    const int kvalid = min(rows, K - k0);
    __syncthreads();  // the previous group's masks are no longer read
    for (int item = threadIdx.x; item < nb * WORDS; item += kNT) {
      const int b = item / WORDS;
      const int w = item % WORDS;
      const int32_t* xr = x + static_cast<size_t>(b0 + b) * K + k0;
      uint32_t u[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = 32 * w + r;
        u[r] = row < kvalid ? (static_cast<uint32_t>(xr[row]) & umask)
                            : 0u;
      }
      for (int p = 0; p < in_bits; ++p) {
        uint32_t m = 0;
#pragma unroll
        for (int r = 0; r < 32; ++r) m |= ((u[r] >> p) & 1u) << r;
        sm.xm[b][p][w] = m;
      }
    }
    __syncthreads();
    if (!col_ok) continue;
    cells.begin_group(k0, kvalid);
    for (int s = 0; s < S; ++s) {
      uint32_t mp[WORDS * BPC], mn[WORDS * BPC];
      cells.masks(s, k0, kvalid, mp, mn);
      int part[kBT];
#pragma unroll
      for (int b = 0; b < kBT; ++b) part[b] = 0;
      for (int p = 0; p < in_bits; ++p) {
        const int bitw = p < in_bits - 1 ? (1 << p) : -(1 << p);
#pragma unroll
        for (int b = 0; b < kBT; ++b) {
          if (b < nb) {
            int ap = 0, an = 0;
#pragma unroll
            for (int w = 0; w < WORDS; ++w) {
              const uint32_t xw = sm.xm[b][p][w];
#pragma unroll
              for (int c = 0; c < BPC; ++c) {
                ap += __popc(xw & mp[w * BPC + c]) << c;
                an += __popc(xw & mn[w * BPC + c]) << c;
              }
            }
            part[b] += bitw * (sm.adc_lut[ap] - sm.adc_lut[an]);
          }
        }
      }
      const long long slcw = 1ll << (BPC * s);
#pragma unroll
      for (int b = 0; b < kBT; ++b) out[b] += part[b] * slcw;
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int b = 0; b < kBT; ++b) {
    if (b < nb) {
      atomicAdd(acc_out + static_cast<size_t>(b0 + b) * N + col,
                static_cast<unsigned long long>(out[b]));
    }
  }
}

__global__ void codes_to_float_kernel(
    const unsigned long long* __restrict__ acc, float* __restrict__ out,
    size_t n, float lsb) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  if (i < n) {
    const long long v = static_cast<long long>(acc[i]);
    out[i] = static_cast<float>(static_cast<double>(v) *
                                static_cast<double>(lsb));
  }
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

// The launch grid (column tiles of `cols` columns, row-group splits,
// batch tiles) and the groups per split: the row groups are split across
// blocks until the grid covers the card about four times over.
inline dim3 grid_for(int B, int N, int n_groups, int* groups_per_split,
                     int cols = kNT) {
  const int gx = (N + cols - 1) / cols;
  const int gz = (B + kBT - 1) / kBT;
  const int target = 4 * sm_count();
  int splits = (target + gx * gz - 1) / (gx * gz);
  splits = splits < 1 ? 1 : (splits > n_groups ? n_groups : splits);
  const int gps = (n_groups + splits - 1) / splits;
  splits = (n_groups + gps - 1) / gps;
  *groups_per_split = gps;
  return dim3(gx, splits, gz);
}

// Zero the int64 code buffer before the MAC kernel, and convert it after.
inline cudaError_t zero_codes(void* acc, int B, int N, cudaStream_t st) {
  return cudaMemsetAsync(
      acc, 0, static_cast<size_t>(B) * N * sizeof(unsigned long long), st);
}

inline cudaError_t codes_to_float(const void* acc, void* out, int B, int N,
                                  float lsb, cudaStream_t st) {
  const size_t n = static_cast<size_t>(B) * N;
  const int threads = 256;
  codes_to_float_kernel<<<static_cast<unsigned>((n + threads - 1) /
                                                threads),
                          threads, 0, st>>>(
      static_cast<const unsigned long long*>(acc), static_cast<float*>(out),
      n, lsb);
  return cudaGetLastError();
}

// Largest rows-per-ADC group the MAC supports at a number of bits per
// cell: the ADC table must hold every pre-ADC sum.
inline int max_rows(int bits_per_cell) {
  return bits_per_cell == 1 ? 256 : (bits_per_cell == 2 ? 128 : 0);
}

}  // namespace xbar
