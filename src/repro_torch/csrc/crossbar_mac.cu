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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the ADC rounding must be exact).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 16;           // batch rows per block
constexpr int kNT = 128;          // output columns per block (= threads)
constexpr int kMaxInBits = 16;
constexpr int kMaxAdcBits = 15;   // codes x 2^(in_bits-1) stay in int32
constexpr int kMaxLut = 512;      // pre-ADC sums 0 .. rows * (2^bpc - 1)

__device__ __forceinline__ int adc_code(int acc, float leak, float lsb,
                                        float levels) {
  float v = __fdiv_rn(__fadd_rn(static_cast<float>(acc), leak), lsb);
  v = rintf(v);
  v = fminf(fmaxf(v, 0.0f), levels);
  return static_cast<int>(v);
}

template <int BPC, int WORDS>
__global__ void __launch_bounds__(kNT) crossbar_mac_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ pos,
    const int8_t* __restrict__ neg, const float* __restrict__ leak_ptr,
    unsigned long long* __restrict__ acc_out, int B, int K, int N, int S,
    int in_bits, int rows, int groups_per_split, float lsb, float levels) {
  __shared__ uint32_t xm[kBT][kMaxInBits][WORDS];
  __shared__ int adc_lut[kMaxLut];
  const int col = blockIdx.x * kNT + threadIdx.x;
  const int b0 = blockIdx.z * kBT;
  const int nb = min(kBT, B - b0);
  const int n_groups = K / rows;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  const float leak = *leak_ptr;
  const bool col_ok = col < N;
  const size_t kn = static_cast<size_t>(K) * N;
  const uint32_t umask = (1u << in_bits) - 1u;

  // the ADC code of every possible pre-ADC sum (ordered before its first
  // read by the __syncthreads at the top of the group loop)
  for (int a = threadIdx.x; a <= rows * ((1 << BPC) - 1); a += kNT)
    adc_lut[a] = adc_code(a, leak, lsb, levels);

  long long out[kBT];
#pragma unroll
  for (int b = 0; b < kBT; ++b) out[b] = 0;

  for (int g = g_begin; g < g_end; ++g) {
    const int k0 = g * rows;
    __syncthreads();  // the previous group's masks are no longer read
    // pack this group's input bit planes: xm[b][p][w] bit r = bit p of
    // x[b0 + b, k0 + 32 w + r] (two's complement, rows past the group 0)
    for (int item = threadIdx.x; item < nb * WORDS; item += kNT) {
      const int b = item / WORDS;
      const int w = item % WORDS;
      const int32_t* xr = x + static_cast<size_t>(b0 + b) * K + k0;
      uint32_t u[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = 32 * w + r;
        u[r] = row < rows ? (static_cast<uint32_t>(xr[row]) & umask) : 0u;
      }
      for (int p = 0; p < in_bits; ++p) {
        uint32_t m = 0;
#pragma unroll
        for (int r = 0; r < 32; ++r) m |= ((u[r] >> p) & 1u) << r;
        xm[b][p][w] = m;
      }
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int s = 0; s < S; ++s) {
      // this column's cell codes of the group, as bit masks per cell bit
      uint32_t mp[WORDS * BPC], mn[WORDS * BPC];
      const int8_t* ps = pos + s * kn + static_cast<size_t>(k0) * N + col;
      const int8_t* ns = neg + s * kn + static_cast<size_t>(k0) * N + col;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        uint32_t pm[BPC], nm[BPC];
#pragma unroll
        for (int c = 0; c < BPC; ++c) pm[c] = nm[c] = 0u;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int row = 32 * w + r;
          if (row < rows) {
            const uint32_t pv = static_cast<uint8_t>(
                ps[static_cast<size_t>(row) * N]);
            const uint32_t nv = static_cast<uint8_t>(
                ns[static_cast<size_t>(row) * N]);
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
              const uint32_t xw = xm[b][p][w];
#pragma unroll
              for (int c = 0; c < BPC; ++c) {
                ap += __popc(xw & mp[w * BPC + c]) << c;
                an += __popc(xw & mn[w * BPC + c]) << c;
              }
            }
            part[b] += bitw * (adc_lut[ap] - adc_lut[an]);
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

template <int BPC, int WORDS>
cudaError_t launch_variant(dim3 grid, cudaStream_t st, const int32_t* x,
                           const int8_t* pos, const int8_t* neg,
                           const float* leak, unsigned long long* acc,
                           int B, int K, int N, int S, int in_bits,
                           int rows, int gps, float lsb, float levels) {
  crossbar_mac_kernel<BPC, WORDS><<<grid, kNT, 0, st>>>(
      x, pos, neg, leak, acc, B, K, N, S, in_bits, rows, gps, lsb, levels);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace

extern "C" {

// Largest rows-per-ADC group and bits per cell this build supports.
int crossbar_mac_max_rows(int bits_per_cell) {
  return bits_per_cell == 1 ? 256 : (bits_per_cell == 2 ? 128 : 0);
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
      in_bits < 1 || in_bits > kMaxInBits || levels > (1 << kMaxAdcBits) ||
      rows > crossbar_mac_max_rows(bits_per_cell)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(
      acc, 0, static_cast<size_t>(B) * N * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gx = (N + kNT - 1) / kNT;
  const int gz = (B + kBT - 1) / kBT;
  const int n_groups = K / rows;
  // split the row groups across blocks until the grid covers the card
  // about four times over (integer accumulation keeps this exact)
  const int target = 4 * sm_count();
  int splits = (target + gx * gz - 1) / (gx * gz);
  splits = splits < 1 ? 1 : (splits > n_groups ? n_groups : splits);
  const int gps = (n_groups + splits - 1) / splits;
  splits = (n_groups + gps - 1) / gps;
  const dim3 grid(gx, splits, gz);
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
  const size_t n = static_cast<size_t>(B) * N;
  const int threads = 256;
  codes_to_float_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                          threads, 0, st>>>(ap, static_cast<float*>(out), n,
                                            lsb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
