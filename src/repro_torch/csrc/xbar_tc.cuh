// The int8 tensor-core core of the crossbar MAC, shared by the two
// kernels that run it: crossbar_mac.cu (cell planes read from device
// memory) and deepnet_stream.cu (cell codes quantized from float weights
// inside the kernel).  Both differ only in where the B fragments come
// from; the A operand, the mma.sync stream, the ADC table and the integer
// shift-add below are one code, so both give the integers of the popcount
// MAC of xbar_mac.cuh.
//
// A block owns 16 batch rows and 32 columns per warp and walks row groups
// of `rows` rows (one ADC conversion each), staged as RP = 32 * KS rows
// (the extra rows carry zero input bits and zero codes):
//   * A: per group the block writes x's bit planes into shared memory as
//     int8 0/1, K-contiguous, read by ldmatrix.  M-tile t of a batch half
//     holds batch rows 0-7 at bit 2t and at bit 2t + 1, so a thread's
//     accumulators (rows lane/4 and lane/4 + 8) hold both bits of one
//     batch row and the signed shift-add runs in registers;
//   * B: bf[kk][j][h] is the k-quad (kk * 32 + 16 h + 4 t4 + 0..3) of the
//     warp's column 4 gr + j, which n8 tile j holds as its column gr;
//   * the ADC is the reference's, exactly (xbar::adc_code), evaluated once
//     per possible sum into a shared table with one copy per lane, so a
//     warp's 32 lookups never share a bank;
//   * codes are shift-added as integers, int32 per slice and int64 across
//     slices and groups, then added to a zeroed int64 buffer with atomics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "xbar_mac.cuh"

namespace xbar {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the signed weight of input bit p: MSB -2^(b-1), none past in_bits
__device__ __forceinline__ int bit_weight(int p, int in_bits) {
  return p < in_bits - 1 ? (1 << p) : (p == in_bits - 1 ? -(1 << p) : 0);
}

// The ADC code of every possible pre-ADC sum 0 .. maxsum, 32 copies side
// by side: lut[s * 32 + lane] is the code lane `lane` reads for sum s, so
// a warp's 32 lookups fall on 32 banks whatever the sums
__device__ __forceinline__ void fill_lut(int* lut, int maxsum, float leak,
                                         float lsb, float levels) {
  for (int s = threadIdx.x; s <= maxsum; s += blockDim.x) {
    const int c = adc_code(s, leak, lsb, levels);
    int4* dst = reinterpret_cast<int4*>(lut + s * 32);
#pragma unroll
    for (int l = 0; l < 8; ++l) dst[l] = make_int4(c, c, c, c);
  }
}

// shared memory: the ADC table, then the A bit planes (RP bytes a row)
__host__ __device__ inline int lut_bytes(int rows, int bpc) {
  return (rows * ((1 << bpc) - 1) + 1) * 32 * 4;
}
__host__ __device__ inline int a_rows(int nb, int in_bits) {
  return (nb > 8 ? 2 : 1) * ((in_bits + 1) / 2) * 16;
}
// 16-byte chunks of an A row are XOR-swizzled by the row's low bits
template <int KS> __device__ __forceinline__ constexpr int a_mask() {
  return (2 * KS < 8 ? 2 * KS : 8) - 1;
}

// x's bit planes of the rows [k0, k0 + kvalid) as int8 0/1 (rows past
// kvalid are 0): row m = (half * nbp + p / 2) * 16 + (p % 2) * 8 + b % 8
// for batch row b of half b / 8, K-contiguous, 16-byte chunks swizzled by
// row for ldmatrix
template <int KS, int THREADS>
__device__ __forceinline__ void build_a(int8_t* A, const int32_t* x, int K,
                                        int b0, int nb, int k0, int kvalid,
                                        int in_bits) {
  constexpr int RP = 32 * KS;
  constexpr int kQuads = RP / 4;
  constexpr int kAMask = a_mask<KS>();
  const int nch = nb > 8 ? 2 : 1;
  const int nbp = (in_bits + 1) / 2;
  const int32_t* xg = x + static_cast<size_t>(b0) * K + k0;
  const uint32_t umask = (1u << in_bits) - 1u;
  for (int i = threadIdx.x; i < nch * 8 * kQuads; i += THREADS) {
    const int b = i / kQuads;
    const int k = (i - b * kQuads) * 4;
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      u[e] = (b < nb && k + e < kvalid)
                 ? static_cast<uint32_t>(
                       xg[static_cast<size_t>(b) * K + k + e]) & umask
                 : 0u;
    const int half = b >> 3;
    for (int p = 0; p < 2 * nbp; ++p) {
      uint32_t w = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) w |= ((u[e] >> p) & 1u) << (8 * e);
      const int m = (half * nbp + (p >> 1)) * 16 + (p & 1) * 8 + (b & 7);
      *reinterpret_cast<uint32_t*>(
          A + m * RP + (((k >> 4) ^ (m & kAMask)) << 4) + (k & 15)) = w;
    }
  }
}

// One (slice, side) stage: every M-tile of A against the warp's B
// fragments of the group, each pre-ADC sum through the table, the codes
// weighted by their input bit and `sign` (+1 pos, -1 neg) into part
template <int KS>
__device__ __forceinline__ void adc_stage(const uint32_t (&bf)[KS][4][2],
                                          const int8_t* A, const int* lut,
                                          int sign, int nch, int in_bits,
                                          int (&part)[2][8]) {
  constexpr int RP = 32 * KS;
  constexpr int kAMask = a_mask<KS>();
  const int lane = threadIdx.x & 31;
  const int nbp = (in_bits + 1) / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half >= nch) break;
#pragma unroll 2
    for (int tb = 0; tb < nbp; ++tb) {
      const int mt = half * nbp + tb;
      int acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      const int arow = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t af[4];
        const int chunk = 2 * kk + (lane >> 4);
        ldsm_x4(af, A + arow * RP + ((chunk ^ (arow & kAMask)) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[j], af, bf[kk][j][0], bf[kk][j][1]);
      }
      // rows gr (bit 2 tb) and gr + 8 (bit 2 tb + 1) of batch row
      // 8 half + gr; c[e] is column 8 t4 + 4 (e & 1) + j of the warp's 32
      const int wlo = sign * bit_weight(2 * tb, in_bits);
      const int whi = sign * bit_weight(2 * tb + 1, in_bits);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[half][4 * (e & 1) + j] +=
              (e < 2 ? wlo : whi) * lut[acc[j][e] * 32 + lane];
    }
  }
}

// a slice's codes, both sides: shift-add into the int64 sums
__device__ __forceinline__ void shift_add(long long (&out)[2][8],
                                          int (&part)[2][8], int bpc,
                                          int slice) {
  const long long slcw = 1ll << (bpc * slice);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      out[h][q] += static_cast<long long>(part[h][q]) * slcw;
      part[h][q] = 0;
    }
}

// the block's sums into the (B, N) int64 buffer; col0 is the block's
// first column
__device__ __forceinline__ void add_codes(unsigned long long* acc,
                                          const long long (&out)[2][8],
                                          int b0, int nb, int N, int col0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t4 = lane & 3;
  const int nch = nb > 8 ? 2 : 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = h * 8 + gr;
    if (h < nch && b < nb) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = col0 + 32 * warp + 8 * t4 + q;
        if (col < N)
          atomicAdd(acc + static_cast<size_t>(b0 + b) * N + col,
                    static_cast<unsigned long long>(out[h][q]));
      }
    }
  }
}

}  // namespace xbar
