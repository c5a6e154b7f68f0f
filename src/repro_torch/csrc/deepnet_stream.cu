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
// __fdiv_rn, round half to even rintf, clamp), and the MMA, ADC table and
// integer shift-add are the crossbar MAC's own code (xbar_tc.cuh).
//
// What bounds it on the H100: it reads the weight once (4 bytes per weight
// in float32, 2 in bfloat16), against the MAC's 2 * S = 8 bytes of int8
// cell planes; its work per pre-ADC sum (mma, table lookup, shift-add) is
// the MAC's, which bounds the MAC kernel (PERF.md), plus one divide per
// weight per batch tile.
//
// What the design does about it (deepnet_stream_tc_kernel):
//   * the pre-ADC sums run on mma.sync.m16n8k32.s8 exactly as in the MAC:
//     M = batch rows x input bits, K = the row group, N = columns;
//   * per row group a block reads its weight tile once from device memory
//     (float4 / 4 x bf16 loads, a warp's lanes on 4 rows x 128 contiguous
//     bytes), quantizes every weight once, and writes the magnitudes
//     max(+-w_int, 0) as bytes into two code tiles in shared memory, one
//     per side, K-contiguous per column (stride rows + 4 bytes, so both
//     the writes and the fragment reads are free of bank conflicts).  No
//     transpose is needed: a fragment word is four k of one column, and
//     slice s of a side is (word >> bpc s) & digit in every byte at once;
//   * a byte holds 8 / bpc whole digits.  Past 8 weight bits (up to 24,
//     where rint(w / scale) is still an exact integer in float32) the
//     group runs in passes: pass p quantizes the tile again and keeps the
//     byte (magnitude >> 8 p) & 0xff, whose digits are slices 8 p / bpc
//     on; through 8 bits there is one pass, as before;
//   * there is no copy ring: a block's weight loads wait on device memory
//     while the other blocks on its SM (three at 128 rows) run their math;
//   * ragged K, N and B are masked here (rows past K and columns past N
//     quantize to code 0, rows past K carry no input bits); the caller pads
//     nothing.  Above 16 batch rows every batch tile quantizes its columns
//     again.
//
// The popcount kernel (deepnet_stream_kernel: one thread per column,
// AND-popcounts on bit masks, xbar_mac.cuh) stays as an independent
// integer witness of this one, behind its own entry
// deepnet_stream_popcount_launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the rounding must be exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_grant.cuh"
#include "xbar_mac.cuh"
#include "xbar_tc.cuh"

namespace {

// rint(w / scale) is an exact integer in float32 through 24 bits; the
// tensor-core kernel keeps one byte of each magnitude per pass
constexpr int kMaxWBits = 24;
constexpr int kSmemLimit = 232448;   // dynamic shared memory per block

__device__ __forceinline__ float load_w(const float* p) { return *p; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The raw bits of the weights w[r][c .. c + 3] of one row: a float4, or
// four bfloat16 in a uint2.  `vec`: the four are in N and 16-byte (float)
// or 8-byte (bf16) aligned; else the first `left` of them are in N.  The
// bits are turned into floats only after a whole batch of loads has been
// issued, so no load waits for the one before it.
__device__ __forceinline__ void load_raw(const float* p, bool vec, int left,
                                         float4& r) {
  if (vec) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    r.x = left > 0 ? p[0] : 0.0f;
    r.y = left > 1 ? p[1] : 0.0f;
    r.z = left > 2 ? p[2] : 0.0f;
    r.w = left > 3 ? p[3] : 0.0f;
  }
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, bool vec,
                                         int left, uint2& r) {
  if (vec) {
    r = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = j < left ? h[j] : 0u;
    r = make_uint2(u[0] | (u[1] << 16), u[2] | (u[3] << 16));
  }
}
__device__ __forceinline__ void zero_raw(float4& r) {
  r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void zero_raw(uint2& r) { r = make_uint2(0u, 0u); }
__device__ __forceinline__ void to_float(const float4& r, float (&v)[4]) {
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}
__device__ __forceinline__ void to_float(const uint2& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
template <typename T> struct Raw4 { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

struct StreamArgs {
  const int32_t* x;
  const void* w;
  const float* scale;
  unsigned long long* acc;
  int B, K, N, S, in_bits, bpc, rows, gps, aligned;
  float lsb, levels, qmax;
};

// shared memory: ADC table | A bit planes | pos codes | neg codes
template <int KS, int WARPS>
size_t tc_smem(const StreamArgs& a) {
  return static_cast<size_t>(xbar::lut_bytes(a.rows, a.bpc)) +
         static_cast<size_t>(
             xbar::a_rows(a.B < xbar::kBT ? a.B : xbar::kBT, a.in_bits)) *
             32 * KS +
         2 * static_cast<size_t>(32 * WARPS) * (32 * KS + 4);
}

// KS: k32 steps per staged group (rows rounded up to 32 * KS).  WARPS:
// warps per block, 32 columns each.
template <typename T, int KS, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) deepnet_stream_tc_kernel(
    StreamArgs a) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kCols = 32 * WARPS;      // columns per block
  constexpr int RP = 32 * KS;
  constexpr int kWords = RP / 4 + 1;     // words per column of a code tile
  constexpr int kItems = 2 * KS;         // k-quads a thread quantizes
  constexpr int kBatch = kItems < 4 ? kItems : 4;   // loaded together
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t4 = lane & 3;
  const int b0 = blockIdx.x * xbar::kBT;
  const int nb = min(xbar::kBT, a.B - b0);
  const int nch = nb > 8 ? 2 : 1;
  const int g_begin = blockIdx.y * a.gps;
  const int g_end = min((a.K + a.rows - 1) / a.rows, g_begin + a.gps);
  const int col0 = blockIdx.z * kCols;
  int* lut = reinterpret_cast<int*>(smem);
  int8_t* A =
      reinterpret_cast<int8_t*>(smem + xbar::lut_bytes(a.rows, a.bpc));
  // tile[side][column][word]: word q of a column holds its rows 4q..4q+3
  uint32_t* tile =
      reinterpret_cast<uint32_t*>(A + xbar::a_rows(nb, a.in_bits) * RP);

  xbar::fill_lut(lut, a.rows * ((1 << a.bpc) - 1), 0.0f, a.lsb, a.levels);

  // the quantizer's share: columns qc .. qc + 3 of the block, k-quads
  // 4 i + (lane / 8) of each group
  const int qc = 32 * warp + 4 * (lane & 7);
  const int kl = lane >> 3;
  const int left = a.N - col0 - qc;      // of the four columns, in N
  const bool vec = a.aligned && left >= 4;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = j < left ? a.scale[col0 + qc + j] : 1.0f;
  const T* wcol = static_cast<const T*>(a.w) + col0 + qc;
  const uint32_t digit = ((1u << a.bpc) - 1u) * 0x01010101u;
  const int per_pass = 8 / a.bpc;   // slices whose digits one byte holds

  long long out[2][8];
  int part[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) out[h][q] = 0, part[h][q] = 0;

  for (int g = g_begin; g < g_end; ++g) {
    const int k0 = g * a.rows;
    const int kvalid = min(a.rows, a.K - k0);
    __syncthreads();   // every warp is past the last group's A and tiles
    xbar::build_a<KS, kThreads>(A, a.x, a.K, b0, nb, k0, kvalid, a.in_bits);
#pragma unroll 1
    for (int s0 = 0; s0 < a.S; s0 += per_pass) {
      const int lo = a.bpc * s0;        // the pass's byte: magnitude bits
      if (s0 > 0) __syncthreads();      // every warp is past the last pass
      // program: quantize the group's weights into the code tiles
#pragma unroll 1
      for (int i0 = 0; i0 < kItems; i0 += kBatch) {
        typename Raw4<T>::type raw[kBatch][4];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * (4 * (i0 + i) + kl) + e;
            if (r < kvalid && left > 0)
              load_raw(wcol + static_cast<size_t>(k0 + r) * a.N, vec, left,
                       raw[i][e]);
            else
              zero_raw(raw[i][e]);
          }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int kq = 4 * (i0 + i) + kl;
          float v[4][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) to_float(raw[i][e], v[e]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t pw = 0u, nw = 0u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float q = rintf(__fdiv_rn(v[e][j], sc[j]));
              q = fminf(fmaxf(q, -a.qmax), a.qmax);
              const int c = static_cast<int>(q);
              pw |= ((static_cast<uint32_t>(c > 0 ? c : 0) >> lo) & 0xffu)
                    << (8 * e);
              nw |= ((static_cast<uint32_t>(c < 0 ? -c : 0) >> lo) & 0xffu)
                    << (8 * e);
            }
            tile[(qc + j) * kWords + kq] = pw;
            tile[(kCols + qc + j) * kWords + kq] = nw;
          }
        }
      }
      __syncthreads();
      // read: every (slice, side) of the pass against the same A
#pragma unroll 1
      for (int slice = s0; slice < min(a.S, s0 + per_pass); ++slice) {
        const int shift = a.bpc * slice - lo;
#pragma unroll 1
        for (int side = 0; side < 2; ++side) {
          const uint32_t* t =
              tile + (side * kCols + 32 * warp + 4 * gr) * kWords + t4;
          // bf[kk][j][h]: rows kk * 32 + 16 h + 4 t4 + 0..3 of column
          // 32 warp + 4 gr + j, the slice's digit in every byte
          uint32_t bf[KS][4][2];
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                bf[kk][j][h] =
                    (t[j * kWords + kk * 8 + 4 * h] >> shift) & digit;
          xbar::adc_stage<KS>(bf, A, lut, side ? -1 : 1, nch, a.in_bits,
                              part);
        }
        xbar::shift_add(out, part, a.bpc, slice);
      }
    }
  }
  xbar::add_codes(a.acc, out, b0, nb, a.N, col0);
}

// g: xbar::grid_for's grid at this launch's columns per block
template <typename T, int KS, int WARPS>
cudaError_t launch_tc(const StreamArgs& a, dim3 g, cudaStream_t st) {
  constexpr int kCols = 32 * WARPS;
  const size_t smem = tc_smem<KS, WARPS>(a);
  if (smem > static_cast<size_t>(kSmemLimit) ||
      g.x != static_cast<unsigned>((a.N + kCols - 1) / kCols))
    return cudaErrorInvalidValue;
  auto kernel = deepnet_stream_tc_kernel<T, KS, WARPS>;
  static smem::SmemGrant grant;
  cudaError_t err = grant.allow(kernel, smem);
  if (err != cudaSuccess) return err;
  // batch tiles fastest: they read the same weight tiles
  const dim3 grid(g.z, g.y, g.x);
  kernel<<<grid, 32 * WARPS, smem, st>>>(a);
  return cudaGetLastError();
}

// 4 warps (128 columns) per block up to 128 rows; at 256 rows 8 warps
// share one ADC table and bit-plane tile, where they fit
template <typename T>
cudaError_t launch_typed(StreamArgs a, cudaStream_t st) {
  const int n_groups = (a.K + a.rows - 1) / a.rows;
  const bool wide = a.rows > 128 && tc_smem<8, 8>(a) <= kSmemLimit;
  int gps = 0;
  const dim3 g = xbar::grid_for(a.B, a.N, n_groups, &gps, wide ? 256 : 128);
  a.gps = gps;
  if (a.rows <= 32) return launch_tc<T, 1, 4>(a, g, st);
  if (a.rows <= 64) return launch_tc<T, 2, 4>(a, g, st);
  if (a.rows <= 128) return launch_tc<T, 4, 4>(a, g, st);
  return wide ? launch_tc<T, 8, 8>(a, g, st) : launch_tc<T, 8, 4>(a, g, st);
}

// -- the witness: the popcount kernel ----------------------------------------

template <typename T, typename C, int BPC, int WORDS>
struct StreamCells {
  const T* __restrict__ w;
  int N;
  int col;
  float scale;
  float qmax;
  C (*tile)[xbar::kNT];  // [32 * WORDS][kNT] signed codes

  // the "program" step of the row group: quantize this column's rows
  __device__ __forceinline__ void begin_group(int k0, int kvalid) {
    const T* wc = w + static_cast<size_t>(k0) * N + col;
#pragma unroll 8
    for (int row = 0; row < kvalid; ++row) {
      const float v = load_w(wc + static_cast<size_t>(row) * N);
      float q = rintf(__fdiv_rn(v, scale));
      q = fminf(fmaxf(q, -qmax), qmax);
      tile[row][threadIdx.x] = static_cast<C>(q);
    }
  }

  __device__ __forceinline__ void masks(int s, int, int kvalid,
                                        uint32_t* mp, uint32_t* mn) const {
    const int shift = BPC * s;
    const int digit = (1 << BPC) - 1;
    C (*t)[xbar::kNT] = tile;
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

// the popcount kernel's code tile: a signed code C per (row, column),
// 16-bit through 15 weight bits (64 KB at 256 rows: dynamic shared
// memory), 32-bit past that (128 KB at 256 rows)
template <typename C, int WORDS>
constexpr size_t popcount_tile_bytes() {
  return static_cast<size_t>(32 * WORDS) * xbar::kNT * sizeof(C);
}

// One thread per column: the column's codes of a group become 32-row bit
// masks, AND-popcounted against every input bit plane (xbar_mac.cuh)
template <typename T, typename C, int BPC, int WORDS>
__global__ void __launch_bounds__(xbar::kNT) deepnet_stream_kernel(
    const int32_t* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ w_scale,
    unsigned long long* __restrict__ acc_out, int B, int K, int N, int S,
    int in_bits, int rows, int groups_per_split, float lsb, float levels,
    float qmax) {
  __shared__ xbar::Shared<WORDS> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  C (*tile)[xbar::kNT] = reinterpret_cast<C (*)[xbar::kNT]>(dyn);
  const int n_groups = (K + rows - 1) / rows;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  const int col = static_cast<int>(blockIdx.x) * xbar::kNT +
                  static_cast<int>(threadIdx.x);
  StreamCells<T, C, BPC, WORDS> cells{w, N, col,
                                   col < N ? w_scale[col] : 1.0f, qmax,
                                   tile};
  xbar::mac_groups<BPC, WORDS>(cells, sm, x, 0.0f, acc_out, B, K, N, S,
                               in_bits, rows, g_begin, g_end, lsb, levels);
}

template <typename T, typename C, int BPC, int WORDS>
cudaError_t launch_variant(dim3 grid, cudaStream_t st, const StreamArgs& a) {
  auto kernel = deepnet_stream_kernel<T, C, BPC, WORDS>;
  constexpr size_t smem = popcount_tile_bytes<C, WORDS>();
  static smem::SmemGrant grant;
  const cudaError_t err = grant.allow(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, xbar::kNT, smem, st>>>(
      a.x, static_cast<const T*>(a.w), a.scale, a.acc, a.B, a.K, a.N, a.S,
      a.in_bits, a.rows, a.gps, a.lsb, a.levels, a.qmax);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_popcount(StreamArgs a, cudaStream_t st) {
  int gps = 0;
  const dim3 grid =
      xbar::grid_for(a.B, a.N, (a.K + a.rows - 1) / a.rows, &gps);
  a.gps = gps;
  const int words = (a.rows + 31) / 32;
  if (a.bpc == 1) {
    if (words <= 1) return launch_variant<T, C, 1, 1>(grid, st, a);
    if (words <= 2) return launch_variant<T, C, 1, 2>(grid, st, a);
    if (words <= 4) return launch_variant<T, C, 1, 4>(grid, st, a);
    return launch_variant<T, C, 1, 8>(grid, st, a);
  }
  if (words <= 1) return launch_variant<T, C, 2, 1>(grid, st, a);
  if (words <= 2) return launch_variant<T, C, 2, 2>(grid, st, a);
  return launch_variant<T, C, 2, 4>(grid, st, a);
}

template <typename T>
cudaError_t launch_popcount(const StreamArgs& a, int w_bits,
                            cudaStream_t st) {
  return w_bits <= 15 ? launch_popcount<T, int16_t>(a, st)
                      : launch_popcount<T, int32_t>(a, st);
}

// Checks the arguments, zeroes the code buffer, launches the tensor-core
// kernel (or the popcount witness), converts the codes to floats
int launch_checked(const void* x, const void* w, const void* w_scale,
                   void* acc, void* out, int B, int K, int N, int w_dtype,
                   int w_bits, int in_bits, int bits_per_cell, int rows,
                   float lsb, float levels, void* stream, bool witness) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || K <= 0 || rows <= 0 || w_bits < 1 ||
      w_bits > kMaxWBits || in_bits < 1 || in_bits > xbar::kMaxInBits ||
      levels > (1 << xbar::kMaxAdcBits) ||
      rows > xbar::max_rows(bits_per_cell) || (w_dtype != 0 && w_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StreamArgs a{static_cast<const int32_t*>(x), w,
                     static_cast<const float*>(w_scale),
                     static_cast<unsigned long long*>(acc),
                     B, K, N, (w_bits + bits_per_cell - 1) / bits_per_cell,
                     in_bits, bits_per_cell, rows, 0,
                     N % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0 ? 1 : 0,
                     lsb, levels, static_cast<float>((1 << w_bits) - 1)};
  cudaError_t err = xbar::zero_codes(acc, B, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (witness)
    err = w_dtype == 0 ? launch_popcount<float>(a, w_bits, st)
                       : launch_popcount<__nv_bfloat16>(a, w_bits, st);
  else
    err = w_dtype == 0 ? launch_typed<float>(a, st)
                       : launch_typed<__nv_bfloat16>(a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(xbar::codes_to_float(acc, out, B, N, lsb, st));
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
  return launch_checked(x, w, w_scale, acc, out, B, K, N, w_dtype, w_bits,
                        in_bits, bits_per_cell, rows, lsb, levels, stream,
                        false);
}

// The same function on the popcount kernel: the tensor-core kernel's
// witness in the tests, never on a serving or streaming path.
int deepnet_stream_popcount_launch(const void* x, const void* w,
                                   const void* w_scale, void* acc, void* out,
                                   int B, int K, int N, int w_dtype,
                                   int w_bits, int in_bits,
                                   int bits_per_cell, int rows, float lsb,
                                   float levels, void* stream) {
  return launch_checked(x, w, w_scale, acc, out, B, K, N, w_dtype, w_bits,
                        in_bits, bits_per_cell, rows, lsb, levels, stream,
                        true);
}

}  // extern "C"
