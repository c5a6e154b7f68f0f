// Bit-sliced differential crossbar MAC for NVIDIA Hopper (sm_90a), with
// the pre-ADC sums on the int8 tensor cores.
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
// LM head at S = 4), against 3.35 TB/s of device memory.
//
// What the design does about it:
//   * a pre-ADC sum is the dot of a 0/1 input bit plane with cell codes in
//     0 .. 2^bpc - 1 over one row group: an exact int8 x int8 -> int32
//     product in any order.  It runs as mma.sync.m16n8k32.s8 with
//     M = batch rows x input bits, K = the row group, N = columns; only the
//     ADC is nonlinear, and it acts on the int32 accumulators;
//   * a block owns 32 columns per warp (four warps; eight at 256 rows per
//     ADC) and 16 batch rows, and walks a range of row groups.  Plane
//     tiles of one group x the block's columns, one per (slice, side),
//     travel by 16-byte cp.async through a two-stage ring in shared
//     memory, so each plane byte is read from device memory once per block
//     while the previous tile computes.  The math, not the copies, sets
//     the time (measured: PERF.md), so the ring is kept small enough for
//     three blocks to share an SM;
//   * the A operand: per group the block writes x's bit planes into shared
//     memory as int8 0/1, K-contiguous, read by ldmatrix.  M-tile t of a
//     batch half holds batch rows 0-7 at bit 2t and at bit 2t + 1, so a
//     thread's accumulators (rows lane/4 and lane/4 + 8) hold both bits of
//     one batch row and the signed shift-add runs in registers;
//   * the B operand: the planes are N-contiguous and the int8 mma wants
//     K-contiguous quads, so a thread reads four 4-byte words of four rows
//     (one per k) and transposes them with __byte_perm into the k-quads of
//     four columns; each of the warp's four n8 tiles takes one of them.
//     Staged rows are XOR-swizzled in 16-byte chunks so those reads are
//     free of bank conflicts.  A warp keeps a whole group's B fragments in
//     registers and runs every M-tile against them;
//   * the ADC is the reference's, exactly: lsb = (float)((double)full_scale
//     / levels) from the host, code = clip(rintf(__fdiv_rn(a + leak, lsb)),
//     0, levels) (xbar::adc_code), evaluated once per possible sum into a
//     shared table with one copy per lane, so a warp's 32 lookups never
//     share a bank;
//   * the codes are shift-added as integers, int32 per slice and int64
//     across slices and groups, the same integers as the popcount MAC of
//     xbar_mac.cuh (kept as deepnet_stream.cu's witness), so the outputs are
//     bitwise equal to it.  Integer sums are order-free, so row groups may
//     be split across blocks (int64 atomics into a zeroed buffer) when the
//     column tiles do not fill the card; a last kernel multiplies by lsb;
//   * `leak` (the write plane's common-mode pre-ADC offset) is read from a
//     device tensor, so one build serves leak = 0 and leak != 0.
// The A operand, the mma.sync stream, the ADC table and the shift-add are
// xbar_tc.cuh's, shared with deepnet_stream.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the ADC rounding must be exact).
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_grant.cuh"
#include "xbar_tc.cuh"

namespace {

using xbar::smem_addr;

constexpr int kBT = 16;                  // batch rows per block
constexpr int kStages = 2;               // ring depth (see the launch)
constexpr int kSmemLimit = 232448;       // dynamic shared memory per block
constexpr int kTableThreads = 128;
static_assert(kBT == xbar::kBT, "grid_for tiles the batch by xbar::kBT");

// 16 bytes global -> shared; with full == false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// w[i] holds bytes (row i, columns 0..3); v[j] gets bytes (rows 0..3,
// column j): a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&v)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(t0, t1, 0x5410);
  v[1] = __byte_perm(t0, t1, 0x7632);
  v[2] = __byte_perm(t2, t3, 0x5410);
  v[3] = __byte_perm(t2, t3, 0x7632);
}

// chunk c (16 bytes) of staged plane row r sits at chunk c ^ swizzle: rows
// 4 t4 + i of a warp's fragment reads then fall on distinct banks
__device__ __forceinline__ int plane_chunk(int r, int c) {
  return c ^ (((r >> 2) & 3) << 1);
}

// The MAC's ADC table as a block builds it, copied out (for the tests)
__global__ void adc_table_kernel(const float* __restrict__ leak,
                                 int* __restrict__ out, int maxsum, float lsb,
                                 float levels) {
  extern __shared__ __align__(16) int table[];
  xbar::fill_lut(table, maxsum, *leak, lsb, levels);
  __syncthreads();
  for (int i = threadIdx.x; i < (maxsum + 1) * 32; i += blockDim.x)
    out[i] = table[i];
}

struct MacArgs {
  const int32_t* x;
  const int8_t* pos;
  const int8_t* neg;
  const float* leak;
  unsigned long long* acc;
  int B, K, N, S, in_bits, bpc, rows, gps, aligned;
  float lsb, levels;
};

// KS: k32 steps per staged group (rows rounded up to 32 * KS; the extra
// rows carry zero input bits).  WARPS: warps per block, 32 columns each.
template <int KS, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) crossbar_mac_tc_kernel(
    MacArgs a) {
  constexpr int STAGES = kStages;
  constexpr int kThreads = 32 * WARPS;
  constexpr int kCols = 32 * WARPS;      // columns per block
  constexpr int kChunks = kCols / 16;    // 16-byte chunks per staged row
  constexpr int RP = 32 * KS;
  constexpr int kStage = RP * kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t4 = lane & 3;
  const int b0 = blockIdx.x * kBT;
  const int nb = min(kBT, a.B - b0);
  const int nch = nb > 8 ? 2 : 1;
  const int g_begin = blockIdx.y * a.gps;
  const int g_end = min(a.K / a.rows, g_begin + a.gps);
  const int col0 = blockIdx.z * kCols;
  const int maxsum = a.rows * ((1 << a.bpc) - 1);
  int* lut = reinterpret_cast<int*>(smem);
  int8_t* A =
      reinterpret_cast<int8_t*>(smem + xbar::lut_bytes(a.rows, a.bpc));
  int8_t* ring = A + xbar::a_rows(nb, a.in_bits) * RP;

  xbar::fill_lut(lut, maxsum, *a.leak, a.lsb, a.levels);

  const int n_stage = (g_end - g_begin) * a.S * 2;
  // stage it: group g_begin + (it / 2) / S, slice (it / 2) % S, side it % 2
  auto issue = [&](int it) {
    if (it < n_stage) {
      const int s = (it >> 1) % a.S;
      const int g = g_begin + (it >> 1) / a.S;
      const int8_t* plane =
          ((it & 1) ? a.neg : a.pos) +
          (static_cast<size_t>(s) * a.K + static_cast<size_t>(g) * a.rows) *
              a.N + col0;
      int8_t* dst = ring + (it % STAGES) * kStage;
      for (int i = threadIdx.x; i < a.rows * kChunks; i += kThreads) {
        const int r = i / kChunks;
        const int c = i % kChunks;
        int8_t* d = dst + r * kCols + (plane_chunk(r, c) << 4);
        const int8_t* src = plane + static_cast<size_t>(r) * a.N + c * 16;
        const int left = a.N - col0 - c * 16;  // columns of the chunk in N
        if (a.aligned) {
          cp_async16(d, left > 0 ? src : plane, left > 0);
        } else {  // ragged N: byte loads, zero past N
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (e < left)
              w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                           << (8 * (e & 3));
          *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  long long out[2][8];
  int part[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) out[h][q] = 0, part[h][q] = 0;

  for (int it = 0; it < n_stage; ++it) {
    const int side = it & 1;
    const int slice = (it >> 1) % a.S;
    // a new group: every warp is past the last stage's reads of A
    if (side == 0 && slice == 0)
      xbar::build_a<KS, kThreads>(A, a.x, a.K, b0, nb,
                                  (g_begin + (it >> 1) / a.S) * a.rows,
                                  a.rows, a.in_bits);
    issue(it + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int8_t* st = ring + (it % STAGES) * kStage;
    // this warp's B fragments for the whole group: bf[kk][j][h] is the
    // k-quad (kk * 32 + 16 h + 4 t4 + 0..3) of column 32 warp + 4 gr + j,
    // which n8 tile j holds as its column gr
    uint32_t bf[KS][4][2];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kk * 32 + h * 16 + 4 * t4 + i;
          w[i] = *reinterpret_cast<const uint32_t*>(
              st + r * kCols + (plane_chunk(r, 2 * warp + (gr >> 2)) << 4) +
              (gr & 3) * 4);
        }
        transpose4(w, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[kk][j][h] = v[j];
      }
    xbar::adc_stage<KS>(bf, A, lut, side ? -1 : 1, nch, a.in_bits, part);
    if (side == 1) xbar::shift_add(out, part, a.bpc, slice);
    __syncthreads();  // the slot and A are rewritten after this
  }
  cp_async_wait<0>();
  xbar::add_codes(a.acc, out, b0, nb, a.N, col0);
}

// g: xbar::grid_for's grid at this launch's kCols columns per block
template <int KS, int WARPS>
cudaError_t launch_tc(const MacArgs& a, dim3 g, cudaStream_t st) {
  constexpr int kCols = 32 * WARPS;
  const size_t smem =
      static_cast<size_t>(xbar::lut_bytes(a.rows, a.bpc)) +
      static_cast<size_t>(xbar::a_rows(a.B < kBT ? a.B : kBT, a.in_bits)) *
          32 * KS +
      static_cast<size_t>(kStages) * 32 * KS * kCols;
  if (smem > static_cast<size_t>(kSmemLimit) ||
      g.x != static_cast<unsigned>((a.N + kCols - 1) / kCols))
    return cudaErrorInvalidValue;
  auto kernel = crossbar_mac_tc_kernel<KS, WARPS>;
  static smem::SmemGrant grant;
  cudaError_t err = grant.allow(kernel, smem);
  if (err != cudaSuccess) return err;
  // batch tiles fastest: they read the same plane tiles
  const dim3 grid(g.z, g.y, g.x);
  kernel<<<grid, 32 * WARPS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest rows-per-ADC group and bits per cell this build supports.
int crossbar_mac_max_rows(int bits_per_cell) {
  return xbar::max_rows(bits_per_cell);
}

// The ADC table the MAC kernel reads at this geometry: out ((rows *
// (2^bpc - 1) + 1) x 32) int32, row s holding 32 copies of the code of sum
// s.  Returns a cudaError_t (0 = launched).
int crossbar_mac_adc_table(const void* leak, void* out, int rows,
                           int bits_per_cell, float lsb, float levels,
                           void* stream) {
  if (rows <= 0 || rows > crossbar_mac_max_rows(bits_per_cell))
    return static_cast<int>(cudaErrorInvalidValue);
  const int maxsum = rows * ((1 << bits_per_cell) - 1);
  const int smem = xbar::lut_bytes(rows, bits_per_cell);
  static smem::SmemGrant grant;
  cudaError_t err = grant.allow(adc_table_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  adc_table_kernel<<<1, kTableThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(leak), static_cast<int*>(out), maxsum, lsb,
      levels);
  return static_cast<int>(cudaGetLastError());
}

// x (B, K) int32; pos/neg (S, K, N) int8; leak (1,) f32; acc scratch
// (B, N) int64; out (B, N) f32.  All device pointers, contiguous.
// Returns a cudaError_t (0 = launched).
int crossbar_mac_launch(const void* x, const void* pos, const void* neg,
                        const void* leak, void* acc, void* out, int B, int K,
                        int N, int S, int in_bits, int bits_per_cell,
                        int rows, float lsb, float levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || K <= 0 || S <= 0 || rows <= 0 || K % rows != 0 ||
      in_bits < 1 || in_bits > xbar::kMaxInBits ||
      levels > (1 << xbar::kMaxAdcBits) ||
      rows > crossbar_mac_max_rows(bits_per_cell)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = xbar::zero_codes(acc, B, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 4 warps (128 columns) per block up to 128 rows, 8 (256) beyond
  const int cols = rows <= 128 ? 128 : 256;
  int gps = 0;
  const dim3 g = xbar::grid_for(B, N, K / rows, &gps, cols);
  const bool aligned = N % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(pos) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(neg) % 16 == 0;
  const MacArgs a{static_cast<const int32_t*>(x),
                  static_cast<const int8_t*>(pos),
                  static_cast<const int8_t*>(neg),
                  static_cast<const float*>(leak),
                  static_cast<unsigned long long*>(acc),
                  B, K, N, S, in_bits, bits_per_cell, rows, gps,
                  aligned ? 1 : 0, lsb, levels};
  // Measured on the H100 (head, B 16): a two-stage ring beats four, as
  // the smaller block lets three blocks share an SM (the math, not the
  // copies, sets the time); at 256 rows a block of eight warps shares one
  // ADC table and bit-plane tile over 256 columns.
  if (rows <= 32) err = launch_tc<1, 4>(a, g, st);
  else if (rows <= 64) err = launch_tc<2, 4>(a, g, st);
  else if (rows <= 128) err = launch_tc<4, 4>(a, g, st);
  else err = launch_tc<8, 8>(a, g, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(xbar::codes_to_float(acc, out, B, N, lsb, st));
}

}  // extern "C"
