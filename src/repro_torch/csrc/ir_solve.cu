// Damped-Jacobi sweeps of the crossbar IR-drop network for NVIDIA Hopper
// (sm_90a), all sweeps of a call in one launch.
//
// Replaces the TPU kernel `jacobi_sweeps` of
// src/repro/kernels/ir_solve/kernel.py (body `_kernel`), which keeps the
// whole tile in VMEM and runs every sweep of the call on it.
//
// What it computes: `sweeps` damped-Jacobi updates of the row-wire and
// column-wire node voltages of an n x m planar crossbar (core/ir_drop.py):
//
//   v_row' = v_row + omega * ((g_w west + east_g east + g v_col) / den_r
//                             - v_row)
//   v_col' = v_col + omega * ((north_g north + g_w south + g v_row') / den_c
//                             - v_col)
//
// with den_r = g_w + east_g + g, den_c = north_g + g_w + g, east_g = 0 on
// the last column and north_g = 0 on the first row (the source sits west of
// column 0, the sense ground south of the last row).
//
// What bounds it on the H100: not bytes.  The call reads g, both fields
// and the sources once and writes both fields once (5 MB at 512 x 512,
// under 2 us at 3.35 TB/s), but its `sweeps` updates form a dependent
// chain: each sweep needs the last one's values of the neighbouring
// nodes.  So a call costs `sweeps` x (the busiest band's update, two
// correctly rounded divides deep, plus one exchange of edge rows between
// neighbouring SMs), a latency, which the design shortens.
//
// The design:
// * Row bands.  The n rows are split into P bands of consecutive whole
//   rows (band b holds rows [b n / P, (b + 1) n / P)), one CTA each.  The
//   row update at (i, j) needs only row i (its west and east neighbours,
//   or the source at j = 0); the column update needs the NEW v_row at
//   (i, j) and the OLD v_col at rows i - 1 and i + 1.  So a band needs,
//   per sweep, only the old v_col edge row of the band above and of the
//   band below.
// * Nodes stay on chip.  Each thread owns the nodes t, t + T, ... of its
//   band (K of them, K a template parameter) and keeps their g, both
//   denominators (formed once, as the plain version forms them), both
//   voltages and their shared-memory slots in registers for the whole
//   call: the inputs are read once and the two outputs written once.
//   Shared memory holds each sweep's old v_row, with a ghost column each
//   side (the source west of column 0, 0 east of the last), and old
//   v_col, with a ghost row above and below (0 beyond the network's first
//   and last rows), so an update reads its four neighbours without a
//   branch.  Each sweep computes every new value in registers from old
//   values only, barriers, and writes them back: Jacobi, never
//   Gauss-Seidel.  The row updates and the inner rows' column updates run
//   first, while the neighbours' edge rows are in flight; the edge rows'
//   column updates wait for them.
// * Edge rows go to the neighbours only, with no grid-wide barrier and no
//   memory fence.  A plan of more than one band is one cooperative launch
//   of at most one CTA per SM (co-residency is guaranteed, or the launch
//   fails).  Edge rows go to a buffer in L2, double-buffered by sweep
//   parity, each value beside the number of the sweep that made it in one
//   64-bit word: the receiver polls the word until the number is the one
//   it waits for, so the value is its own flag.  The buffer is zeroed by a
//   memset on the same stream before the launch (no sweep is numbered 0).
//   Parity is enough: a band sends sweep s + 2's rows only after it has
//   used its neighbours' sweep s + 1 rows, which they sent after using its
//   sweep s rows.  A plan of one band (10 x 10, 12 x 8) exchanges nothing:
//   it is a plain launch with no buffer and no memset.  (A second
//   exchange, st.async into the neighbour's shared memory within one
//   thread-block cluster of at most 16 bands, was built and measured on
//   the H100: it tied at one band and was slower at 128 x 128 and
//   256 x 256, and a cluster cannot hold 512 x 512, so it went; PERF.md.)
// * Sweep 0 reads its neighbours' rows from the input v_col directly, and
//   the last sweep's edge rows are not sent.
//
// Arithmetic: every operation is an explicitly rounded float32 intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), in the plain version's
// order, with den_r and den_c formed as the plain version forms them, so
// nvcc cannot contract a multiply-add into an FMA and the result equals
// the plain PyTorch version bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (no fast-math).
#include <cuda_runtime.h>

#include "smem_grant.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// A wait that outlasts this many SM cycles (~20 s) traps: a fault surfaces
// as a launch error, never as a hung card.
constexpr long long kSpinCycles = 1LL << 35;

// Floats of one band's shared memory (all of it: the kernel declares no
// static shared memory): v_row of `rows` x m nodes with a ghost column
// each side, and v_col with a ghost row above and below.
__host__ __device__ constexpr size_t band_smem_floats(int rows, int m) {
  return static_cast<size_t>(rows) * (m + 2) +
         static_cast<size_t>(rows + 2) * m;
}

// -- the exchange: each value beside its sweep number in one word, in L2 --

__device__ __forceinline__ void put_tagged(unsigned long long* p, float v,
                                           unsigned tag) {
  const unsigned long long w =
      static_cast<unsigned long long>(tag) << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ float get_tagged(const unsigned long long* p,
                                            unsigned tag) {
  const long long start = clock64();
  while (true) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
                 : "=l"(w)
                 : "l"(p)
                 : "memory");
    if (static_cast<unsigned>(w >> 32) == tag)
      return __uint_as_float(static_cast<unsigned>(w));
    if (clock64() - start > kSpinCycles) __trap();
  }
}

// One node's damped update, the plain version's operations in its order:
// v + omega * ((g_w a + g_w b + g v_other) / den - v).  In the plain
// version the second term of a row node is east_g * east_v and the first
// of a column node north_g * north_v; where those conductances are 0 (the
// last column, the first row) the voltage is 0 too, and g_w * 0 is the
// same +0 as 0 * 0, so a zero ghost cell stands in for both.
__device__ __forceinline__ float node_update(float v, float gv, float other,
                                            float a, float b, float den,
                                            float g_w, float omega) {
  const float num = __fadd_rn(__fadd_rn(__fmul_rn(g_w, a), __fmul_rn(g_w, b)),
                              __fmul_rn(gv, other));
  return __fadd_rn(v, __fmul_rn(omega, __fsub_rn(__fdiv_rn(num, den), v)));
}

// halo[parity][band][top, bottom][m]: the edge rows of v_col
__device__ __forceinline__ unsigned long long* edge_row(
    unsigned long long* halo, int parity, int bands, int band, int bottom,
    int m) {
  return halo +
         (static_cast<size_t>(parity * bands + band) * 2 + bottom) * m;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
    jacobi_band_kernel(const float* __restrict__ g,
                       const float* __restrict__ v_in,
                       const float* __restrict__ v_row,
                       const float* __restrict__ v_col,
                       float* __restrict__ out_row,
                       float* __restrict__ out_col,
                       unsigned long long* halo, int n, int m, int bands,
                       int rows_max, float g_w, float omega, int sweeps) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int r0 = static_cast<int>(static_cast<long long>(b) * n / bands);
  const int r1 =
      static_cast<int>(static_cast<long long>(b + 1) * n / bands);
  const int rows = r1 - r0;
  const int nodes = rows * m;
  const int last = nodes - m;  // the band's last row starts here
  // v_row with a ghost column each side (the source west of column 0, 0
  // east of column m - 1), row stride m + 2; v_col with a ghost row above
  // and below (0 beyond the network's first and last rows; a neighbour
  // band's rows come from the exchange instead)
  float* s_vr = smem;
  float* s_vc = s_vr + rows_max * (m + 2);
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const size_t base = static_cast<size_t>(r0) * m;
  const bool has_north = b > 0;
  const bool has_south = b < bands - 1;

  // node k of this thread is q = t + k T of the band (row q / m); its g,
  // both denominators, both voltages and its v_row slot stay in registers
  float gk[K], dr[K], dc[K], vr[K], vc[K];
  int ar[K];
  unsigned edge = 0;  // bit k: node k needs a neighbour band's row
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = t + k * T;
    if (q < nodes) {
      const int li = q / m;
      const int j = q - li * m;
      const float east_g = j < m - 1 ? g_w : 0.0f;
      const float north_g = r0 + li > 0 ? g_w : 0.0f;
      gk[k] = g[base + q];
      dr[k] = __fadd_rn(__fadd_rn(g_w, east_g), gk[k]);
      dc[k] = __fadd_rn(__fadd_rn(north_g, g_w), gk[k]);
      vr[k] = v_row[base + q];
      vc[k] = v_col[base + q];
      ar[k] = q + 2 * li + 1;
      s_vr[ar[k]] = vr[k];
      s_vc[m + q] = vc[k];
      if ((q < m && has_north) || (q >= last && has_south)) edge |= 1u << k;
    }
  }
  for (int i = t; i < rows; i += T) {
    s_vr[i * (m + 2)] = v_in[r0 + i];
    s_vr[i * (m + 2) + m + 1] = 0.0f;
  }
  for (int j = t; j < m; j += T) {
    s_vc[j] = 0.0f;
    s_vc[(rows + 1) * m + j] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < sweeps; ++s) {
    // every row update, and the column updates that need no neighbour
    // band: these overlap the neighbours' edge rows in flight
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + k * T;
      if (q < nodes) {
        vr[k] = node_update(vr[k], gk[k], vc[k], s_vr[ar[k] - 1],
                            s_vr[ar[k] + 1], dr[k], g_w, omega);
        if (!(edge >> k & 1u)) {
          vc[k] = node_update(vc[k], gk[k], vr[k], s_vc[q], s_vc[2 * m + q],
                              dc[k], g_w, omega);
        }
      }
    }

    // the edge rows' column updates, from the neighbours' old edge rows:
    // the input's at sweep 0, else the last sweep's as they arrive
    const int p = (s - 1) & 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + k * T;
      if (edge >> k & 1u) {
        float north_v = s_vc[q];
        float south_v = s_vc[2 * m + q];
        if (q < m && has_north) {
          north_v = s == 0 ? v_col[base - m + q]
                           : get_tagged(edge_row(halo, p, bands, b - 1, 1, m) +
                                            q,
                                        s);
        }
        if (q >= last && has_south) {
          south_v = s == 0 ? v_col[base + m + q]
                           : get_tagged(edge_row(halo, p, bands, b + 1, 0, m) +
                                            q - last,
                                        s);
        }
        vc[k] = node_update(vc[k], gk[k], vr[k], north_v, south_v, dc[k],
                            g_w, omega);
      }
    }
    __syncthreads();  // every old value has been read

    // write back; send the new edge rows (the last sweep's go nowhere)
    const bool send = s + 1 < sweeps;
    const int ps = s & 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + k * T;
      if (q < nodes) {
        s_vr[ar[k]] = vr[k];
        s_vc[m + q] = vc[k];
        if (send && (edge >> k & 1u)) {
          if (q < m && has_north)
            put_tagged(edge_row(halo, ps, bands, b, 0, m) + q, vc[k], s + 1);
          if (q >= last && has_south)
            put_tagged(edge_row(halo, ps, bands, b, 1, m) + q - last, vc[k],
                       s + 1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = t + k * T;
    if (q < nodes) {
      out_row[base + q] = vr[k];
      out_col[base + q] = vc[k];
    }
  }
}

template <int K>
cudaError_t launch_bands(const float* g, const float* v_in,
                         const float* v_row, const float* v_col,
                         float* out_row, float* out_col,
                         unsigned long long* halo, int n, int m, int bands,
                         int rows_max, int threads, size_t smem, float g_w,
                         float omega, int sweeps, cudaStream_t st) {
  auto kernel = jacobi_band_kernel<K>;
  static smem::SmemGrant grant;
  cudaError_t err = grant.allow(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bands);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (bands > 1) {
    // sweep numbers start at 1: a zeroed word holds no sweep's value
    err = cudaMemsetAsync(halo, 0, sizeof(unsigned long long) * 4 * bands * m,
                          st);
    if (err != cudaSuccess) return err;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, g, v_in, v_row, v_col, out_row,
                           out_col, halo, n, m, bands, rows_max, g_w, omega,
                           sweeps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One call of `sweeps` Jacobi sweeps, one kernel launch.  g, v_row, v_col
// (n, m) f32; v_in (n,) f32; out_row, out_col (n, m) f32; all device
// pointers, contiguous.  The band plan (kernel.band_plan): `bands` CTAs of
// at most `rows_max` = ceil(n / bands) rows, `threads` threads of
// `per_thread` nodes each, `smem` bytes of shared memory.  More than one
// band is a cooperative launch, which also takes `halo` (2 x bands x 2 x m
// 64-bit words, zeroed here on the stream); one band takes none (null).
// Returns a cudaError_t (0 = launched).
int jacobi_sweeps_launch(const void* g, const void* v_in, const void* v_row,
                         const void* v_col, void* out_row, void* out_col,
                         void* halo, int n, int m, int bands, int rows_max,
                         int threads, int per_thread, int smem, float g_w,
                         float omega, int sweeps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 2 || m < 2 || sweeps < 1 || bands < 1 || bands > n ||
      rows_max != (n + bands - 1) / bands || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(threads) * per_thread <
          static_cast<long long>(rows_max) * m ||
      static_cast<size_t>(smem) !=
          sizeof(float) * band_smem_floats(rows_max, m) ||
      (bands > 1 && halo == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* gp = static_cast<const float*>(g);
  const float* vin = static_cast<const float*>(v_in);
  const float* row = static_cast<const float*>(v_row);
  const float* col = static_cast<const float*>(v_col);
  float* orow = static_cast<float*>(out_row);
  float* ocol = static_cast<float*>(out_col);
  auto* hp = static_cast<unsigned long long*>(halo);
#define JACOBI_BANDS(K)                                                     \
  case K:                                                                   \
    return static_cast<int>(launch_bands<K>(gp, vin, row, col, orow, ocol,  \
                                            hp, n, m, bands, rows_max,      \
                                            threads, smem, g_w, omega,      \
                                            sweeps, st));
  switch (per_thread) {
    JACOBI_BANDS(1)
    JACOBI_BANDS(2)
    JACOBI_BANDS(4)
    JACOBI_BANDS(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef JACOBI_BANDS
}

}  // extern "C"
