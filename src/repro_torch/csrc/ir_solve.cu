// Damped-Jacobi sweeps of the crossbar IR-drop network for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `jacobi_sweeps` of
// src/repro/kernels/ir_solve/kernel.py (body `_kernel`).
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
// What bounds it on the H100: a sweep touches five n x m float32 arrays
// (g, both voltage fields in and out) for about 18 flops per node, so it
// is memory- or launch-bound; at the engine's 128 x 128 tile a sweep is
// 64 K nodes, a few microseconds of launch for well under a microsecond of
// work.
//
// What the design does about it: within one sweep, the column update at
// (i, j) needs only the NEW row voltage at the same (i, j) and the OLD
// column voltages of its north and south neighbours, so one sweep is one
// stencil pass with no dependency between threads on new values: one
// thread per node, one launch per sweep, ping-pong buffers.  A 512 x 512
// problem is 1 MB per array and stays in the 50 MB L2 across sweeps.  The
// denominators are formed once per call by a first small kernel.  Keeping
// a small tile in shared memory across sweeps (the TPU keeps it in VMEM)
// is left to a later performance change.
//
// Arithmetic: every operation is an explicitly rounded float32 intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), in the plain version's
// order, so nvcc cannot contract a multiply-add into an FMA and the
// result is the plain PyTorch version's, operation for operation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast-math).
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;

__global__ void denominators_kernel(const float* __restrict__ g,
                                    float* __restrict__ den_r,
                                    float* __restrict__ den_c, int n, int m,
                                    float g_w) {
  const int j = blockIdx.x * kTX + threadIdx.x;
  const int i = blockIdx.y * kTY + threadIdx.y;
  if (i >= n || j >= m) return;
  const size_t at = static_cast<size_t>(i) * m + j;
  const float gv = g[at];
  const float east_g = j < m - 1 ? g_w : 0.0f;
  const float north_g = i > 0 ? g_w : 0.0f;
  den_r[at] = __fadd_rn(__fadd_rn(g_w, east_g), gv);
  den_c[at] = __fadd_rn(__fadd_rn(north_g, g_w), gv);
}

__global__ void sweep_kernel(const float* __restrict__ g,
                             const float* __restrict__ v_in,
                             const float* __restrict__ den_r,
                             const float* __restrict__ den_c,
                             const float* __restrict__ row_in,
                             const float* __restrict__ col_in,
                             float* __restrict__ row_out,
                             float* __restrict__ col_out, int n, int m,
                             float g_w, float omega) {
  const int j = blockIdx.x * kTX + threadIdx.x;
  const int i = blockIdx.y * kTY + threadIdx.y;
  if (i >= n || j >= m) return;
  const size_t at = static_cast<size_t>(i) * m + j;
  const float gv = g[at];
  const float vr = row_in[at];
  const float vc = col_in[at];

  // row node: west neighbour (or the source), east neighbour, device
  const float west = j > 0 ? row_in[at - 1] : v_in[i];
  const float east_g = j < m - 1 ? g_w : 0.0f;
  const float east_v = j < m - 1 ? row_in[at + 1] : 0.0f;
  const float num_r = __fadd_rn(
      __fadd_rn(__fmul_rn(g_w, west), __fmul_rn(east_g, east_v)),
      __fmul_rn(gv, vc));
  const float vr_new = __fadd_rn(
      vr, __fmul_rn(omega, __fsub_rn(__fdiv_rn(num_r, den_r[at]), vr)));

  // column node: north neighbour, south neighbour (or ground), device
  const float north_g = i > 0 ? g_w : 0.0f;
  const float north_v = i > 0 ? col_in[at - m] : 0.0f;
  const float south_v = i < n - 1 ? col_in[at + m] : 0.0f;
  const float num_c = __fadd_rn(
      __fadd_rn(__fmul_rn(north_g, north_v), __fmul_rn(g_w, south_v)),
      __fmul_rn(gv, vr_new));
  const float vc_new = __fadd_rn(
      vc, __fmul_rn(omega, __fsub_rn(__fdiv_rn(num_c, den_c[at]), vc)));

  row_out[at] = vr_new;
  col_out[at] = vc_new;
}

}  // namespace

extern "C" {

// g, v_row, v_col (n, m) f32; v_in (n,) f32; den_r, den_c scratch (n, m);
// a_row, a_col, b_row, b_col ping-pong buffers (n, m): odd sweeps write
// the a pair, even sweeps the b pair, so the result is the a pair after an
// odd number of sweeps and the b pair after an even one.  All device
// pointers, contiguous.  Returns a cudaError_t (0 = launched).
int jacobi_sweeps_launch(const void* g, const void* v_in, const void* v_row,
                         const void* v_col, void* den_r, void* den_c,
                         void* a_row, void* a_col, void* b_row, void* b_col,
                         int n, int m, float g_w, float omega, int sweeps,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 2 || m < 2 || sweeps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTX, kTY);
  const dim3 grid((m + kTX - 1) / kTX, (n + kTY - 1) / kTY);
  const float* gp = static_cast<const float*>(g);
  float* dr = static_cast<float*>(den_r);
  float* dc = static_cast<float*>(den_c);
  denominators_kernel<<<grid, block, 0, st>>>(gp, dr, dc, n, m, g_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* row = static_cast<const float*>(v_row);
  const float* col = static_cast<const float*>(v_col);
  float* pairs[2][2] = {{static_cast<float*>(a_row),
                         static_cast<float*>(a_col)},
                        {static_cast<float*>(b_row),
                         static_cast<float*>(b_col)}};
  for (int s = 0; s < sweeps; ++s) {
    float* out_row = pairs[s & 1][0];
    float* out_col = pairs[s & 1][1];
    sweep_kernel<<<grid, block, 0, st>>>(
        gp, static_cast<const float*>(v_in), dr, dc, row, col, out_row,
        out_col, n, m, g_w, omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    row = out_row;
    col = out_col;
  }
  return 0;
}

}  // extern "C"
