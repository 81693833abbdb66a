// Kernel K2: the field-major wave normal-form SpMV y = D x on a flat grid of
// N cells (the wave system's divergence on a topologically structured mesh):
//
//   y_i[n]  = Σ_j diag[i][j][n] · x_j[n]
//   for each neighbour offset o_k (K ≤ 6; ±1, ±nx, ±nx·ny):
//     p = x_0[n + o_k],  t = Σ_d nvec[k][d][n] · x_{1+d}[n + o_k]
//     y_0[n]   += (c0/2)·s[k][n] · (c0·t − p)
//     y_1+d[n] += s[k][n]·(p/2 − (c0/2)·t) · nvec[k][d][n]
//
// Replaces circulantpreconditioner_tpu/ops/pallas_stencil.py::
// make_plane_stencil_matvec (the Pallas kernel at :69, pallas_call at :97),
// which walks z-plane blocks with a one-plane skirt held in TPU VMEM through
// three overlapping BlockSpecs and pads the field with zero ghost blocks.
// Those are Mosaic mechanics; here one thread owns one cell n of the flat
// grid and computes all m = dim+1 outputs of that cell, in the arithmetic
// order of the plain version (WaveNormalStencilOperator._apply_gt).
//
// What bounds it on an H100: every operand is field-major, so the reads of
// x, diag, s and nvec at n by neighbouring threads are coalesced, and so are
// the neighbour reads at n ± 1, n ± nx, n ± nx·ny. The work is ~140 flops
// per cell against 40 coefficient floats (16 diag + 6 s + 18 n̂) plus 4 in
// and 4 out: 192 B per cell in float32, 50.3 MB per apply at 64³, ≥ 15 µs
// at 3.35 TB/s. It is bandwidth-bound. The six neighbour reads of x hit L2
// (a 4 MB field at 64³ fits in the 50 MB L2), so the design keeps exactly
// one pass over the coefficient stream, uses read-only loads, and does no
// shared-memory staging.
//
// Boundaries: a neighbour index outside [0, N) is skipped, as the zero
// ghost planes of the TPU kernel are. An index that wraps inside [0, N)
// (the x and y edges of the flat grid) is read and multiplied by its zero
// coefficient, as in the plain version (VaryingStencilOperator._flat_safe).
// Indices are 64-bit. Plain C interface for ctypes; returns the cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 6;

struct Offsets {
  long long o[kMaxOffsets];
  int K;
};

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
    k2_plane_stencil_kernel(const T* __restrict__ x, const T* __restrict__ diag,
                            const T* __restrict__ s, const T* __restrict__ nvec,
                            T* __restrict__ y, long long N, Offsets offs, T c0) {
  constexpr int M = DIM + 1;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  T xc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) xc[j] = __ldg(x + j * N + n);

  T acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T a = __ldg(diag + (long long)(i * M) * N + n) * xc[0];
#pragma unroll
    for (int j = 1; j < M; ++j) a = a + __ldg(diag + (long long)(i * M + j) * N + n) * xc[j];
    acc[i] = a;
  }

  const T half_c0 = T(0.5) * c0;
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    if (k >= offs.K) break;
    const long long q = n + offs.o[k];
    if (q < 0 || q >= N) continue;  // outside the grid: the zero ghost plane
    const T sk = __ldg(s + (long long)k * N + n);
    T nv[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) nv[d] = __ldg(nvec + (long long)(k * DIM + d) * N + n);
    const T p = __ldg(x + q);
    T t = nv[0] * __ldg(x + N + q);
#pragma unroll
    for (int d = 1; d < DIM; ++d) t = t + nv[d] * __ldg(x + (long long)(1 + d) * N + q);
    const T u = sk * (T(0.5) * p - half_c0 * t);
    acc[0] = acc[0] + half_c0 * sk * (c0 * t - p);
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc[1 + d] = acc[1 + d] + u * nv[d];
  }

#pragma unroll
  for (int i = 0; i < M; ++i) y[i * N + n] = acc[i];
}

template <typename T>
cudaError_t launch(const void* x, const void* diag, const void* s, const void* nvec, void* y,
                   long long N, int dim, const Offsets& offs, double c0,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  const T* xs = static_cast<const T*>(x);
  const T* ds = static_cast<const T*>(diag);
  const T* ss = static_cast<const T*>(s);
  const T* ns = static_cast<const T*>(nvec);
  T* ys = static_cast<T*>(y);
  switch (dim) {
    case 1:
      k2_plane_stencil_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(xs, ds, ss, ns, ys, N,
                                                                     offs, (T)c0);
      break;
    case 2:
      k2_plane_stencil_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(xs, ds, ss, ns, ys, N,
                                                                     offs, (T)c0);
      break;
    case 3:
      k2_plane_stencil_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(xs, ds, ss, ns, ys, N,
                                                                     offs, (T)c0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x, y (dim+1, N); diag (dim+1, dim+1, N); s (K, N); nvec (K, dim, N), all
// contiguous in one dtype: 0 = float32, 1 = float64. Offsets o0..o5, the
// first K of them used.
int k2_plane_stencil(const void* x, const void* diag, const void* s, const void* nvec,
                     void* y, long long N, int dim, int K, long long o0, long long o1,
                     long long o2, long long o3, long long o4, long long o5, double c0,
                     int dtype, int device, void* stream_ptr) {
  if (N <= 0 || K < 0 || K > kMaxOffsets || N > (long long)kThreads * 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Offsets offs = {{o0, o1, o2, o3, o4, o5}, K};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) return launch<float>(x, diag, s, nvec, y, N, dim, offs, c0, stream);
  if (dtype == 1) return launch<double>(x, diag, s, nvec, y, N, dim, offs, c0, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
