// Kernel K6: point-block Jacobi on field-major vectors, in one launch
//
//   out = zn + ω · Dinv · (r − y)        (zn, y null: read as 0)
//
// over g·S cells, g cells a site and b ≤ 8 fields a cell. The vectors are
// field-major flat: the view (g·b, S), cell (s, k) owning rows k·b … k·b+b−1
// of column s (g = 1: the (b, N) field view). Dinv is read where the caller
// keeps it, in one of two layouts:
//
//   0  cell-major (g·S, b, b): cell (s, k)'s block at (s·g + k)·b², row-major
//      (the V-cycle's `_block_diag_inv`, a supercell level's site-major cells)
//   1  field-major (g, b, b, S): entry (i, j) of cell (s, k) at
//      ((k·b + i)·b + j)·S + s (solvers/preconditioners.pbjacobi_fm)
//
// Call sites (ops/block_jacobi.py): the grid V-cycle's generic field-major
// stages (the hex fine level, a tet mesh's site level), pbjacobi_fm, and the
// multiplicative composite's z + Ms(r − A z). It replaces no Pallas kernel:
// the JAX package leaves this contraction to XLA; here it was a
// torch.einsum, which cuBLAS runs as a batched gemv at a few percent of the
// bytes bound.
//
// What bounds it on an H100: bytes. A cell does 2·b² flops against
// b²·sizeof(T) of Dinv and b values of each of r, y, zn and out (b = 4,
// float32: 32 flops, 64 + 64 bytes). So one thread a cell, threads along
// the site axis: the vectors' loads and the store are coalesced (thread t:
// site t mod S, cell t / S of it); in layout 1 so is every entry of Dinv,
// and in layout 0 a thread reads its cell's contiguous block as 16-byte
// vectors (float4 / double2) where the block's size and the base allow,
// every sector of it once through L1. out is written once.
//
// The arithmetic is the plain version's (the einsum), but for the order of
// the j-sum: r − y first, Σ_j Dinv_ij v_j from j = 0 up, then zn + ω·a;
// float32 in float32 FMA, float64 in float64. Cell indices are 32-bit (the
// entry refuses g·S ≥ 2^31), offsets into Dinv 64-bit. Plain C interface
// for ctypes; the entry returns the cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load16(const float* p, float* d) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = w.x;
  d[1] = w.y;
  d[2] = w.z;
  d[3] = w.w;
}

__device__ __forceinline__ void load16(const double* p, double* d) {
  const double2 w = __ldg(reinterpret_cast<const double2*>(p));
  d[0] = w.x;
  d[1] = w.y;
}

// LAYOUT as above; VEC: layout 0's block in 16-byte loads (the host checks
// that b²·sizeof(T) is a multiple of 16 and Dinv 16-byte aligned)
template <typename T, int M, int LAYOUT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    k6_block_jacobi_kernel(const T* __restrict__ r, const T* __restrict__ y,
                           const T* __restrict__ zn, const T* __restrict__ dinv,
                           T* __restrict__ out, int S, int g, T omega) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g * S) return;
  const int k = t / S, s = t - k * S;
  const long long base = (long long)k * M * S + s;  // row k·b + i at base + i·S
  T v[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    v[j] = __ldg(r + base + (long long)j * S);
    if (y != nullptr) v[j] = v[j] - __ldg(y + base + (long long)j * S);
  }
  T d[M * M];
  if constexpr (LAYOUT == 0) {
    const T* blk = dinv + ((long long)s * g + k) * (M * M);
    if constexpr (VEC) {
      constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
      for (int q = 0; q < M * M / kPer; ++q) load16(blk + q * kPer, d + q * kPer);
    } else {
#pragma unroll
      for (int q = 0; q < M * M; ++q) d[q] = __ldg(blk + q);
    }
  } else {
    const T* col = dinv + (long long)k * M * M * S + s;
#pragma unroll
    for (int q = 0; q < M * M; ++q) d[q] = __ldg(col + (long long)q * S);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T a = d[i * M] * v[0];
#pragma unroll
    for (int j = 1; j < M; ++j) a = a + d[i * M + j] * v[j];
    const long long o = base + (long long)i * S;
    out[o] = (zn != nullptr ? __ldg(zn + o) : T(0)) + omega * a;
  }
}

template <typename T, int M>
cudaError_t launch(const void* r, const void* y, const void* zn, const void* dinv, void* out,
                   int S, int g, int layout, double omega, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((long long)g * S + kThreads - 1) / kThreads);
  constexpr bool kWhole16 = (M * M * sizeof(T)) % 16 == 0;  // a block in 16-byte loads
  const T* rr = static_cast<const T*>(r);
  const T* yy = static_cast<const T*>(y);
  const T* zz = static_cast<const T*>(zn);
  const T* dd = static_cast<const T*>(dinv);
  T* oo = static_cast<T*>(out);
  if (layout == 1)
    k6_block_jacobi_kernel<T, M, 1, false>
        <<<blocks, kThreads, 0, stream>>>(rr, yy, zz, dd, oo, S, g, (T)omega);
  else if (kWhole16 && reinterpret_cast<std::uintptr_t>(dinv) % 16 == 0)
    k6_block_jacobi_kernel<T, M, 0, kWhole16>
        <<<blocks, kThreads, 0, stream>>>(rr, yy, zz, dd, oo, S, g, (T)omega);
  else
    k6_block_jacobi_kernel<T, M, 0, false>
        <<<blocks, kThreads, 0, stream>>>(rr, yy, zz, dd, oo, S, g, (T)omega);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* y, const void* zn, const void* dinv, void* out,
                     int S, int g, int b, int layout, double omega, cudaStream_t stream) {
  switch (b) {
    case 1: return launch<T, 1>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 2: return launch<T, 2>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 3: return launch<T, 3>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 4: return launch<T, 4>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 5: return launch<T, 5>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 6: return launch<T, 6>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 7: return launch<T, 7>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    case 8: return launch<T, 8>(r, y, zn, dinv, out, S, g, layout, omega, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* k6_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// r, out (and y, zn where not null): g·b·S values, field-major; dinv in
// `layout` (0 or 1, above); dtype 0 = float32, 1 = float64. out is none of
// the inputs.
int k6_block_jacobi(const void* r, const void* y, const void* zn, const void* dinv, void* out,
                    long long S, int g, int b, int layout, double omega, int dtype, int device,
                    void* stream_ptr) {
  if (S <= 0 || g < 1 || (long long)g * S >= 0x7fffffffLL || b < 1 || b > 8 ||
      (layout != 0 && layout != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) return dispatch<float>(r, y, zn, dinv, out, (int)S, g, b, layout, omega, stream);
  if (dtype == 1)
    return dispatch<double>(r, y, zn, dinv, out, (int)S, g, b, layout, omega, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
