// Kernel K7: the wave normal form of the supercell SpMV y = D x on a flat grid
// of N sites, g ≤ 6 cells a site (the tet meshes: the 6 tets of each hex of
// the lattice one site), m = 4 fields a cell (dim = 3), F ≤ 4 face slots a
// cell, field-major: x and y are (g·m, N), cell k of site n owning rows
// k·m … k·m+m−1 of column n.
//
//   y_k[n] = Σ_j diag[k][i][j][n] · x_k,j[n]
//   for each face slot f < F of cell k, at q = n + off[k][f] (skipped
//   outside [0, N)) in cell c = col[k][f] of that site:
//     p = x_c,0[q],  t = Σ_d nvec[k][f][d][n] · x_c,1+d[q]
//     y_k,0[n]   += (c0/2)·s[k][f][n] · (c0·t − p)
//     y_k,1+d[n] += s[k][f][n]·(p/2 − (c0/2)·t) · nvec[k][f][d][n]
//
// Each face coupling is s·(A − |A|)(n̂)/2, as in K2 (csrc/plane_stencil.cu):
// 1 + dim numbers instead of m². The table (off, col) per (cell, slot) is the
// same for every site: 2·g·F ints on the device, which every thread of a
// block reads at the same address (one broadcast load each, cached). A slot
// that couples nothing at a site (a boundary face) has s = 0 there.
// Host side: ops/stencil.py SupercellNormalOperator (its plain version,
// `plain_fm`), wrapper ops/supercell_stencil.py. It replaces no Pallas
// kernel: the JAX package applies its block-sparse supercell stencil in jnp.
//
// What bounds it on an H100: bytes. A (cell, site) does about 110 flops
// against m² + F·(1 + dim) coefficients, m values of x and m of y: 160 B in
// float32 for m = 4, F = 4; 120 MB an apply at Kershaw-tet 50³, ≥ 36 µs at
// 3.35 TB/s. So one thread per (cell, site), blockIdx.y the cell: a warp runs
// consecutive sites of one cell, every coefficient load and the store are
// coalesced, and every thread of a warp reads the same table entry. The
// neighbour reads of x are coalesced too and hit L2 (x is 12 MB at 50³).
// y is written once: no zero fill, no atomics.
//
// The arithmetic is the plain version's but for the order of the sums (the
// j-sum from j = 0 up, the slots in order); float32 in float32, float64 in
// float64. Site indices are 32-bit (the entry refuses N ≥ 2^31), neighbour
// indices and offsets into the arrays 64-bit. Plain C interface for ctypes; returns the
// cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDim = 3;
constexpr int kMaxCells = 6;
constexpr int kMaxSlots = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k7_supercell_stencil_kernel(const T* __restrict__ x, const T* __restrict__ diag,
                                const T* __restrict__ s, const T* __restrict__ nvec,
                                const int* __restrict__ table, T* __restrict__ y, int N,
                                int F, T c0) {
  constexpr int DIM = kDim;
  constexpr int M = DIM + 1;
  const int k = blockIdx.y;
  const int* off = table + k * F;               // flat site offset of cell k's slot f
  const int* col = table + (gridDim.y + k) * F;  // the cell of that site it reads
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long NN = N;

  const T* xk = x + (long long)k * M * NN + n;
  T xc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) xc[j] = __ldg(xk + j * NN);

  const T* dk = diag + (long long)k * M * M * NN + n;
  T acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T a = __ldg(dk + (i * M) * NN) * xc[0];
#pragma unroll
    for (int j = 1; j < M; ++j) a = a + __ldg(dk + (i * M + j) * NN) * xc[j];
    acc[i] = a;
  }

  const T half_c0 = T(0.5) * c0;
#pragma unroll
  for (int f = 0; f < kMaxSlots; ++f) {
    if (f >= F) break;
    const long long q = (long long)n + __ldg(off + f);
    if (q < 0 || q >= N) continue;  // outside the grid: no neighbour
    const long long kf = (long long)k * F + f;
    const T sk = __ldg(s + kf * NN + n);
    T nv[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) nv[d] = __ldg(nvec + (kf * DIM + d) * NN + n);
    const T* xq = x + (long long)__ldg(col + f) * M * NN + q;
    const T p = __ldg(xq);
    T t = nv[0] * __ldg(xq + NN);
#pragma unroll
    for (int d = 1; d < DIM; ++d) t = t + nv[d] * __ldg(xq + (1 + d) * NN);
    const T u = sk * (T(0.5) * p - half_c0 * t);
    acc[0] = acc[0] + half_c0 * sk * (c0 * t - p);
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc[1 + d] = acc[1 + d] + u * nv[d];
  }

  T* yk = y + (long long)k * M * NN + n;
#pragma unroll
  for (int i = 0; i < M; ++i) yk[i * NN] = acc[i];
}

template <typename T>
cudaError_t launch(const void* x, const void* diag, const void* s, const void* nvec,
                   const int* table, void* y, int N, int g, int F, double c0,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)g);
  const T* xs = static_cast<const T*>(x);
  const T* ds = static_cast<const T*>(diag);
  const T* ss = static_cast<const T*>(s);
  const T* ns = static_cast<const T*>(nvec);
  T* ys = static_cast<T*>(y);
  k7_supercell_stencil_kernel<T>
      <<<grid, kThreads, 0, stream>>>(xs, ds, ss, ns, table, ys, N, F, (T)c0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* k7_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x, y (4·g, N); diag (g, 4, 4, N); s (g, F, N); nvec (g, F, 3, N), all
// contiguous in one dtype: 0 = float32, 1 = float64; dim must be 3, g ≤ 6,
// F ≤ 4.
// table: 2·g·F ints on the device, the offsets (g, F) row-major, then the
// cells (g, F), each offset in (−N, N) and each cell in [0, g) (the wrapper
// checks). y is none of the inputs.
int k7_supercell_stencil(const void* x, const void* diag, const void* s, const void* nvec,
                         const void* table, void* y, long long N, int g, int dim, int F,
                         double c0, int dtype, int device, void* stream_ptr) {
  if (N <= 0 || N >= 0x7fffffffLL || g < 1 || g > kMaxCells || F < 0 || F > kMaxSlots ||
      dim != kDim)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* tab = static_cast<const int*>(table);
  if (dtype == 0)
    return launch<float>(x, diag, s, nvec, tab, y, (int)N, g, F, c0, stream);
  if (dtype == 1)
    return launch<double>(x, diag, s, nvec, tab, y, (int)N, g, F, c0, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
