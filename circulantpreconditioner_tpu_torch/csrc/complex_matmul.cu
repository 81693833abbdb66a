// Kernel K3: (O_re + i O_im) = (A_re + i A_im) · (B_re + i B_im) for an
// (M, K) · (K, N) complex product held as separate real and imaginary planes.
//
// Replaces circulantpreconditioner_tpu/ops/pallas_kernels.py::_cmm_kernel
// (`complex_matmul`), which the staged DFT solver calls on its y and z stages
// (ops/dft_matmul.py, MatmulCirculantSolver(use_kernel=True)): A is the
// spectrum collapsed to (rows, n), B the n × n DFT matrix. The TPU kernel's
// point is to read each A tile once for all four real products and to keep
// both accumulators on chip across the K loop; this kernel does the same.
//
// What bounds it on an H100: floating-point operations against 67 TFLOP/s of
// fp32 FMA peak outside the tensor cores. The complex product needs three real
// products (Gauss's form, 6·M·K·N operations); this kernel does the direct
// form's four (8·M·K·N), which share each A tile between both outputs. At the
// 128³ stage shape, (8320, 128) · (128, 128), that is 0.82 GFLOP, ≥ 12.2 µs,
// for the function and 1.09 GFLOP, ≥ 16.3 µs, for this form; the operands and
// results are about 17 MB, ≥ 5 µs at 3.35 TB/s. So the product is bound by FMA
// throughput, not by device memory. The design answers with a 64 × 64 output tile per block, staged through
// shared memory in 16-deep slices (one A_re, A_im, B_re and B_im tile per
// slice, each A tile feeding both accumulators), and a 4 × 4 register
// micro-tile of both accumulators per thread: 32 FMA per 8 shared-memory
// vector loads. Ragged edges are masked (zero-filled loads, guarded stores),
// so any M, N, K is taken; the TPU kernel's multiple-of-128 rule was a Mosaic
// tiling rule and is dropped. Templated on float and double; the sums are
// accumulated in the input type. Tensor-core forms (3×TF32 with wgmma) are
// later work.
//
// Plain C interface for ctypes; each entry returns the cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block tile
constexpr int BN = 64;   // output columns per block tile
constexpr int BK = 16;   // contraction slice staged per step
constexpr int NT = 256;  // threads per block: 16 × 16, each a 4 × 4 micro-tile
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;   // keeps the transposed A stores to 2-way bank conflicts

__device__ __forceinline__ float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double (&r)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
}

// One block computes O[i0:i0+64, c0:c0+64] of both planes. A, B, O are
// row-major and contiguous: A(i, j) = A[i·K + j], B(j, c) = B[j·N + c].
template <typename T>
__global__ void __launch_bounds__(NT) k3_cmm(const T* __restrict__ Are,
                                             const T* __restrict__ Aim,
                                             const T* __restrict__ Bre,
                                             const T* __restrict__ Bim, T* __restrict__ Ore,
                                             T* __restrict__ Oim, int M, int N, int K) {
  __shared__ __align__(16) T sAre[BK][BM + PAD];
  __shared__ __align__(16) T sAim[BK][BM + PAD];
  __shared__ __align__(16) T sBre[BK][BN];
  __shared__ __align__(16) T sBim[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN, i0 = blockIdx.y * BM;

  T are[TM][TN], aim[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) are[m][n] = aim[m][n] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tiles: 16 neighbouring threads read 16 neighbouring values of a row
#pragma unroll
    for (int q = 0; q < BM * BK / NT; ++q) {
      const int e = tid + q * NT;
      const int i = e / BK, j = e % BK;
      const int gi = i0 + i, gj = k0 + j;
      T vr = T(0), vi = T(0);
      if (gi < M && gj < K) {
        const long off = (long)gi * K + gj;
        vr = Are[off];
        vi = Aim[off];
      }
      sAre[j][i] = vr;
      sAim[j][i] = vi;
    }
    // B tiles: a warp reads 32 neighbouring values of a row
#pragma unroll
    for (int q = 0; q < BK * BN / NT; ++q) {
      const int e = tid + q * NT;
      const int j = e / BN, c = e % BN;
      const int gj = k0 + j, gc = c0 + c;
      T vr = T(0), vi = T(0);
      if (gj < K && gc < N) {
        const long off = (long)gj * N + gc;
        vr = Bre[off];
        vi = Bim[off];
      }
      sBre[j][c] = vr;
      sBim[j][c] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T ar[TM], ai[TM], br[TN], bi[TN];
      load4(&sAre[kk][ty * TM], ar);
      load4(&sAim[kk][ty * TM], ai);
      load4(&sBre[kk][tx * TN], br);
      load4(&sBim[kk][tx * TN], bi);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          are[m][n] = fmadd(ar[m], br[n], fmadd(-ai[m], bi[n], are[m][n]));
          aim[m][n] = fmadd(ar[m], bi[n], fmadd(ai[m], br[n], aim[m][n]));
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = i0 + ty * TM + m;
    if (i >= M) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = c0 + tx * TN + n;
      if (c < N) {
        Ore[(long)i * N + c] = are[m][n];
        Oim[(long)i * N + c] = aim[m][n];
      }
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch(const void* Are, const void* Aim, const void* Bre, const void* Bim,
                   void* Ore, void* Oim, int M, int N, int K, cudaStream_t stream) {
  k3_cmm<T><<<dim3(cdiv(N, BN), cdiv(M, BM)), NT, 0, stream>>>(
      static_cast<const T*>(Are), static_cast<const T*>(Aim), static_cast<const T*>(Bre),
      static_cast<const T*>(Bim), static_cast<T*>(Ore), static_cast<T*>(Oim), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32, 1 float64. M rows ≤ 65535 · 64 (the grid's y extent).
int k3_complex_matmul(const void* Are, const void* Aim, const void* Bre, const void* Bim,
                      void* Ore, void* Oim, int M, int N, int K, int dtype, int device,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0) return launch<float>(Are, Aim, Bre, Bim, Ore, Oim, M, N, K, stream);
  if (dtype == 1) return launch<double>(Are, Aim, Bre, Bim, Ore, Oim, M, N, K, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
