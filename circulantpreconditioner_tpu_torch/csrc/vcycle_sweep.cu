// Kernel K5: one coarse level of the field-major grid V-cycle
// (solvers/aggregation_pc.py::_vcycle on a GridVCyclePC level below the
// fine one) in three kinds of sweep over a flat grid of N sites, m ≤ 8
// fields each, with the level's 7-point varying stencil A (per offset o_k a
// coefficient field C_k, (m, m, N)), its inverted diagonal blocks Dinv
// (N, m, m) and the next level's grid of 2×2×2 boxes, every vector
// field-major:
//
//   k5_smooth    z   = ω·Dinv·r
//   k5_restrict  rc  = cnt_inv · Σ_box (r − A z)
//   k5_sweep     z'  = z + P zc,  out = z' + ω·Dinv·(r − A z')
//                      (zc absent: out = z + ω·Dinv·(r − A z))
//
// A level's V(1,1) visit is smooth, restrict, the next level, sweep: three
// launches, where the plain version (the stage functions beside _vcycle)
// runs about 480 PyTorch kernels (VaryingStencilOperator._apply_gt is 7
// offsets × m² multiply-adds, each its own elementwise kernel, twice a
// visit). It replaces no Pallas kernel: the JAX package's grid V-cycle is
// jnp code (ops/stencil.py::VaryingStencilOperator), which XLA fuses.
//
// What bounds it on an H100: bytes. A visit streams the coefficients twice
// (7·m² values a site: 14.7 MB at 32³, m = 4, float32) and Dinv twice; the
// vectors are a few hundred KB. At the coarse levels of a 64³ grid (32³ and
// 16³) all of it fits in the 50 MB L2, and the sweeps are short enough
// (32,768 sites) that the launch and the tail of the grid weigh as much as
// the bytes. So the design keeps one pass over the coefficients per sweep,
// coalesced (field-major, thread n reads site n), forms what the plain
// version stores (r − A z, the prolonged z') in registers, and uses small
// blocks (128 threads) so that a 16³ level still spreads over 32 SMs.
//
// The arithmetic is the plain version's, in its order inside a site: A's
// sum starts from zero and adds offset by offset, j fastest; a neighbour
// outside [0, N) reads as zero where the plain version's roll wraps it onto
// a zero coefficient (the flat layout's contract, VaryingStencilOperator.
// _flat_safe): either adds zero; a neighbour that wraps inside the grid is
// read and multiplied by its zero coefficient, as K2 does. Only the box sum
// differs: the 8 children of a coarse site are 8 neighbouring lanes of one
// warp (thread t: box t/8, child t%8, x fastest), summed by three xor
// shuffles, a fixed tree, so the result is deterministic (no atomics); a
// child outside an odd grid adds zero, as the plain version's padding does.
// Float32 accumulates in float32, float64 in float64. Site indices are
// 32-bit (the entry points refuse a level of 2^28 sites or more, so that
// 8 threads a box still count in an int), coefficient offsets 64-bit.
// Plain C interface for ctypes; each entry returns the cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOffsets = 7;

template <typename T>
struct Stencil {
  const T* c[kMaxOffsets];   // per offset: coefficient (i, j) of site n at (i·m + j)·N + n
  long long o[kMaxOffsets];  // flat offsets
};

struct Grid {
  int nx, ny, nz;  // this level's sites, x fastest
  int cx, cy, cz;  // the next level's: ceil(n / 2) per axis
};

// acc = (A x)[n], x read through load(q, x[M]) at each neighbour q. Every
// offset is read without a branch (the host pads the list to 7 with offset
// N, always outside the grid, over a valid coefficient field), so the
// compiler can issue all of a site's loads before the first multiply-add:
// the sweeps are short and latency-bound, and this keeps one round trip to
// L2 per site instead of one per offset.
template <typename T, int M, typename Load>
__device__ __forceinline__ void apply_stencil(const Stencil<T>& st, int n, int N, Load load,
                                              T (&acc)[M]) {
  T x[kMaxOffsets][M];
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    const long long q = (long long)n + st.o[k];
    const bool in = q >= 0 && q < N;
    load(in ? (int)q : n, x[k]);
#pragma unroll
    for (int j = 0; j < M; ++j) x[k][j] = in ? x[k][j] : T(0);  // c·0 adds nothing
  }
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = T(0);
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    const T* __restrict__ c = st.c[k];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T a = acc[i];
#pragma unroll
      for (int j = 0; j < M; ++j) a = a + __ldg(c + (long long)(i * M + j) * N + n) * x[k][j];
      acc[i] = a;
    }
  }
}

// the next level's site holding site q of this level
__device__ __forceinline__ int parent(int q, const Grid& g) {
  const int qx = q % g.nx, t = q / g.nx;
  const int qy = t % g.ny, qz = t / g.ny;
  return (qx >> 1) + g.cx * ((qy >> 1) + g.cy * (qz >> 1));
}

// out_i = zn_i + ω · Σ_j Dinv[n][i][j] v_j   (zn = 0: the plain smoothing)
template <typename T, int M>
__device__ __forceinline__ void smooth_store(const T* __restrict__ dinv, int n, int N,
                                             const T (&v)[M], const T (&zn)[M], T omega,
                                             T* __restrict__ out) {
  const T* d = dinv + (long long)n * (M * M);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T a = __ldg(d + i * M) * v[0];
#pragma unroll
    for (int j = 1; j < M; ++j) a = a + __ldg(d + i * M + j) * v[j];
    out[(long long)i * N + n] = zn[i] + omega * a;
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    k5_smooth_kernel(const T* __restrict__ r, const T* __restrict__ dinv, T* __restrict__ z,
                     int N, T omega) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  T v[M], zero[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    v[j] = __ldg(r + (long long)j * N + n);
    zero[j] = T(0);
  }
  // ω·(Dinv r), as the plain version's omega * einsum: 0 + ω·a is ω·a
  smooth_store<T, M>(dinv, n, N, v, zero, omega, z);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    k5_restrict_kernel(const T* __restrict__ r, const T* __restrict__ z, Stencil<T> st,
                       const T* __restrict__ cnt_inv, T* __restrict__ rc, Grid g) {
  const int N = g.nx * g.ny * g.nz;
  const int Nc = g.cx * g.cy * g.cz;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long c = t >> 3;  // the box
  const int k = (int)(t & 7);  // its child, x fastest
  T res[M];
#pragma unroll
  for (int i = 0; i < M; ++i) res[i] = T(0);
  if (c < Nc) {
    const int ci = (int)c;
    const int ccx = ci % g.cx, u = ci / g.cx;
    const int ccy = u % g.cy, ccz = u / g.cy;
    const int fx = 2 * ccx + (k & 1), fy = 2 * ccy + ((k >> 1) & 1), fz = 2 * ccz + (k >> 2);
    if (fx < g.nx && fy < g.ny && fz < g.nz) {
      const int n = fx + g.nx * (fy + g.ny * fz);
      T acc[M];
      apply_stencil<T, M>(st, n, N, [&](int q, T* x) {
#pragma unroll
        for (int j = 0; j < M; ++j) x[j] = __ldg(z + (long long)j * N + q);
      }, acc);
#pragma unroll
      for (int i = 0; i < M; ++i) res[i] = __ldg(r + (long long)i * N + n) - acc[i];
    }
  }
  // every lane of the warp takes part: the 8 lanes of a box sum in a fixed tree
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T v = res[i];
    v = v + __shfl_xor_sync(0xffffffffu, v, 1);
    v = v + __shfl_xor_sync(0xffffffffu, v, 2);
    v = v + __shfl_xor_sync(0xffffffffu, v, 4);
    res[i] = v;
  }
  if (c < Nc && k == 0) {
    const T w = __ldg(cnt_inv + c);
#pragma unroll
    for (int i = 0; i < M; ++i) rc[(long long)i * Nc + c] = res[i] * w;
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    k5_sweep_kernel(const T* __restrict__ r, const T* __restrict__ z, const T* __restrict__ zc,
                    Stencil<T> st, const T* __restrict__ dinv, T* __restrict__ out, Grid g,
                    T omega) {
  const int N = g.nx * g.ny * g.nz;
  const int Nc = g.cx * g.cy * g.cz;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  // z' at q: z, plus the prolonged correction where there is one
  auto load = [&](int q, T* x) {
#pragma unroll
    for (int j = 0; j < M; ++j) x[j] = __ldg(z + (long long)j * N + q);
    if (zc != nullptr) {
      const long long p = parent(q, g);
#pragma unroll
      for (int j = 0; j < M; ++j) x[j] = x[j] + __ldg(zc + (long long)j * Nc + p);
    }
  };
  T acc[M], zn[M], res[M];
  apply_stencil<T, M>(st, n, N, load, acc);
  load(n, zn);
#pragma unroll
  for (int i = 0; i < M; ++i) res[i] = __ldg(r + (long long)i * N + n) - acc[i];
  smooth_store<T, M>(dinv, n, N, res, zn, omega, out);
}

// the K offsets, padded to 7 with offset N (outside the grid from any site)
// over the first coefficient field
template <typename T>
Stencil<T> make_stencil(const void* const* coefs, const long long* offsets, int K,
                        const Grid& g) {
  Stencil<T> st{};
  for (int k = 0; k < kMaxOffsets; ++k) {
    st.c[k] = static_cast<const T*>(coefs[k < K ? k : 0]);
    st.o[k] = k < K ? offsets[k] : (long long)g.nx * g.ny * g.nz;
  }
  return st;
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

#define K5_SWITCH_M(m, LAUNCH)                 \
  switch (m) {                                 \
    case 1: LAUNCH(1); break;                  \
    case 2: LAUNCH(2); break;                  \
    case 3: LAUNCH(3); break;                  \
    case 4: LAUNCH(4); break;                  \
    case 5: LAUNCH(5); break;                  \
    case 6: LAUNCH(6); break;                  \
    case 7: LAUNCH(7); break;                  \
    case 8: LAUNCH(8); break;                  \
    default: return cudaErrorInvalidValue;     \
  }

template <typename T>
cudaError_t smooth(const void* r, const void* dinv, void* z, int N, int m, double omega,
                   cudaStream_t stream) {
#define K5_LAUNCH(M)                                                              \
  k5_smooth_kernel<T, M><<<blocks_for(N), kThreads, 0, stream>>>(                 \
      static_cast<const T*>(r), static_cast<const T*>(dinv), static_cast<T*>(z), N, \
      (T)omega)
  K5_SWITCH_M(m, K5_LAUNCH)
#undef K5_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t restrict_(const void* r, const void* z, const Stencil<T>& st, const void* cnt_inv,
                      void* rc, const Grid& g, int m, cudaStream_t stream) {
  const long long threads = 8LL * g.cx * g.cy * g.cz;
#define K5_LAUNCH(M)                                                                    \
  k5_restrict_kernel<T, M><<<blocks_for(threads), kThreads, 0, stream>>>(               \
      static_cast<const T*>(r), static_cast<const T*>(z), st,                           \
      static_cast<const T*>(cnt_inv), static_cast<T*>(rc), g)
  K5_SWITCH_M(m, K5_LAUNCH)
#undef K5_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t sweep(const void* r, const void* z, const void* zc, const Stencil<T>& st,
                  const void* dinv, void* out, const Grid& g, int m, double omega,
                  cudaStream_t stream) {
  const long long N = (long long)g.nx * g.ny * g.nz;
#define K5_LAUNCH(M)                                                                  \
  k5_sweep_kernel<T, M><<<blocks_for(N), kThreads, 0, stream>>>(                      \
      static_cast<const T*>(r), static_cast<const T*>(z), static_cast<const T*>(zc), st, \
      static_cast<const T*>(dinv), static_cast<T*>(out), g, (T)omega)
  K5_SWITCH_M(m, K5_LAUNCH)
#undef K5_LAUNCH
  return cudaGetLastError();
}

bool grid_ok(const int* shape, int m) {
  for (int a = 0; a < 6; ++a)
    if (shape[a] <= 0) return false;
  for (int a = 0; a < 3; ++a)
    if (shape[3 + a] != (shape[a] + 1) / 2) return false;
  const long long N = (long long)shape[0] * shape[1] * shape[2];
  return m >= 1 && m <= 8 && N * 8 < 0x7fffffffLL;
}

Grid make_grid(const int* shape) {
  return Grid{shape[0], shape[1], shape[2], shape[3], shape[4], shape[5]};
}

}  // namespace

extern "C" {

const char* k5_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// r, z (m, N) field-major; dinv (N, m, m); dtype 0 = float32, 1 = float64.
int k5_smooth(const void* r, const void* dinv, void* z, long long N, int m, double omega,
              int dtype, int device, void* stream_ptr) {
  if (N <= 0 || N * 8 >= 0x7fffffffLL || m < 1 || m > 8) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) return smooth<float>(r, dinv, z, (int)N, m, omega, stream);
  if (dtype == 1) return smooth<double>(r, dinv, z, (int)N, m, omega, stream);
  return cudaErrorInvalidValue;
}

// coefs: K host pointers to (m, m, N) fields, offsets: K flat offsets;
// shape: nx, ny, nz, cx, cy, cz; cnt_inv (Nc,); rc (m, Nc).
int k5_restrict(const void* r, const void* z, const void* const* coefs,
                const long long* offsets, int K, const void* cnt_inv, void* rc,
                const int* shape, int m, int dtype, int device, void* stream_ptr) {
  if (K < 1 || K > kMaxOffsets || !grid_ok(shape, m)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Grid g = make_grid(shape);
  if (dtype == 0)
    return restrict_<float>(r, z, make_stencil<float>(coefs, offsets, K, g), cnt_inv, rc, g, m,
                            stream);
  if (dtype == 1)
    return restrict_<double>(r, z, make_stencil<double>(coefs, offsets, K, g), cnt_inv, rc, g, m,
                             stream);
  return cudaErrorInvalidValue;
}

// zc (m, Nc), or null (no prolongation); out (m, N), not z.
int k5_sweep(const void* r, const void* z, const void* zc, const void* const* coefs,
             const long long* offsets, int K, const void* dinv, void* out, const int* shape,
             int m, double omega, int dtype, int device, void* stream_ptr) {
  if (K < 1 || K > kMaxOffsets || !grid_ok(shape, m)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Grid g = make_grid(shape);
  if (dtype == 0)
    return sweep<float>(r, z, zc, make_stencil<float>(coefs, offsets, K, g), dinv, out, g, m,
                        omega, stream);
  if (dtype == 1)
    return sweep<double>(r, z, zc, make_stencil<double>(coefs, offsets, K, g), dinv, out, g, m,
                         omega, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
