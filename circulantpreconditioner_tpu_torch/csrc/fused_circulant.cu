// Kernel K1: x = C⁻¹ b for the 3D periodic implicit-transport circulant
// C = I + Σ_d λ_d (I − shift_d), by mixed-radix FFTs over lines in shared
// memory.
//
// Replaces circulantpreconditioner_tpu/ops/fused_circulant.py::_solve3d_kernel,
// a Pallas kernel that holds the whole field in TPU VMEM and runs each
// transform as a dense DFT contraction on the matrix unit. Here the same
// function runs as O(n log n) Stockham FFTs over batches of lines staged
// through shared memory, in five passes (ops/fused_circulant.py names them):
//
//   x forward  L rows of g (nx reals) → complex FFT → bins 0..nxr-1 → s1
//   y forward  L lines (z, kx) of s1 along y                          → s2
//   z          L pencils (ky, kx) of s2: FFT along z, × 1/Λ, inverse  → s1
//   y inverse  as y forward, conjugated twiddles                      → s2
//   x inverse  L rows of s2 expanded to nx hermitian bins → inverse FFT,
//              real part → x
//
// Where a z-plane fits a block's shared memory and there are at least
// PLANE_MIN_NZ planes, the x and y passes of each direction run as one launch
// per plane (k1_xy_forward, k1_yx_inverse), two real rows per complex x line:
// three launches in all, the spectrum out of device memory twice less.
//
// What bounds it on an H100: the bytes and the instructions around them. At
// 100³ the FFTs need about 0.1 GFLOP (1.5 µs at the 67 TFLOP/s fp32 peak),
// while the five passes move 44.7 MB (13 µs at 3.35 TB/s; less where the
// 4 MB spectrum stays in the 50 MB L2): b and x, the half spectrum in and out
// of every pass, 1/Λ. The design serves the memory system: each tile is
// loaded with cp.async so that a warp reads consecutive addresses (a row for
// x; for y and z the tile runs across consecutive kx or pencils and the
// transform along its other axis), and the z pass fuses the forward
// transform, × 1/Λ and the inverse so its pencils never leave the SM. All
// blocks fit one wave, so each pass is load, compute, store in lockstep; the
// index arithmetic of the stages (precomputed divisors, 32-bit tile offsets)
// is the compute, and fusing x with y removes two passes of it and of the
// memory traffic.
//
// In shared memory a tile is L lines at an odd stride S (in complex words),
// so a warp that touches 32 lines at one offset hits distinct banks; each
// stage reads one buffer and writes the other (Stockham: no bit reversal).
// The plan's twiddles (host-built in float64, cast to fp32) are loaded into
// shared memory once per block; the inverse conjugates them. A stage of
// radix 2, 3, 4 or 5 is a butterfly with its constants; the leftover factor
// p of a length with other prime factors (first stage, no twiddles) is a
// direct length-p DFT reading the p roots at (r·q) mod p, O(n·p). A line
// too long for one block (x or y beyond a few thousand points) runs the same
// stages one launch each over device memory, in scratch after the spectra.
//
// All precision tiers compute in fp32. Plain C interface for ctypes; each
// entry returns the cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_STAGES = 32;              // MAX_STAGES in ops/fused_circulant.py
constexpr int PLAN_INTS = 2 + MAX_STAGES;   // per axis: n, stage count, radices
constexpr size_t SMEM_BYTES = 232448;       // shared memory a block may use
constexpr int NT = 256;                     // threads per block
constexpr int LINES_X = 32, LINES_Y = 16, LINES_Z = 16;  // lines per block tile
constexpr int PLANE_THREADS = 512;   // threads of a block that holds a z-plane
constexpr int PLANE_MIN_NZ = 64;     // fewer planes leave most SMs idle (64 planes: 0.48 wave)

// n / d for 0 ≤ n, d < 2^31 by one multiply-high (Granlund and Montgomery,
// as CUTLASS's FastDivmod). The divisors are set on the host: a runtime
// integer division costs some twenty instructions, and the passes split
// every flat index into (line, element) and (block of Ns, k).
struct Div {
  int d;
  unsigned m, s;
};
__device__ __forceinline__ int quo(int n, const Div& v) {
  return (int)((__umulhi((unsigned)n, v.m) + (unsigned)n) >> v.s);
}

struct Axis {
  int n;                  // line length
  int nst;                // stages
  int ntw;                // twiddles in the axis table: Σ Ns·R over the stages
  int radix[MAX_STAGES];  // the leftover factor first (if any), then 4, 2, 3, 5
  Div ns[MAX_STAGES];     // Ns of each stage: the product of the earlier radices
  Div p;                  // radix[0]
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// × (−i) forward, × (+i) inverse
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
template <bool INV>
__device__ __forceinline__ float2 twiddle(const float2* t, int i) {
  const float2 w = t[i];
  return INV ? make_float2(w.x, -w.y) : w;
}

// v ← the length-R DFT of v (e^{∓2πi/R}).
template <int R, bool INV>
__device__ __forceinline__ void butterfly(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 3) {
    constexpr float H = 0.86602540378443865f;  // sin(2π/3)
    const float2 t = cadd(v[1], v[2]);
    const float2 s = rot<INV>(csub(v[1], v[2]));
    const float2 m = make_float2(fmaf(-0.5f, t.x, v[0].x), fmaf(-0.5f, t.y, v[0].y));
    v[0] = cadd(v[0], t);
    v[1] = make_float2(fmaf(H, s.x, m.x), fmaf(H, s.y, m.y));
    v[2] = make_float2(fmaf(-H, s.x, m.x), fmaf(-H, s.y, m.y));
  } else if constexpr (R == 4) {
    const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
    const float2 s13 = cadd(v[1], v[3]), d13 = rot<INV>(csub(v[1], v[3]));
    v[0] = cadd(s02, s13);
    v[2] = csub(s02, s13);
    v[1] = cadd(d02, d13);
    v[3] = csub(d02, d13);
  } else {
    static_assert(R == 5, "radices 2, 3, 4 and 5");
    constexpr float C1 = 0.30901699437494742f, C2 = -0.80901699437494742f;  // cos 2π/5, 4π/5
    constexpr float S1 = 0.95105651629515357f, S2 = 0.58778525229247313f;   // sin 2π/5, 4π/5
    const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
    const float2 t3 = rot<INV>(csub(v[1], v[4])), t4 = rot<INV>(csub(v[2], v[3]));
    const float2 b1 = make_float2(fmaf(C1, t1.x, fmaf(C2, t2.x, v[0].x)),
                                  fmaf(C1, t1.y, fmaf(C2, t2.y, v[0].y)));
    const float2 b2 = make_float2(fmaf(C2, t1.x, fmaf(C1, t2.x, v[0].x)),
                                  fmaf(C2, t1.y, fmaf(C1, t2.y, v[0].y)));
    const float2 e1 = make_float2(fmaf(S1, t3.x, S2 * t4.x), fmaf(S1, t3.y, S2 * t4.y));
    const float2 e2 = make_float2(fmaf(S2, t3.x, -S1 * t4.x), fmaf(S2, t3.y, -S1 * t4.y));
    v[0] = cadd(v[0], cadd(t1, t2));
    v[1] = cadd(b1, e1);
    v[4] = csub(b1, e1);
    v[2] = cadd(b2, e2);
    v[3] = csub(b2, e2);
  }
}

// One Stockham stage of radix R over L.d lines: element i of line l at
// a[l·S + i·E] (output in b), Ns = the product of the earlier radices.
// Butterfly j reads elements j + r·m (m = n/R), multiplies element r by the
// twiddle w^{r·k} (k = j mod Ns, at tw[k·R + r]), and writes output q to
// element (j − k)·R + k + q·Ns. The work items run line fastest, so a warp
// touches consecutive lines at one element: distinct banks when S is odd
// (rows, E = 1) or 1 (the columns of a plane, E odd). A tile's lines past the
// last valid one are transformed too, and never stored.
template <int R, bool INV>
__device__ __forceinline__ void stage(const float2* a, float2* b, const Div& L, int S, int E,
                                      int n, const Div& ns, const float2* tw, int tid, int nth) {
  const int m = n / R;
  for (int w = tid; w < L.d * m; w += nth) {
    const int j = quo(w, L), l = w - j * L.d;
    const int jh = quo(j, ns), k = j - jh * ns.d;
    const float2* src = a + l * S + j * E;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[r * m * E];
    if (ns.d > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], twiddle<INV>(tw, k * R + r));
    }
    butterfly<R, INV>(v);
    float2* dst = b + l * S + (jh * ns.d * R + k) * E;
#pragma unroll
    for (int q = 0; q < R; ++q) dst[q * ns.d * E] = v[q];
  }
}

// The leftover factor p as a direct DFT, always the first stage (Ns = 1, no
// twiddles): output o = j·p + q = Σ_r a[j + r·m]·ω^{(r·q) mod p}, ω from the
// p roots in tw. One work item per output.
template <bool INV>
__device__ __forceinline__ void stage_dft(const float2* a, float2* b, const Div& L, int S, int E,
                                          int n, const Div& p, const float2* tw, int tid,
                                          int nth) {
  const int m = n / p.d;
  for (int w = tid; w < L.d * n; w += nth) {
    const int o = quo(w, L), l = w - o * L.d, j = quo(o, p), q = o - j * p.d;
    const float2* src = a + l * S + j * E;
    float2 acc = make_float2(0.f, 0.f);
    int e = 0;  // r·q mod p
    for (int r = 0; r < p.d; ++r) {
      const float2 x = src[r * m * E], wv = twiddle<INV>(tw, e);
      acc.x = fmaf(x.x, wv.x, fmaf(-x.y, wv.y, acc.x));
      acc.y = fmaf(x.x, wv.y, fmaf(x.y, wv.x, acc.y));
      e += q;
      if (e >= p.d) e -= p.d;
    }
    b[l * S + o * E] = acc;
  }
}

template <bool INV>
__device__ __forceinline__ void run_stage(const float2* a, float2* b, const Div& L, int S, int E,
                                          const Axis& ax, int s, const float2* tw, int tid,
                                          int nth) {
  switch (ax.radix[s]) {
    case 2: stage<2, INV>(a, b, L, S, E, ax.n, ax.ns[s], tw, tid, nth); break;
    case 3: stage<3, INV>(a, b, L, S, E, ax.n, ax.ns[s], tw, tid, nth); break;
    case 4: stage<4, INV>(a, b, L, S, E, ax.n, ax.ns[s], tw, tid, nth); break;
    case 5: stage<5, INV>(a, b, L, S, E, ax.n, ax.ns[s], tw, tid, nth); break;
    default: stage_dft<INV>(a, b, L, S, E, ax.n, ax.p, tw, tid, nth);
  }
}

// All stages of the axis over L.d lines (line stride S, element stride E),
// ping-ponging between a and b; returns the buffer that holds the result.
// Starts with a barrier (the lines were just loaded) and ends with one.
template <bool INV>
__device__ float2* fft_lines(float2* a, float2* b, const Div& L, int S, int E, const Axis& ax,
                             const float2* tw) {
  for (int s = 0, off = 0; s < ax.nst; off += ax.ns[s].d * ax.radix[s], ++s) {
    __syncthreads();
    run_stage<INV>(a, b, L, S, E, ax, s, tw + off, threadIdx.x, blockDim.x);
    float2* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  return a;
}

// --- moving lines between device memory and a tile (tid, nth: this thread's
// place among the threads that share the work; nl: the valid lines) ----------

// device memory → shared memory by cp.async, with no register round trip, so
// a thread keeps all its copies of a tile in flight; async_wait() ends them
__device__ __forceinline__ void async_copy(float2* s, const float2* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g) : "memory");
}
__device__ __forceinline__ void async_copy(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g) : "memory");
}
__device__ __forceinline__ void async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// *dst = *src, by cp.async into a tile (ASYNC) or by a plain copy
template <bool ASYNC, typename T>
__device__ __forceinline__ void put(T* dst, const T* src) {
  if constexpr (ASYNC) async_copy(dst, src);
  else *dst = *src;
}

// rows row0 .. row0+nl−1 of g (nx reals each) → complex lines
template <bool ASYNC>
__device__ __forceinline__ void load_real_rows(const float* g, const Div& nx, int row0, int nl,
                                               float2* a, int S, int tid, int nth) {
  const float* src = g + (long)row0 * nx.d;
  for (int e = tid; e < nl * nx.d; e += nth) {
    const int r = quo(e, nx);
    float2* v = a + r * S + (e - r * nx.d);
    put<ASYNC>(&v->x, src + e);
    v->y = 0.f;
  }
}

// bins 0..nxr−1 of each line → rows of the half spectrum
__device__ __forceinline__ void store_half_rows(const float2* a, int S, float2* s, const Div& nxr,
                                                int row0, int nl, int tid, int nth) {
  float2* dst = s + (long)row0 * nxr.d;
  for (int e = tid; e < nl * nxr.d; e += nth) {
    const int r = quo(e, nxr);
    dst[e] = a[r * S + (e - r * nxr.d)];
  }
}

// rows of the half spectrum → bins 0..nxr−1 of each line
template <bool ASYNC>
__device__ __forceinline__ void load_half_rows(const float2* s, const Div& nxr, int row0, int nl,
                                               float2* a, int S, int tid, int nth) {
  const float2* src = s + (long)row0 * nxr.d;
  for (int e = tid; e < nl * nxr.d; e += nth) {
    const int r = quo(e, nxr);
    put<ASYNC>(a + r * S + (e - r * nxr.d), src + e);
  }
}

// half lines → full hermitian lines: bin nx − k is conj(bin k); Im of bin 0
// and of bin nx/2 (even nx) is dropped, as the dense tables do
__device__ __forceinline__ void fill_hermitian(float2* a, int S, int nx, const Div& nxr, int nl,
                                               int tid, int nth) {
  for (int e = tid; e < nl * nxr.d; e += nth) {
    const int r = quo(e, nxr), k = e - r * nxr.d;
    float2* line = a + r * S;
    if (k == 0 || 2 * k == nx) line[k].y = 0.f;
    else line[nx - k] = make_float2(line[k].x, -line[k].y);
  }
}

// real parts of the lines → rows of x
__device__ __forceinline__ void store_real_rows(const float2* a, int S, float* x, const Div& nx,
                                                int row0, int nl, int tid, int nth) {
  float* dst = x + (long)row0 * nx.d;
  for (int e = tid; e < nl * nx.d; e += nth) {
    const int r = quo(e, nx);
    dst[e] = a[r * S + (e - r * nx.d)].x;
  }
}

// y lines l = z·nxr + kx of the (nz, ny, nxr) spectrum: element y at
// (z·ny + y)·nxr + kx. Line fastest, so a warp reads consecutive kx.
__device__ __forceinline__ long y_at(int l, int y, int ny, const Div& nxr) {
  const int z = quo(l, nxr);
  return ((long)z * ny + y) * nxr.d + (l - z * nxr.d);
}
template <bool ASYNC>
__device__ __forceinline__ void load_y(const float2* s, int ny, const Div& nxr, int l0, int nl,
                                       const Div& L, float2* a, int S, int tid, int nth) {
  for (int e = tid; e < L.d * ny; e += nth) {
    const int y = quo(e, L), li = e - y * L.d;
    if (li < nl) put<ASYNC>(a + li * S + y, s + y_at(l0 + li, y, ny, nxr));
  }
}
__device__ __forceinline__ void store_y(const float2* a, int S, float2* s, int ny, const Div& nxr,
                                        int l0, int nl, const Div& L, int tid, int nth) {
  for (int e = tid; e < L.d * ny; e += nth) {
    const int y = quo(e, L), li = e - y * L.d;
    if (li < nl) s[y_at(l0 + li, y, ny, nxr)] = a[li * S + y];
  }
}

// z pencils p = ky·nxr + kx: element z at z·P + p. Pencil fastest.
__device__ __forceinline__ void load_z(const float2* s, int nz, int P, int p0, int nl,
                                       const Div& L, float2* a, int S, int tid, int nth) {
  for (int e = tid; e < L.d * nz; e += nth) {
    const int z = quo(e, L), li = e - z * L.d;
    if (li < nl) async_copy(a + li * S + z, s + (long)z * P + p0 + li);
  }
}
__device__ __forceinline__ void store_z(const float2* a, int S, float2* s, int nz, int P, int p0,
                                        int nl, const Div& L, int tid, int nth) {
  for (int e = tid; e < L.d * nz; e += nth) {
    const int z = quo(e, L), li = e - z * L.d;
    if (li < nl) s[(long)z * P + p0 + li] = a[li * S + z];
  }
}

// --- the passes over tiles in shared memory -----------------------------------

__device__ __forceinline__ float2* load_table(float2* sm, const float2* tw, int ntw) {
  for (int i = threadIdx.x; i < ntw; i += blockDim.x) async_copy(sm + i, tw + i);
  return sm;
}

// a tile: L lines at stride S in shared memory
struct Tile {
  Div L;
  int S;
};

__global__ void __launch_bounds__(NT) k1_x_forward(const float* __restrict__ g, float2* s1,
                                                   const float2* __restrict__ tw, Axis ax,
                                                   Div nx, Div nxr, int rows, Tile t) {
  extern __shared__ float2 sm[];
  const int row0 = blockIdx.x * t.L.d, nl = min(t.L.d, rows - row0);
  const float2* tws = load_table(sm, tw, ax.ntw);
  float2* a = sm + ax.ntw;
  load_real_rows<true>(g, nx, row0, nl, a, t.S, threadIdx.x, blockDim.x);
  async_wait();
  const float2* r = fft_lines<false>(a, a + t.L.d * t.S, t.L, t.S, 1, ax, tws);
  store_half_rows(r, t.S, s1, nxr, row0, nl, threadIdx.x, blockDim.x);
}

template <bool INV>
__global__ void __launch_bounds__(NT) k1_y(const float2* s_in, float2* s_out,
                                           const float2* __restrict__ tw, Axis ax, Div nxr,
                                           int lines, Tile t) {
  extern __shared__ float2 sm[];
  const int l0 = blockIdx.x * t.L.d, nl = min(t.L.d, lines - l0);
  const float2* tws = load_table(sm, tw, ax.ntw);
  float2* a = sm + ax.ntw;
  load_y<true>(s_in, ax.n, nxr, l0, nl, t.L, a, t.S, threadIdx.x, blockDim.x);
  async_wait();
  const float2* r = fft_lines<INV>(a, a + t.L.d * t.S, t.L, t.S, 1, ax, tws);
  store_y(r, t.S, s_out, ax.n, nxr, l0, nl, t.L, threadIdx.x, blockDim.x);
}

// a third buffer of the tile holds its 1/Λ, copied in with the pencils
__global__ void __launch_bounds__(NT) k1_z(const float2* s_in, float2* s_out,
                                           const float2* __restrict__ lam,
                                           const float2* __restrict__ tw, Axis ax, int P, Tile t) {
  extern __shared__ float2 sm[];
  const int p0 = blockIdx.x * t.L.d, nl = min(t.L.d, P - p0), nz = ax.n, S = t.S;
  const float2* tws = load_table(sm, tw, ax.ntw);
  float2* a = sm + ax.ntw;
  float2* b = a + t.L.d * S;
  float2* c = b + t.L.d * S;
  load_z(s_in, nz, P, p0, nl, t.L, a, S, threadIdx.x, blockDim.x);
  load_z(lam, nz, P, p0, nl, t.L, c, S, threadIdx.x, blockDim.x);
  async_wait();
  float2* r = fft_lines<false>(a, b, t.L, S, 1, ax, tws);
  for (int e = threadIdx.x; e < t.L.d * nz; e += blockDim.x) {  // × 1/Λ/(nx·ny·nz)
    const int kz = quo(e, t.L), i = (e - kz * t.L.d) * S + kz;
    r[i] = cmul(r[i], c[i]);
  }
  r = fft_lines<true>(r, r == a ? b : a, t.L, S, 1, ax, tws);
  store_z(r, S, s_out, nz, P, p0, nl, t.L, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(NT) k1_x_inverse(const float2* __restrict__ s2, float* x,
                                                   const float2* __restrict__ tw, Axis ax,
                                                   Div nx, Div nxr, int rows, Tile t) {
  extern __shared__ float2 sm[];
  const int row0 = blockIdx.x * t.L.d, nl = min(t.L.d, rows - row0);
  const float2* tws = load_table(sm, tw, ax.ntw);
  float2* a = sm + ax.ntw;
  load_half_rows<true>(s2, nxr, row0, nl, a, t.S, threadIdx.x, blockDim.x);
  async_wait();
  __syncthreads();
  fill_hermitian(a, t.S, ax.n, nxr, nl, threadIdx.x, blockDim.x);
  const float2* r = fft_lines<true>(a, a + t.L.d * t.S, t.L, t.S, 1, ax, tws);
  store_real_rows(r, t.S, x, nx, row0, nl, threadIdx.x, blockDim.x);
}

// x and y together, one z-plane per block, where a plane fits a block's
// shared memory, so the half spectrum crosses device memory once instead of
// twice each way and three launches do the solve. Rows 2i and 2i + 1 of the
// plane go through the x transform as the real and imaginary parts of one
// complex line i (half the x work), at stride Sx; the half spectrum is laid
// out [y][kx] at stride Sh, and its nxr columns (line stride 1, element
// stride Sh) go through the y transform. The two regions of X words each
// hold the x lines and then the spectrum rows. PLANE_THREADS threads.

// rows 2i and 2i + 1 of g → Re and Im of line i; a missing last odd row is 0
__device__ __forceinline__ void load_row_pairs(const float* g, const Div& nx, int row0, int rows,
                                               float2* a, int S, int tid, int nth) {
  const float* src = g + (long)row0 * nx.d;
  for (int e = tid; e < rows * nx.d; e += nth) {
    const int r = quo(e, nx);
    float2* v = a + (r >> 1) * S + (e - r * nx.d);
    async_copy(r & 1 ? &v->y : &v->x, src + e);
  }
  if (rows & 1)
    for (int i = tid; i < nx.d; i += nth) a[(rows >> 1) * S + i].y = 0.f;
}

// the FFTs Z of the row pairs → the half spectra of both rows, [y][kx]:
// A_k = (Z_k + conj Z_{n−k}) / 2, B_k = (Z_k − conj Z_{n−k}) / 2i
__device__ __forceinline__ void split_pairs(const float2* z, int Sx, float2* h, int Sh, int nx,
                                            const Div& nxr, int rows, int tid, int nth) {
  for (int e = tid; e < ((rows + 1) >> 1) * nxr.d; e += nth) {
    const int i = quo(e, nxr), k = e - i * nxr.d;
    const float2 Z = z[i * Sx + k], M = z[i * Sx + (k == 0 ? 0 : nx - k)];
    h[2 * i * Sh + k] = make_float2(0.5f * (Z.x + M.x), 0.5f * (Z.y - M.y));
    if (2 * i + 1 < rows) h[(2 * i + 1) * Sh + k] = make_float2(0.5f * (Z.y + M.y), 0.5f * (M.x - Z.x));
  }
}

// half spectra A (row 2i) and B (row 2i + 1), [y][kx] → the full line
// Z = A + iB of pair i, with A and B hermitian; Im of bin 0 and of bin nx/2
// (even nx) dropped, as the dense tables do
__device__ __forceinline__ void join_pairs(const float2* h, int Sh, float2* z, int Sx, int nx,
                                           const Div& nxr, int rows, int tid, int nth) {
  for (int e = tid; e < ((rows + 1) >> 1) * nxr.d; e += nth) {
    const int i = quo(e, nxr), k = e - i * nxr.d;
    float2 A = h[2 * i * Sh + k];
    float2 B = 2 * i + 1 < rows ? h[(2 * i + 1) * Sh + k] : make_float2(0.f, 0.f);
    const bool edge = k == 0 || 2 * k == nx;
    if (edge) A.y = B.y = 0.f;
    z[i * Sx + k] = make_float2(A.x - B.y, A.y + B.x);
    if (!edge) z[i * Sx + nx - k] = make_float2(A.x + B.y, B.x - A.y);
  }
}

// Re and Im of line i → rows 2i and 2i + 1 of x
__device__ __forceinline__ void store_row_pairs(const float2* a, int S, float* x, const Div& nx,
                                                int row0, int rows, int tid, int nth) {
  float* dst = x + (long)row0 * nx.d;
  for (int e = tid; e < rows * nx.d; e += nth) {
    const int r = quo(e, nx);
    const float2 v = a[(r >> 1) * S + (e - r * nx.d)];
    dst[e] = r & 1 ? v.y : v.x;
  }
}

struct Plane {
  Div pairs, ny;  // x lines (row pairs) and rows of a plane
  int Sx, Sh, X;  // the strides of x lines and spectrum rows; words per region
};

__global__ void __launch_bounds__(PLANE_THREADS) k1_xy_forward(
    const float* __restrict__ g, float2* spec, const float2* __restrict__ twx,
    const float2* __restrict__ twy, Axis ax, Axis ay, Div nx, Div nxr, Plane pl) {
  extern __shared__ float2 sm[];
  const float2* tx = load_table(sm, twx, ax.ntw);
  const float2* ty = load_table(sm + ax.ntw, twy, ay.ntw);
  float2* r1 = sm + ax.ntw + ay.ntw;
  float2* r2 = r1 + pl.X;
  const int row0 = blockIdx.x * pl.ny.d;
  load_row_pairs(g, nx, row0, pl.ny.d, r1, pl.Sx, threadIdx.x, blockDim.x);
  async_wait();
  const float2* z = fft_lines<false>(r1, r2, pl.pairs, pl.Sx, 1, ax, tx);
  float2* h = z == r1 ? r2 : r1;
  split_pairs(z, pl.Sx, h, pl.Sh, ax.n, nxr, pl.ny.d, threadIdx.x, blockDim.x);
  const float2* r = fft_lines<false>(h, h == r1 ? r2 : r1, nxr, 1, pl.Sh, ay, ty);
  store_half_rows(r, pl.Sh, spec, nxr, row0, pl.ny.d, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(PLANE_THREADS) k1_yx_inverse(
    const float2* __restrict__ spec, float* x, const float2* __restrict__ twx,
    const float2* __restrict__ twy, Axis ax, Axis ay, Div nx, Div nxr, Plane pl) {
  extern __shared__ float2 sm[];
  const float2* tx = load_table(sm, twx, ax.ntw);
  const float2* ty = load_table(sm + ax.ntw, twy, ay.ntw);
  float2* r1 = sm + ax.ntw + ay.ntw;
  float2* r2 = r1 + pl.X;
  const int row0 = blockIdx.x * pl.ny.d;
  load_half_rows<true>(spec, nxr, row0, pl.ny.d, r1, pl.Sh, threadIdx.x, blockDim.x);
  async_wait();
  const float2* h = fft_lines<true>(r1, r2, nxr, 1, pl.Sh, ay, ty);
  float2* z = h == r1 ? r2 : r1;
  join_pairs(h, pl.Sh, z, pl.Sx, ax.n, nxr, pl.ny.d, threadIdx.x, blockDim.x);
  const float2* r = fft_lines<true>(z, z == r1 ? r2 : r1, pl.pairs, pl.Sx, 1, ax, tx);
  store_row_pairs(r, pl.Sx, x, nx, row0, pl.ny.d, threadIdx.x, blockDim.x);
}

// --- lines too long for a block: the same steps over device memory, one
// launch each, every line contiguous (stride n) in scratch ---------------------

__device__ __forceinline__ int gtid() { return blockIdx.x * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int gnth() { return gridDim.x * blockDim.x; }

template <bool INV>
__global__ void __launch_bounds__(NT) k1_stage_global(const float2* a, float2* b, Div lines,
                                                      Axis ax, int s, const float2* tw) {
  run_stage<INV>(a, b, lines, ax.n, 1, ax, s, tw, gtid(), gnth());
}
__global__ void k1_x_forward_load(const float* g, float2* G, Div nx, int rows) {
  load_real_rows<false>(g, nx, 0, rows, G, nx.d, gtid(), gnth());
}
__global__ void k1_x_forward_store(const float2* G, float2* s1, int nx, Div nxr, int rows) {
  store_half_rows(G, nx, s1, nxr, 0, rows, gtid(), gnth());
}
__global__ void k1_x_inverse_load(const float2* s2, float2* G, int nx, Div nxr, int rows) {
  load_half_rows<false>(s2, nxr, 0, rows, G, nx, gtid(), gnth());
}
__global__ void k1_x_inverse_fill(float2* G, int nx, Div nxr, int rows) {
  fill_hermitian(G, nx, nx, nxr, rows, gtid(), gnth());
}
__global__ void k1_x_inverse_store(const float2* G, float* x, Div nx, int rows) {
  store_real_rows(G, nx.d, x, nx, 0, rows, gtid(), gnth());
}
__global__ void k1_y_load(const float2* s, float2* G, int ny, Div nxr, Div lines) {
  load_y<false>(s, ny, nxr, 0, lines.d, lines, G, ny, gtid(), gnth());
}
__global__ void k1_y_store(const float2* G, float2* s, int ny, Div nxr, Div lines) {
  store_y(G, ny, s, ny, nxr, 0, lines.d, lines, gtid(), gnth());
}

// --- host side -------------------------------------------------------------------

inline long cdiv(long a, long b) { return (a + b - 1) / b; }

Div make_div(int d) {
  unsigned s = 0;
  while ((1u << s) < (unsigned)d) ++s;
  const unsigned long long one = 1;
  return Div{d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

// The axis of `n` points from its PLAN_INTS ints; false if they do not
// describe a plan of n: stage radices ≥ 2 whose product is n, a radix other
// than 2, 3, 4, 5 only first.
bool read_axis(const int* p, int n, Axis* ax) {
  ax->n = p[0];
  ax->nst = p[1];
  ax->ntw = 0;
  if (ax->n != n || n < 1 || ax->nst < 0 || ax->nst > MAX_STAGES) return false;
  long ns = 1;
  for (int s = 0; s < MAX_STAGES; ++s) {
    ax->radix[s] = s < ax->nst ? p[2 + s] : 0;
    ax->ns[s] = make_div(1);
  }
  ax->p = make_div(ax->nst > 0 ? ax->radix[0] : 1);
  for (int s = 0; s < ax->nst; ++s) {
    const int r = ax->radix[s];
    const bool small = r == 2 || r == 3 || r == 4 || r == 5;
    if (r < 2 || (s > 0 && !small) || ns * r > n) return false;
    ax->ns[s] = make_div((int)ns);
    ax->ntw += (int)(ns * r);
    ns *= r;
  }
  return ns == n;
}

struct Shape {
  Tile tile;
  size_t smem;
  bool fits;
};

// L lines per block (at most `target`, halved until `buffers` tiles and the
// twiddles fit a block's shared memory), at the odd stride S.
Shape tile_for(const Axis& ax, long lines, int target, int buffers = 2) {
  const int S = ax.n | 1;
  int L = (int)(lines < target ? (lines < 1 ? 1 : lines) : target);
  auto bytes = [&](int l) { return ((size_t)ax.ntw + (size_t)buffers * l * S) * sizeof(float2); };
  while (L > 1 && bytes(L) > SMEM_BYTES) L = (L + 1) / 2;
  return Shape{Tile{make_div(L), S}, bytes(L), bytes(L) <= SMEM_BYTES};
}

template <int THREADS = NT, typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, long blocks, size_t smem, cudaStream_t st,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch_grid(Kernel kernel, long work, cudaStream_t st, Args... args) {
  const long blocks = cdiv(work, NT) < 132 * 16 ? cdiv(work, NT) : 132 * 16;
  kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), NT, 0, st>>>(args...);
  return cudaGetLastError();
}

// The axis's stages over all `lines` contiguous lines in device memory, from
// *a; *a ends as the buffer that holds the result.
template <bool INV>
cudaError_t global_stages(float2** a, float2** b, int lines, const Axis& ax, const float2* tw,
                          cudaStream_t st) {
  const Div ld = make_div(lines);
  for (int s = 0, off = 0; s < ax.nst; off += ax.ns[s].d * ax.radix[s], ++s) {
    const long work = (long)lines * (ax.radix[s] <= 5 ? ax.n / ax.radix[s] : ax.n);
    cudaError_t err = launch_grid(k1_stage_global<INV>, work, st, *a, *b, ld, ax, s, tw + off);
    if (err != cudaSuccess) return err;
    float2* t = *a;
    *a = *b;
    *b = t;
  }
  return cudaSuccess;
}

struct Layout {
  Axis x, y, z;
  Div nx, nxr, ny;
  int rows, ylines, P;
  long spec, G;  // complex words: a half spectrum; a long-line buffer
  Shape tx, ty, tz;
  Plane pl;
  size_t plane_smem;  // a z-plane's two regions and the x and y twiddles
  bool plane;         // x and y run fused, one plane per block
};

bool make_layout(const int* plan, int nz, int ny, int nx, Layout* o) {
  if (!read_axis(plan, nx, &o->x) || !read_axis(plan + PLAN_INTS, ny, &o->y) ||
      !read_axis(plan + 2 * PLAN_INTS, nz, &o->z))
    return false;
  const int nxr = nx / 2 + 1;
  o->nx = make_div(nx);
  o->nxr = make_div(nxr);
  o->rows = nz * ny;
  o->ylines = nz * nxr;
  o->P = ny * nxr;
  o->spec = (long)nz * ny * nxr;
  o->tx = tile_for(o->x, o->rows, LINES_X);
  o->ty = tile_for(o->y, o->ylines, LINES_Y);
  o->tz = tile_for(o->z, o->P, LINES_Z, 3);
  o->G = 0;
  if (!o->tx.fits) o->G = (long)o->rows * nx;
  if (!o->ty.fits && (long)o->ylines * ny > o->G) o->G = (long)o->ylines * ny;
  o->ny = make_div(ny);
  const int pairs = (ny + 1) / 2, Sx = nx | 1, Sh = nxr | 1;
  const long X = (long)pairs * Sx > (long)ny * Sh ? (long)pairs * Sx : (long)ny * Sh;
  o->pl = Plane{make_div(pairs), o->ny, Sx, Sh, (int)(X < (1L << 30) ? X : 1L << 30)};
  o->plane_smem = ((size_t)o->x.ntw + o->y.ntw + 2 * (size_t)X) * sizeof(float2);
  o->plane = o->plane_smem <= SMEM_BYTES && nz >= PLANE_MIN_NZ;
  return o->tz.fits;
}

template <bool INV>
cudaError_t y_pass(const Layout& lo, float2* in, float2* out, const float2* tw, float2* G1,
                   float2* G2, cudaStream_t st) {
  if (lo.ty.fits)
    return launch_tiles(k1_y<INV>, cdiv(lo.ylines, lo.ty.tile.L.d), lo.ty.smem, st, in, out, tw,
                        lo.y, lo.nxr, lo.ylines, lo.ty.tile);
  const long work = (long)lo.ylines * lo.y.n;
  const Div lines = make_div(lo.ylines);
  cudaError_t err = launch_grid(k1_y_load, work, st, in, G1, lo.y.n, lo.nxr, lines);
  if (err == cudaSuccess) err = global_stages<INV>(&G1, &G2, lo.ylines, lo.y, tw, st);
  if (err == cudaSuccess) err = launch_grid(k1_y_store, work, st, G1, out, lo.y.n, lo.nxr, lines);
  return err;
}

}  // namespace

extern "C" {

const char* k1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch a solve needs: the two half spectra s1 and s2, then two
// long-line buffers when a line does not fit a block; −1 for a bad plan.
long long k1_scratch_floats(const int* plan, int nz, int ny, int nx) {
  Layout lo;
  if (!make_layout(plan, nz, ny, nx, &lo)) return -1;
  return 2 * (2 * lo.spec + 2 * lo.G);
}

// g (nz, ny, nx) → x (nz, ny, nx). tw_x, tw_y, tw_z: each axis's twiddles,
// complex; lam: 1/Λ/(nx·ny·nz) on (nz, ny, nxr), complex; plan: 3 × PLAN_INTS
// host ints (x, y, z); passes: bit mask of the five passes in order (31 = the
// solve; single passes are for timing, with s1 and s2 left by an earlier run).
int k1_fused_circulant_solve(const float* g, const float* tw_x, const float* tw_y,
                             const float* tw_z, const float* lam, float* x, float* scratch,
                             const int* plan, int nz, int ny, int nx, int passes, int device,
                             void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Layout lo;
  if (!make_layout(plan, nz, ny, nx, &lo)) return cudaErrorInvalidValue;
  const float2* twx = reinterpret_cast<const float2*>(tw_x);
  const float2* twy = reinterpret_cast<const float2*>(tw_y);
  const float2* twz = reinterpret_cast<const float2*>(tw_z);
  float2* s1 = reinterpret_cast<float2*>(scratch);
  float2* s2 = s1 + lo.spec;
  float2* G1 = s2 + lo.spec;
  float2* G2 = G1 + lo.G;
  const long xwork = (long)lo.rows * nx;
  const long xblocks = cdiv(lo.rows, lo.tx.tile.L.d);

  if (lo.plane && (passes & 3) == 3) {  // x and y forward per plane: g → s2
    err = launch_tiles<PLANE_THREADS>(k1_xy_forward, nz, lo.plane_smem, st, g, s2, twx, twy,
                                      lo.x, lo.y, lo.nx, lo.nxr, lo.pl);
    if (err != cudaSuccess) return err;
    passes &= ~3;
  }
  const bool plane_inverse = lo.plane && (passes & 24) == 24;
  if (passes & 1) {  // x forward: g → s1
    if (lo.tx.fits) {
      err = launch_tiles(k1_x_forward, xblocks, lo.tx.smem, st, g, s1, twx, lo.x, lo.nx, lo.nxr,
                         lo.rows, lo.tx.tile);
    } else {
      float2 *a = G1, *b = G2;
      err = launch_grid(k1_x_forward_load, xwork, st, g, a, lo.nx, lo.rows);
      if (err == cudaSuccess) err = global_stages<false>(&a, &b, lo.rows, lo.x, twx, st);
      if (err == cudaSuccess)
        err = launch_grid(k1_x_forward_store, xwork, st, a, s1, nx, lo.nxr, lo.rows);
    }
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {  // y forward: s1 → s2
    if ((err = y_pass<false>(lo, s1, s2, twy, G1, G2, st)) != cudaSuccess) return err;
  }
  if (passes & 4) {  // z forward, × 1/Λ, z inverse: s2 → s1
    err = launch_tiles(k1_z, cdiv(lo.P, lo.tz.tile.L.d), lo.tz.smem, st, s2, s1,
                       reinterpret_cast<const float2*>(lam), twz, lo.z, lo.P, lo.tz.tile);
    if (err != cudaSuccess) return err;
  }
  if ((passes & 8) && !plane_inverse) {  // y inverse: s1 → s2
    if ((err = y_pass<true>(lo, s1, s2, twy, G1, G2, st)) != cudaSuccess) return err;
  }
  if (plane_inverse) {  // y and x inverse per plane: s1 → x
    err = launch_tiles<PLANE_THREADS>(k1_yx_inverse, nz, lo.plane_smem, st, s1, x, twx, twy,
                                      lo.x, lo.y, lo.nx, lo.nxr, lo.pl);
    if (err != cudaSuccess) return err;
    passes &= ~24;
  }
  if (passes & 16) {  // x inverse: s2 → x
    if (lo.tx.fits) {
      err = launch_tiles(k1_x_inverse, xblocks, lo.tx.smem, st, s2, x, twx, lo.x, lo.nx, lo.nxr,
                         lo.rows, lo.tx.tile);
    } else {
      float2 *a = G1, *b = G2;
      err = launch_grid(k1_x_inverse_load, xwork, st, s2, a, nx, lo.nxr, lo.rows);
      if (err == cudaSuccess) err = launch_grid(k1_x_inverse_fill, xwork, st, a, nx, lo.nxr, lo.rows);
      if (err == cudaSuccess) err = global_stages<true>(&a, &b, lo.rows, lo.x, twx, st);
      if (err == cudaSuccess) err = launch_grid(k1_x_inverse_store, xwork, st, a, x, lo.nx, lo.rows);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
