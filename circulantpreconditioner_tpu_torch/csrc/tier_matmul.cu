// Kernel K4: C = A · B for float32 A, B and C, every product in one or three
// bf16 passes on the tensor cores: the "default" and "high" precision tiers
// of the JAX package's DFT-by-matmul solvers.
//
// Counterpart of the split product inside the Pallas kernel K1
// (circulantpreconditioner_tpu/ops/fused_circulant.py::_mk_ops) and of XLA's
// Precision.HIGH and DEFAULT on the TPU's matrix unit, which the JAX
// package's einsums pass (ops/spectral_collapse.py, ops/dft_matmul.py,
// ops/dct_wave.py, parallel/pc_dist.py). Each operand value a is split into
// hi = bf16(a), rounded to nearest even, and lo = bf16(a − hi), the
// subtraction in fp32. "high" (three passes) sums lo·hi + hi·lo + hi·hi,
// the lo·lo term dropped, as _mk_ops does; "default" (one pass) is hi·hi.
// A product of two bf16 values is exact in fp32; the sums are fp32. It is
// not a fourth Pallas kernel: the TPU ran these products on its matrix unit
// through XLA.
//
// The form. One operand is the data, the other a small matrix: A is a
// tensor viewed as (batch, P, K, Q), with any strides so long as P's and
// Q's dimensions each collapse to one stride; B is (batch, K, N), with any
// strides (a batch stride of 0 for a shared matrix); and
//     C[b, p, n, q] = Σ_k A[b, p, k, q] · B[b, k, n],
// written contiguous. The rows of the product are the (p, q) pairs. So one
// kernel contracts any axis of a grid with a transform without a transpose
// copy: along x, Q = 1 and the product is (Z·Y, X)·(X, N); along y, P = Z
// and Q = X, the per-z products (N, Y)·(Y, X) of a shared left matrix; along
// z, P = 1 and Q = Y·X, (N, Z)·(Z, Y·X). The DCT sweeps take one B per
// field component (batch = the components).
//
// What bounds it on an H100: the bytes. At the flagship shape (10⁴, 100) ·
// (100, 100), A read once, B once and C written once are 8.04 MB, 0.0024 ms
// at 3.35 TB/s, while the three passes' 6·10⁴·100·100 flops take 0.61 µs at
// the 989 TFLOP/s of dense bf16. So the kernel reads A once and splits it in
// registers on its way into shared memory: building the splits as tensors
// and running three products would move about five times the bytes.
//
// B is a constant at every call site (a DFT, DCT or inverse circulant
// matrix), and every block needs all of its column tile, which is as large
// as the block's rows of A (40 KB of B against 26 KB of A at the flagship).
// Splitting B in each block cost more than A's split, so the wrapper splits
// B once (ops/tier_matmul.py::split_words, kept beside the B tensor) into
// the very layout a block holds in shared memory, and a block copies its
// tile with cp.async while it loads and splits its rows of A. The split is
// the kernel's rounding (bf16 rounded to nearest even, lo of the fp32
// remainder), so the numbers are those of a split in the kernel.
//
// Design, simple first (wgmma and TMA are later work). A block takes 64 rows
// of the product and up to 128 columns: eight warps, four along the rows
// (one m16 tile each) and two along the columns, each warp NT n8 tiles
// (NT a template argument, so that no mma sits under a per-tile condition;
// B's columns beyond N are zero). A's rows and B's tile, up to 128 deep (K
// beyond that runs in chunks), sit in shared memory as hi and lo planes of
// 32-bit words, each word two k-neighbours' bf16 values (the lower k in the
// low half), B transposed (row n, column k), each row padded to ≡ 4 words
// mod 8, so that the eight 16-byte rows of an ldmatrix hit 32 banks; K is
// padded with zeros to a multiple of 16. The fragments come by ldmatrix:
// one x4 for A's 16 × 16, one for two of B's n8 tiles. Each thread loads
// several groups of A before it splits and stores any (their latencies
// overlap), neighbouring threads along A's unit stride: k where A's k
// stride is the smaller one, else the rows; 16 bytes (four k-neighbours) a
// load where A's rows run along k aligned to 16 bytes, else a pair or one
// value. Per 16-deep step each warp runs lo·hi, hi·lo and hi·hi
// (mma.sync.m16n8k16, bf16 in, fp32 accumulators), one term over all its
// tiles at a time, into fresh accumulators that it adds to its running sums
// in fp32, rounded to nearest: the tensor cores add an mma's products to its
// accumulator with truncation relative to the largest addend, so a sum over
// all of K in one accumulator would lose low bits at every step
// (ops/complex_matmul.py, K3, says more). Stores are masked at the ragged
// edges, and 8 bytes wide where two columns are neighbours in C.
//
// Plain C interface for ctypes; each entry returns the cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TBM = 64;                // rows of a block: four m16 tiles
constexpr int WR = 4;                  // warps along the rows
constexpr int WC = 2;                  // warps along the columns
constexpr int THREADS = 32 * WR * WC;
constexpr int TBN = 128;               // columns of a block at most
constexpr int NT_MAX = TBN / 8 / WC;   // n8 tiles per warp at most
constexpr int KC = 128;                // depth held in shared memory at a time
constexpr int LU = 8;                  // pairs a thread loads before it splits any

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// 32-bit words per shared row of a chunk kp deep (kp a multiple of 16):
// kp / 2 + 4 ≡ 4 mod 8
__host__ __device__ inline int row_words(int kp) { return kp / 2 + 4; }

struct Args {
  const float* A;
  const uint32_t* Bw;   // B split: (batch or 1, column tile, K chunk, plane, NP, S) words
  float* C;
  long long P, Q;       // A's row dimensions: row r = (p, q) = (r / Q, r % Q)
  int K, N;
  long long sAb, sAp, sAk, sAq;  // A's strides in floats
  int b_shared;                  // one B for every batch
  int a_k_fast;                  // neighbouring threads load A along k
  int a_pair;                    // a pair of k-neighbours is one aligned 8-byte load
  int a_quad;                    // rows along k, 16-byte aligned: 4 k-neighbours per load
  int c_pair;                    // C's column pairs are aligned neighbours (Q = 1, N even)
  int S;                         // words per shared row
};

// One pair of k-neighbours to stage: its first element (nullptr: zeros),
// the second's offset, whether the second lies inside K, and its word in
// a shared plane.
struct Pair {
  const float* src;
  long long step;
  bool second;
  int word;
};

// float32 → bf16 bits, rounded to nearest even (finite x; an inf stays inf
// and a value that rounds beyond the largest bf16 becomes inf, as the
// conversion does)
__device__ __forceinline__ uint32_t bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// the hi and lo words of the pair (x0, x1), x0 in the low half (the lower k)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t h0 = bf16_rn(x0), h1 = bf16_rn(x1);
  hi = h0 | (h1 << 16);
  lo = bf16_rn(x0 - __uint_as_float(h0 << 16)) | (bf16_rn(x1 - __uint_as_float(h1 << 16)) << 16);
}

// Stages `total` pairs of A into the hi (and, with LO, lo) planes: each
// thread loads LU pairs before it splits and stores any, so that their
// latencies overlap. at(e) describes pair e; pair: a pair is one 8-byte load.
template <bool LO, typename At>
__device__ __forceinline__ void stage(int total, bool pair, At at, uint32_t* hi_plane,
                                      uint32_t* lo_plane) {
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * LU) {
    float x0[LU], x1[LU];
    int word[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int e = e0 + u * THREADS;
      x0[u] = x1[u] = 0.f;
      word[u] = -1;
      if (e < total) {
        const Pair p = at(e);
        word[u] = p.word;
        if (p.src != nullptr) {
          if (pair && p.second) {
            const float2 v = *reinterpret_cast<const float2*>(p.src);
            x0[u] = v.x, x1[u] = v.y;
          } else {
            x0[u] = p.src[0];
            if (p.second) x1[u] = p.src[p.step];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      if (word[u] < 0) continue;
      uint32_t hi, lo;
      split_pair(x0[u], x1[u], hi, lo);
      hi_plane[word[u]] = hi;
      if (LO) lo_plane[word[u]] = lo;
    }
  }
}

// A's rows when they run along k with 16-byte alignment: `quads` groups of
// four k-neighbours (two words), LU / 2 per thread in flight; at(e) gives
// group e's first element (nullptr: zeros), how many of its four lie inside
// K, and its first word.
template <bool LO, typename At>
__device__ __forceinline__ void stage_quads(int quads, At at, uint32_t* hi_plane,
                                            uint32_t* lo_plane) {
  constexpr int U = LU / 2;
  for (int e0 = threadIdx.x; e0 < quads; e0 += THREADS * U) {
    float4 x[U];
    int word[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      word[u] = -1;
      if (e < quads) {
        int inside;
        const float* src = at(e, inside, word[u]);
        if (src != nullptr) {
          if (inside == 4) {
            x[u] = *reinterpret_cast<const float4*>(src);
          } else {
            x[u].x = src[0];
            if (inside > 1) x[u].y = src[1];
            if (inside > 2) x[u].z = src[2];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (word[u] < 0) continue;
      uint2 hi, lo;
      split_pair(x[u].x, x[u].y, hi.x, lo.x);
      split_pair(x[u].z, x[u].w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(hi_plane + word[u]) = hi;
      if (LO) *reinterpret_cast<uint2*>(lo_plane + word[u]) = lo;
    }
  }
}

// The four 8 × 8 b16 matrices at the rows that lanes 0-7, 8-15, 16-23 and
// 24-31 point at, one to each register, in the mma fragment layout
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// two matrices, at the rows lanes 0-7 and 8-15 point at
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1, const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r0), "=r"(r1) : "r"(a) : "memory");
}

// d += a · b for one m16n8k16 tile: a row-major 16 × 16, b column-major 16 × 8
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void copy16_async(uint32_t* dst, const uint4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// PASSES: 3 ("high") or 1 ("default"); NT: n8 tiles per warp.
template <int PASSES, int NT>
__global__ void __launch_bounds__(THREADS, 2) k4_tier_matmul_kernel(Args g) {
  constexpr int NP = NT * WC * 8;  // B rows (columns of the product) held
  constexpr int PLANES = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ long long rowA[TBM], rowC[TBM];
  const int S = g.S;
  uint32_t* sB = smem;                    // PLANES × NP × S: hi, then lo
  uint32_t* sA = smem + PLANES * NP * S;  // PLANES × TBM × S

  const long long M = g.P * g.Q;
  const long long r0 = (long long)blockIdx.x * TBM;
  const int c0 = blockIdx.y * TBN;
  const long long b = blockIdx.z;
  for (int i = threadIdx.x; i < TBM; i += THREADS) {
    const long long r = r0 + i;
    if (r < M) {
      const long long p = r / g.Q, q = r % g.Q;
      rowA[i] = b * g.sAb + p * g.sAp + q * g.sAq;
      rowC[i] = ((b * g.P + p) * g.N) * g.Q + q;
    } else {
      rowA[i] = rowC[i] = -1;
    }
  }
  // this block's column tile of B, split: (K chunk, plane, NP, S) words
  const int nkc = (int)cdiv(g.K, KC);
  const uint32_t* Bw = g.Bw + ((g.b_shared ? 0 : b) * gridDim.y + blockIdx.y) * nkc * 2LL * NP * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % WR, wc = warp / WR;
  const int gq = lane / 4, t = lane % 4;
  float acc[NT][4] = {};

  for (int k0 = 0; k0 < g.K; k0 += KC) {
    const int kp = round16(min(KC, g.K - k0));
    const int words = kp / 2;
    __syncthreads();  // the row offsets are in; every warp is done with the last chunk
    // B's chunk: a copy, in flight while A's rows are loaded and split
    const uint4* src = reinterpret_cast<const uint4*>(Bw + (long long)(k0 / KC) * 2 * NP * S);
    for (int e = threadIdx.x; e < PLANES * NP * S / 4; e += THREADS)
      copy16_async(sB + 4 * e, src + e);
    asm volatile("cp.async.commit_group;" ::: "memory");
    // A's rows of the chunk, split: word (i, w) holds k = k0 + 2w and k0 + 2w + 1
    if (g.a_quad) {
      stage_quads<PASSES == 3>(TBM * words / 2, [&](int e, int& inside, int& word) {
        const int i = e / (words / 2), k = k0 + 4 * (e % (words / 2));
        const long long base = rowA[i];
        inside = min(4, g.K - k);
        word = i * S + (k - k0) / 2;
        return base >= 0 && k < g.K ? g.A + base + k : nullptr;
      }, sA, sA + TBM * S);
    } else {
      stage<PASSES == 3>(TBM * words, g.a_pair, [&](int e) {
        const int i = g.a_k_fast ? e / words : e % TBM;
        const int w = g.a_k_fast ? e % words : e / TBM;
        const long long base = rowA[i];
        const int k = k0 + 2 * w;
        return Pair{base >= 0 && k < g.K ? g.A + base + (long long)k * g.sAk : nullptr, g.sAk,
                    k + 1 < g.K, i * S + w};
      }, sA, sA + TBM * S);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    for (int ks = 0; ks < kp / 16; ++ks) {
      // A fragment (a0 rows 0-7, a1 rows 8-15, a2 and a3 the same 8 deeper):
      // lane l points at row l % 16, k 8·(l / 16)
      const uint32_t* pa = sA + (wr * 16 + lane % 16) * S + ks * 8 + (lane / 16) * 4;
      uint32_t ah[4], al[4] = {};
      ldsm4(ah, pa);
      // B fragments (b0 k 0-7, b1 k 8-15 of n8 tile j), two tiles per ldsm4:
      // lane l points at tile j + l / 16, row l % 8, k 8·((l / 8) % 2)
      uint32_t bh[NT][2], bl[NT][2] = {};
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int tile = j + 1 < NT ? j + lane / 16 : j;
        const uint32_t* pb = sB + ((wc + WC * tile) * 8 + lane % 8) * S + ks * 8 +
                             ((lane / 8) % 2) * 4;
        if (j + 1 < NT) {
          uint32_t r[4];
          ldsm4(r, pb);
          bh[j][0] = r[0], bh[j][1] = r[1], bh[j + 1][0] = r[2], bh[j + 1][1] = r[3];
          if (PASSES == 3) {
            ldsm4(r, pb + NP * S);
            bl[j][0] = r[0], bl[j][1] = r[1], bl[j + 1][0] = r[2], bl[j + 1][1] = r[3];
          }
        } else {
          ldsm2(bh[j][0], bh[j][1], pb);
          if (PASSES == 3) ldsm2(bl[j][0], bl[j][1], pb + NP * S);
        }
      }
      // this step's products in fresh accumulators, the corrections first,
      // one term over all the warp's tiles at a time
      float d[NT][4] = {};
      if (PASSES == 3) {
        ldsm4(al, pa + TBM * S);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(d[j], ah, bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(d[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] += d[j][r];
    }
  }

  // accumulators 2h, 2h + 1: row g + 8h, columns 2t and 2t + 1 of the tile;
  // one 8-byte store where the two are neighbours in C (Q = 1, N even)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wr * 16 + gq + 8 * h;
      const long long off = rowC[i];
      const int col = c0 + (wc + WC * j) * 8 + 2 * t;
      if (off < 0 || col >= g.N) continue;
      if (g.c_pair) {
        *reinterpret_cast<float2*>(g.C + off + col) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        g.C[off + (long long)col * g.Q] = acc[j][2 * h];
        if (col + 1 < g.N) g.C[off + (long long)(col + 1) * g.Q] = acc[j][2 * h + 1];
      }
    }
  }
}

template <int PASSES, int NT>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int NP = NT * WC * 8;
  constexpr int PLANES = PASSES == 3 ? 2 : 1;
  const size_t smem = sizeof(uint32_t) * (size_t)PLANES * (NP + TBM) * a.S;
  const auto kernel = k4_tier_matmul_kernel<PASSES, NT>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)cdiv(a.P * a.Q, TBM), (unsigned)cdiv(a.N, TBN), (unsigned)batch);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int PASSES>
cudaError_t launch_nt(const Args& a, int batch, cudaStream_t stream) {
  // n8 tiles per warp for this many columns per block
  const int nt = (int)cdiv(cdiv(a.N < TBN ? a.N : TBN, 8), WC);
  switch (nt) {
    case 1: return launch<PASSES, 1>(a, batch, stream);
    case 2: return launch<PASSES, 2>(a, batch, stream);
    case 3: return launch<PASSES, 3>(a, batch, stream);
    case 4: return launch<PASSES, 4>(a, batch, stream);
    case 5: return launch<PASSES, 5>(a, batch, stream);
    case 6: return launch<PASSES, 6>(a, batch, stream);
    case 7: return launch<PASSES, 7>(a, batch, stream);
    case NT_MAX: return launch<PASSES, NT_MAX>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* k4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The words per shared row of B's layout for depth K (split_words in
// ops/tier_matmul.py lays B out so): S = round16(min(K, 128)) / 2 + 4.
int k4_row_words(int K) { return row_words(round16(K < KC ? K : KC)); }

// C (batch, P, N, Q) contiguous = A (batch, P, K, Q) · B (batch or 1, K, N),
// A's strides in floats, B split by split_words; passes 3 ("high", bf16×3)
// or 1 ("default", one bf16 pass). batch ≤ 65535; P, Q, K, N ≥ 1.
int k4_tier_matmul(const void* A, const void* Bw, void* C, int batch, long long P, int K,
                   long long Q, int N, long long sAb, long long sAp, long long sAk,
                   long long sAq, int b_shared, int passes, int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || batch > 65535 || P < 1 || Q < 1 || K < 1 || N < 1)
    return cudaErrorInvalidValue;
  Args a;
  a.A = static_cast<const float*>(A);
  a.Bw = static_cast<const uint32_t*>(Bw);
  a.C = static_cast<float*>(C);
  a.P = P, a.Q = Q, a.K = K, a.N = N;
  a.sAb = sAb, a.sAp = sAp, a.sAk = sAk, a.sAq = sAq;
  a.b_shared = b_shared;
  a.a_k_fast = sAk <= (Q > 1 ? sAq : sAp);
  const auto even = [](long long s) { return s % 2 == 0; };
  a.a_pair = sAk == 1 && even(sAb) && even(sAp) && (Q == 1 || even(sAq)) &&
             reinterpret_cast<uintptr_t>(A) % 8 == 0;
  const auto by4 = [](long long s) { return s % 4 == 0; };
  a.a_quad = sAk == 1 && a.a_k_fast && by4(sAb) && by4(sAp) && (Q == 1 || by4(sAq)) &&
             reinterpret_cast<uintptr_t>(A) % 16 == 0;
  a.c_pair = Q == 1 && N % 2 == 0;  // C from torch.empty: aligned
  a.S = k4_row_words(K);
  if (passes == 3) return launch_nt<3>(a, batch, stream);
  if (passes == 1) return launch_nt<1>(a, batch, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
