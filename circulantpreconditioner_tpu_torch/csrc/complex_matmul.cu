// Kernel K3: (O_re + i O_im) = (A_re + i A_im) · (B_re + i B_im) for an
// (M, K) · (K, N) complex product held as separate real and imaginary planes.
//
// Replaces circulantpreconditioner_tpu/ops/pallas_kernels.py::_cmm_kernel
// (`complex_matmul`), which the staged DFT solver calls on its y and z stages
// (ops/dft_matmul.py, MatmulCirculantSolver(use_kernel=True)): A is the
// spectrum collapsed to (rows, n), B the n × n DFT matrix, n ≤ 128 (M = 8320,
// K = N = 128 at 128³; M = 5100, K = N = 100 at 100³). The TPU kernel reads
// each A tile once for all four real products and keeps both accumulators on
// chip across the K loop; so does this kernel. It runs one bf16 pass on the
// TPU (`jnp.dot` with no precision argument).
//
// float32: 3×TF32 on the tensor cores. Each operand x is split at fragment
// load into x_hi = tf32(x) and x_lo = tf32(x − x_hi), tf32 rounding to
// nearest at 10 mantissa bits as cvt.rna.tf32.f32 does, and each real
// product is a_hi·b_hi + a_hi·b_lo + a_lo·b_hi by mma.sync.m16n8k8 (tf32
// inputs, fp32 accumulators). The direct form's four real products make 12
// tensor-core products per 8-deep step; Gauss's 9 would add the roundoff of
// A_re + A_im and B_re + B_im. Error against float64 with a DFT matrix as B,
// emulated on the CPU with sums rounded to nearest
// (ops/complex_matmul.py::complex_matmul_tf32x3_emulation,
// tests/test_torch_tf32_split.py): 3.7e-7 · max|o| at (8320,128)·(128,128)
// and 3.1e-7 at (5100,100)·(100,100), as plain fp32 (3.8e-7, 3.1e-7); one
// TF32 pass errs by 2.5e-4 and 2.7e-4, above the 1e-5 gates. The tensor cores add an
// mma's products to its accumulator with truncation relative to the largest
// addend, so a sum over all of K in one accumulator loses low bits at every
// step, most in a spectrum's DC row, the largest value of a stage: the
// staged solve's five transport steps then left the cuFFT solve's by more
// than 1e-5. So each 8-deep step's 12 products go to a fresh accumulator,
// corrections first, and that step's sum is added to the running sum in
// fp32, rounded to nearest (chip_smoke.py phase 11 holds K3 to float64).
//
// What bounds it on an H100: the bytes, 4·2·(MK + KN + MN) over 3.35 TB/s
// (17.17 MB, 5.1 µs at 128³; 8.24 MB, 2.5 µs at 100³), just above the 3
// products of Gauss's form at fp32 accuracy, 3 × 6·M·K·N flops over 495
// TFLOP/s of dense TF32 (5.0 and 1.9 µs). This kernel's 12 products take
// 24·M·K·N flops: 6.6 µs at 128³, 2.5 µs at 100³ (chip_smoke.py phase 14).
// mma.sync runs below wgmma's rate, and every fragment is split by the warp
// that loads it (two integer instructions and a subtraction per rounding),
// so the instruction slots of a sub-partition, not the bytes, hold it.
//
// Tiles and grid. B is small (K = N = n ≤ 128) and every row of A needs all
// of it, so a block keeps both planes of a column tile of B (up to 128
// columns, padded to the instruction's multiple of 8: 104 for n = 100) and up
// to 128 rows of K whole in shared memory, 139 KB at n = 128, 87 KB at 100,
// as fp32. The unit of work is 16 rows of A (one m16 tile) by all columns of
// the tile, taken by a group of four warps that share the A tile and split
// the n8 tiles between them, interleaved (4, 3, 3, 3 of the 13 at n = 100),
// with the first tile rotated by group so that each SM sub-partition (warp
// mod 4) gets a mix of wide and narrow warps. A warp's tile count is a
// template argument of its inner loop: an mma under a per-tile condition
// costs a WARPSYNC. A block holds four groups, each streaming its A rows
// through its own 3-stage cp.async ring of 32-deep slices, synchronised by
// its own named barrier; B's rows come in with the first unit's slices, so
// the products start once its first 32 rows are in. The blocks are
// persistent, as many as fit on the SMs (one per SM: 512 threads of at most
// 128 registers), and unit u goes to group u / G of block u mod G, so units
// spread over all SMs first: 319 units at 100³ give every SM 2 or 3, 520 at
// 128³ give 3 or 4. Row tiles of 64 would give 80 units at 100³, idling 52
// of the 132 SMs; a grid of one block per 16 rows would read B from L2 319
// times. Shared-memory strides make every fragment load conflict-free: 36
// floats for A rows (≡ 4 mod 32), ≡ 8 mod 32 for B rows. K beyond 128 runs in
// chunks of 128, B reloaded per chunk and O read back and accumulated; N
// beyond 128 takes more column tiles (grid y). Ragged edges are zero-filled
// on load (cp.async with a source size of 0) and masked on store; stores
// are column pairs (8 bytes) where N is even. 16-byte copies where K and N
// are multiples of 4 and the operands 16-byte aligned, else 4-byte copies.
//
// float64: the CUDA-core body: 64 × 64 output tiles, 16-deep shared-memory
// slices of all four planes, a 4 × 4 register micro-tile of both accumulators
// per thread, ragged edges masked.
//
// Plain C interface for ctypes; each entry returns the cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// --- float32: 3×TF32 on the tensor cores --------------------------------------

constexpr int TBM = 16;                   // rows of a unit: one m16 tile
constexpr int GW = 4;                     // warps per unit, splitting its n8 tiles
constexpr int NGROUP = 4;                 // units in flight per block
constexpr int TF_THREADS = 32 * GW * NGROUP;
constexpr int TBN = 128;                  // columns per column tile
constexpr int NJ = TBN / 8 / GW;          // n8 tiles per warp at most
constexpr int TBK = 32;                   // depth of an A slice
constexpr int SA = TBK + 4;               // A row stride (≡ 4 mod 32)
constexpr int NSTAGE = 3;                 // A ring depth
constexpr int KC_MAX = 128;               // B rows held per chunk
constexpr int RING = NSTAGE * 2 * TBM * SA;  // floats of one group's A ring

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// B row stride for np columns: ≥ np and ≡ 8 mod 32, so lanes (k = t, n = g)
// of a fragment load hit 32 different banks
__host__ __device__ inline int b_stride(int np) { return np + ((8 - np % 32) + 32) % 32; }

// float32 → TF32 rounded to nearest, ties away from zero: cvt.rna.tf32.f32's
// rounding of finite values, in two integer instructions (cvt also tests
// for inf and NaN; an inf or NaN input gives a NaN lo and so a NaN product
// either way)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a · b for one m16n8k8 tile: a row-major 16 × 8, b column-major 8 × 8
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// VEC: 4 floats from src to dst (16-byte aligned), else one; zero-filled
// where !ok (a source size of 0 reads nothing)
template <bool VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void group_barrier(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(32 * GW) : "memory");
}

// One slice (TBM rows × TBK columns, both planes) of A into the ring buffer
// `buf`, by the 32·GW threads of a group (gt = thread index in the group).
template <bool VEC>
__device__ __forceinline__ void load_a_slice(float* buf, const float* __restrict__ Are,
                                             const float* __restrict__ Aim, int i0, int k0,
                                             int M, int K, int gt) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int PER_ROW = TBK / W;
#pragma unroll
  for (int q = 0; q < 2 * TBM * PER_ROW / (32 * GW); ++q) {
    const int e = gt + q * 32 * GW;
    const int plane = e / (TBM * PER_ROW);
    const int r = (e / PER_ROW) % TBM, c = (e % PER_ROW) * W;
    const bool ok = i0 + r < M && k0 + c < K;
    const float* src = (plane ? Aim : Are) + (ok ? (long)(i0 + r) * K + k0 + c : 0);
    copy_async<VEC>(buf + (plane * TBM + r) * SA + c, src, ok);
  }
}

// Rows r0 .. r0 + rows of a chunk of B (chunk rows from k0; np columns
// from c0; both planes) into sB (row stride S, plane stride PS floats), by
// the whole block; zero beyond K and N.
template <bool VEC>
__device__ __forceinline__ void load_b_rows(float* sB, const float* __restrict__ Bre,
                                            const float* __restrict__ Bim, int k0, int r0,
                                            int rows, int c0, int np, int S, int PS, int N,
                                            int K) {
  constexpr int W = VEC ? 4 : 1;
  const int per_row = np / W;
  for (int e = threadIdx.x; e < 2 * rows * per_row; e += TF_THREADS) {
    const int plane = e / (rows * per_row);
    const int r = r0 + (e / per_row) % rows, c = (e % per_row) * W;
    const bool ok = k0 + r < K && c0 + c < N;
    const float* src = (plane ? Bim : Bre) + (ok ? (long)(k0 + r) * N + c0 + c : 0);
    copy_async<VEC>(sB + plane * PS + r * S + c, src, ok);
  }
}

// A warp's sums over K for the real and imaginary planes of its n8 tiles,
// added to in fp32 (rounded to nearest) once per 8-deep step. The tensor
// cores add an mma's products to its accumulator with truncation, relative
// to the largest addend, so each step's 12 products go to a fresh
// accumulator: its truncation is relative to one step's sum, not to the
// sum over K (which for a spectrum's DC row is the largest value of all).
struct Acc {
  float re[NJ][4], im[NJ][4];
};

// The products of one A slice (rows of a unit, `depth` deep, both planes in
// sAre and sAim) with B rows kb0.. into the warp's NW n8 tiles
// (wn, wn + GW, ...). NW is a template parameter, so that no mma sits
// under a per-tile condition (which costs a WARPSYNC each).
template <int NW>
__device__ __forceinline__ void slice_products(Acc& acc, const float* sAre, const float* sAim,
                                               const float* sBre, const float* sBim, int S,
                                               int kb0, int depth, int wn, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < TBK; kk += 8) {
    if (kk >= depth) break;
    // A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
    const int ia = g * SA + kk + t;
    const int offs[4] = {ia, ia + 8 * SA, ia + 4, ia + 8 * SA + 4};
    uint32_t arh[4], arl[4], aih[4], ail[4], naih[4], nail[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split(sAre[offs[r]], arh[r], arl[r]);
      split(sAim[offs[r]], aih[r], ail[r]);
      naih[r] = aih[r] ^ 0x80000000u;  // −A_im, exact
      nail[r] = ail[r] ^ 0x80000000u;
    }
    // one term over all the warp's n8 tiles at a time, so that
    // neighbouring products feed different accumulators
    float pre[NW][4] = {}, pim[NW][4] = {};  // this step's products
    uint32_t bh[NW][2], bl[NW][2];
    auto term = [&](float (&c)[NW][4], const uint32_t (&a)[4], const uint32_t (&b)[NW][2]) {
#pragma unroll
      for (int j = 0; j < NW; ++j) mma(c[j], a, b[j][0], b[j][1]);
    };
    // one plane of B at a time: b0 (k = t, n = g), b1 (k = t + 4, n = g)
    auto load_b = [&](const float* sB) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int ib = (kb0 + kk + t) * S + (wn + GW * j) * 8 + g;
        split(sB[ib], bh[j][0], bl[j][0]);
        split(sB[ib + 4 * S], bh[j][1], bl[j][1]);
      }
    };
    // O_re += A_re·B_re − A_im·B_im; O_im += A_re·B_im + A_im·B_re, the
    // lo·hi and hi·lo corrections before hi·hi
    load_b(sBre);
    term(pre, arl, bh), term(pim, ail, bh);
    term(pre, arh, bl), term(pim, aih, bl);
    term(pre, arh, bh), term(pim, aih, bh);
    load_b(sBim);
    term(pre, nail, bh), term(pim, arl, bh);
    term(pre, naih, bl), term(pim, arh, bl);
    term(pre, naih, bh), term(pim, arh, bh);
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.re[j][r] += pre[j][r], acc.im[j][r] += pim[j][r];
  }
}

// f(std::integral_constant<int, n>{}) for a runtime n in 1..N
template <int N, typename F>
__device__ __forceinline__ void dispatch(int n, F& f) {
  if constexpr (N > 0) {
    if (n == N)
      f(std::integral_constant<int, N>{});
    else
      dispatch<N - 1>(n, f);
  }
}

// Persistent blocks: block (bx, by) owns column tile by and the units
// u = bx + G·grp + G·NGROUP·j of its four groups (G = gridDim.x).
template <bool VEC>
__global__ void __launch_bounds__(TF_THREADS, 1) k3_cmm_tf32x3(
    const float* __restrict__ Are, const float* __restrict__ Aim, const float* __restrict__ Bre,
    const float* __restrict__ Bim, float* __restrict__ Ore, float* __restrict__ Oim, int M,
    int N, int K, int KC) {
  extern __shared__ __align__(16) float smem[];
  const int c0 = blockIdx.y * TBN;
  const int np = round8(min(TBN, N - c0));
  const int nt8 = np / 8;
  const int S = b_stride(np);
  const float* sBre = smem;
  const float* sBim = smem + KC * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / GW;
  // the warp's first n8 tile, rotated by group so that every SM sub-partition
  // (warp mod 4) gets a share of the wider and the narrower tile sets
  const int wn = (warp + grp) % GW;
  const int g = lane / 4, t = lane % 4;
  const int gt = threadIdx.x - grp * 32 * GW;
  const int nw = (nt8 - wn + GW - 1) / GW;  // this warp's n8 tiles: wn, wn + GW, ...
  float* ring = smem + 2 * KC * S + grp * RING;

  const int units = cdiv(M, TBM);
  const int first = blockIdx.x + grp * gridDim.x;
  const int stride = gridDim.x * NGROUP;
  const int mine = first < units ? (units - 1 - first) / stride + 1 : 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kcp = round8(min(KC, K - k0));
    const int nslices = cdiv(kcp, TBK);
    const int steps = mine * nslices;
    // The first nslices steps also bring B's rows, slice by slice, so that
    // the products start when its first 32 rows are in; every group takes
    // part in them, with units or without.
    const int bsteps = max(steps, nslices);
    auto load_step = [&](int s) {
      if (s < nslices)
        load_b_rows<VEC>(smem, Bre, Bim, k0, s * TBK, min(TBK, kcp - s * TBK), c0, np, S,
                         KC * S, N, K);
      if (s < steps) {
        const int u = first + (s / nslices) * stride, q = s % nslices;
        load_a_slice<VEC>(ring + (s % NSTAGE) * 2 * TBM * SA, Are, Aim, u * TBM, k0 + q * TBK,
                          M, K, gt);
      }
    };

    __syncthreads();  // every group is done with the previous chunk's B
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      load_step(s);
      commit();
    }

    Acc acc = {};

    for (int s = 0; s < bsteps; ++s) {
      wait_groups<NSTAGE - 2>();
      // slice s (and B's slice s) is in; the group (or block) is done with
      // slice s − 1, whose buffer the next load takes
      if (s < nslices)
        __syncthreads();
      else
        group_barrier(grp);
      load_step(s + NSTAGE - 1);
      commit();
      if (s >= steps) continue;

      const int q = s % nslices;
      const float* sAre = ring + (s % NSTAGE) * 2 * TBM * SA;
      const float* sAim = sAre + TBM * SA;
      const int depth = min(TBK, kcp - q * TBK);  // a multiple of 8
      auto products = [&](auto nw_c) {
        slice_products<decltype(nw_c)::value>(acc, sAre, sAim, sBre, sBim, S,
                                              q * TBK, depth, wn, g, t);
      };
      dispatch<NJ>(nw, products);  // nothing for a warp with no n8 tile (N ≤ 24)

      if (q == nslices - 1) {  // the unit's last slice of this chunk: store
        const int i0 = (first + (s / nslices) * stride) * TBM;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nw) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // accumulators 2h, 2h + 1: row g + 8h, columns 2t and 2t + 1
            const int i = i0 + g + 8 * h, c = c0 + (wn + GW * j) * 8 + 2 * t;
            float2 re = {acc.re[j][2 * h], acc.re[j][2 * h + 1]};
            float2 im = {acc.im[j][2 * h], acc.im[j][2 * h + 1]};
            const long off = (long)i * N + c;
            if (i >= M || c >= N) continue;
            if (N % 2 == 0) {  // c even: both columns, 8-byte aligned
              if (k0 > 0) {  // a later chunk of K: add to this thread's own earlier store
                const float2 pr = *reinterpret_cast<const float2*>(Ore + off);
                const float2 pi = *reinterpret_cast<const float2*>(Oim + off);
                re.x += pr.x, re.y += pr.y, im.x += pi.x, im.y += pi.y;
              }
              *reinterpret_cast<float2*>(Ore + off) = re;
              *reinterpret_cast<float2*>(Oim + off) = im;
            } else {
              const bool two = c + 1 < N;
              if (k0 > 0) {
                re.x += Ore[off], im.x += Oim[off];
                if (two) re.y += Ore[off + 1], im.y += Oim[off + 1];
              }
              Ore[off] = re.x, Oim[off] = im.x;
              if (two) Ore[off + 1] = re.y, Oim[off + 1] = im.y;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc.re[j][r] = acc.im[j][r] = 0.f;
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_tf32x3(const float* Are, const float* Aim, const float* Bre, const float* Bim,
                          float* Ore, float* Oim, int M, int N, int K, int device,
                          cudaStream_t stream) {
  const int KC = round8(K < KC_MAX ? K : KC_MAX);
  const int S = b_stride(round8(N < TBN ? N : TBN));
  const size_t smem = sizeof(float) * ((size_t)2 * KC * S + (size_t)NGROUP * RING);
  const auto kernel = k3_cmm_tf32x3<VEC>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TF_THREADS, smem);
  if (err != cudaSuccess) return err;
  const int units = cdiv(M, TBM);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(units < slots ? units : slots, cdiv(N, TBN));
  kernel<<<grid, TF_THREADS, smem, stream>>>(Are, Aim, Bre, Bim, Ore, Oim, M, N, K, KC);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* Are, const void* Aim, const void* Bre, const void* Bim,
                       void* Ore, void* Oim, int M, int N, int K, int device,
                       cudaStream_t stream) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = K % 4 == 0 && N % 4 == 0 && a16(Are) && a16(Aim) && a16(Bre) && a16(Bim);
  const auto* ar = static_cast<const float*>(Are);
  const auto* ai = static_cast<const float*>(Aim);
  const auto* br = static_cast<const float*>(Bre);
  const auto* bi = static_cast<const float*>(Bim);
  auto* o_re = static_cast<float*>(Ore);
  auto* o_im = static_cast<float*>(Oim);
  return vec ? launch_tf32x3<true>(ar, ai, br, bi, o_re, o_im, M, N, K, device, stream)
             : launch_tf32x3<false>(ar, ai, br, bi, o_re, o_im, M, N, K, device, stream);
}

// --- float64: the CUDA-core body ------------------------------------------------

constexpr int BM = 64;   // output rows per block tile
constexpr int BN = 64;   // output columns per block tile
constexpr int BK = 16;   // contraction slice staged per step
constexpr int NT = 256;  // threads per block: 16 × 16, each a 4 × 4 micro-tile
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;   // keeps the transposed A stores to 2-way bank conflicts

__device__ __forceinline__ void load4(const double* p, double (&r)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
}

// One block computes O[i0:i0+64, c0:c0+64] of both planes. A, B, O are
// row-major and contiguous: A(i, j) = A[i·K + j], B(j, c) = B[j·N + c].
__global__ void __launch_bounds__(NT) k3_cmm_f64(const double* __restrict__ Are,
                                                 const double* __restrict__ Aim,
                                                 const double* __restrict__ Bre,
                                                 const double* __restrict__ Bim,
                                                 double* __restrict__ Ore,
                                                 double* __restrict__ Oim, int M, int N, int K) {
  using T = double;
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
          are[m][n] = fma(ar[m], br[n], fma(-ai[m], bi[n], are[m][n]));
          aim[m][n] = fma(ar[m], bi[n], fma(ai[m], br[n], aim[m][n]));
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

cudaError_t launch_f64(const void* Are, const void* Aim, const void* Bre, const void* Bim,
                       void* Ore, void* Oim, int M, int N, int K, cudaStream_t stream) {
  k3_cmm_f64<<<dim3(cdiv(N, BN), cdiv(M, BM)), NT, 0, stream>>>(
      static_cast<const double*>(Are), static_cast<const double*>(Aim),
      static_cast<const double*>(Bre), static_cast<const double*>(Bim),
      static_cast<double*>(Ore), static_cast<double*>(Oim), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32 (3×TF32 on the tensor cores), 1 float64 (CUDA cores).
// M rows ≤ 65535 · 64 (the float64 grid's y extent).
int k3_complex_matmul(const void* Are, const void* Aim, const void* Bre, const void* Bim,
                      void* Ore, void* Oim, int M, int N, int K, int dtype, int device,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0) return launch_f32(Are, Aim, Bre, Bim, Ore, Oim, M, N, K, device, stream);
  if (dtype == 1) return launch_f64(Are, Aim, Bre, Bim, Ore, Oim, M, N, K, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
