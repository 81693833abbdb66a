"""Fused 3D circulant solve: kernel K1, hand-written in CUDA C++ for Hopper.

PyTorch counterpart of circulantpreconditioner_tpu/ops/fused_circulant.py,
whose Pallas kernel `_solve3d_kernel` keeps the whole field in TPU VMEM and
runs every transform as a dense DFT contraction on the matrix unit. On an
H100 that O(n²) work is the cost (2.04 GFLOP at 100³), while the function,
x = C⁻¹ b, needs only its bytes: b in, 1/Λ in, x out. So K1 computes the
same result by O(n log n) mixed-radix FFTs over lines held in shared memory,
in five passes of csrc/fused_circulant.cu:

    x forward   per tile of (z, y) rows: FFT of the real row, keep nxr bins
    y forward   per tile of (z, kx) lines along y
    z           per tile of (ky, kx) pencils: FFT along z → × 1/Λ → inverse
    y inverse   as y forward, conjugated twiddles
    x inverse   hermitian rows expanded to nx, inverse FFT, real part

The half spectrum (nz, ny, nxr) stays in two complex scratch buffers that
fit the 50 MB L2 at 100³. Where a z-plane fits a block's shared memory and
nz ≥ 64, the x and y passes of each direction run as one launch per plane,
two real rows per complex x line (`PLANE_PASSES`): three launches in all. A
line too long for a block's shared memory (x or y beyond a few thousand
points) takes the same stages one launch each over device memory.

The plan (`_np_fft_plan`) factors each axis length into radices 4, 2, 3 and
5 and at most one leftover factor p, done as a direct length-p DFT stage, so
every length works, primes included, at O(n·p) for that stage. Its twiddles
are built in float64 with NumPy and cast to the solver's dtype; the inverse
conjugates them. The 1/(nx·ny·nz) of the inverse transforms is folded into
the kernel's 1/Λ table. `fft_plan_reference` runs a plan's stages in plain
PyTorch in the kernel's order, and `k1_passes_reference` the kernel's five
passes; the CPU tests and chip_smoke.py's per-pass checks use them.

`fused_circulant_reference` is K1's plain PyTorch version: the 14 dense DFT
tables of the JAX package (kept for it and for `from_numpy_arrays`) and the
same stage order, by `torch.matmul` in the input's dtype.
`FusedCirculantSolver.solve` takes the plain version only for a CPU tensor;
for a CUDA tensor it launches K1 or raises.

Precision tiers: all three compute in float32 on the CUDA cores, at least as
accurate as each TPU tier: the JAX kernel's tiers are those of its DFT
matmuls (`_mk_ops`), and an FFT has none; the plain version's dense tables
run fp32 in every tier too. Size limit: the z pass holds whole pencils in
shared memory, so nz ≤ MAX_NZ.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.circulant import (
    CirculantTransportOperator,
    np_eigenvalue_diagonal,
)
from circulantpreconditioner_tpu_torch.ops.dft_matmul import (
    MatmulCirculantSolver,
    _np_dft_mats,
    _np_rdft_mats,
    _to,
)
from circulantpreconditioner_tpu_torch.utils.device import (
    check_precision,
    check_real_dtype,
    complex_dtype,
)

# the z pass keeps 16 pencils of nz points three times (Stockham ping-pong,
# and their 1/Λ) in a block's 227 KB of shared memory
MAX_NZ = 400
SMALL_RADICES = (4, 2, 3, 5)
MAX_STAGES = 32  # = MAX_STAGES in csrc/fused_circulant.cu
PASSES = ("x forward", "y forward", "z", "y inverse", "x inverse")
ALL_PASSES = (1 << len(PASSES)) - 1
# pass masks that run as one launch per z-plane where the plane form applies
PLANE_PASSES = {"x+y forward per plane": 0b00011, "y+x inverse per plane": 0b11000}

TABLE_NAMES = ("F_re", "F_im", "Cy", "Sy", "Cz", "Sz", "ire", "iim",
               "Ciz", "Siz", "Ciy", "Siy", "B_re", "B_im")


def _cstage(re, im, C, S):
    """(re + i·im) ← T·(re + i·im) with T[k, j] = (C + i·S)[j, k]: the DFT
    contracts the second-to-last axis."""
    Ct, St = C.T, S.T
    return Ct @ re - St @ im, St @ re + Ct @ im


def fused_circulant_reference(g: torch.Tensor, tables: Sequence[torch.Tensor],
                              precision: str = "high") -> torch.Tensor:
    """Plain version of K1: g (nz, ny, nx) → x = C⁻¹ g by the 14 dense DFT
    tables, in g's dtype for every tier."""
    check_precision(precision)
    F_re, F_im, Cy, Sy, Cz, Sz, ire, iim, Ciz, Siz, Ciy, Siy, B_re, B_im = tables
    nz, ny, nx = g.shape
    nxr = nx // 2 + 1
    rows = g.reshape(nz * ny, nx)
    re = (rows @ F_re).reshape(nz, ny, nxr)                 # x forward (half spectrum)
    im = (rows @ F_im).reshape(nz, ny, nxr)
    re, im = _cstage(re, im, Cy, Sy)                         # y forward
    re, im = _cstage(re.reshape(nz, ny * nxr), im.reshape(nz, ny * nxr), Cz, Sz)  # z forward
    lr, li = ire.reshape(nz, ny * nxr), iim.reshape(nz, ny * nxr)
    re, im = re * lr - im * li, re * li + im * lr           # × 1/Λ
    re, im = _cstage(re, im, Ciz, Siz)                       # z inverse
    re, im = _cstage(re.reshape(nz, ny, nxr), im.reshape(nz, ny, nxr), Ciy, Siy)  # y inverse
    x = re.reshape(nz * ny, nxr) @ B_re + im.reshape(nz * ny, nxr) @ B_im  # x inverse
    return x.reshape(nz, ny, nx)


# --- the FFT plan ---------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class FFTPlan:
    """Stockham plan of a length-n complex DFT. Stage s has radix R and
    Ns = the product of the earlier radices; its twiddles are Ns·R entries
    of `table`, stage after stage: w^{r·k} at k·R + r, w = e^{−2πi/(Ns·R)},
    for a radix of SMALL_RADICES; for the leftover factor p, always the
    first stage (Ns = 1), the p roots e^{−2πi·m/p}, so its DFT reads the
    twiddle of r·q at (r·q) mod p."""

    n: int
    radices: tuple[int, ...]
    table: np.ndarray  # complex128, the forward direction

    def stages(self):
        """(R, Ns, the stage's twiddles) in the kernel's order."""
        ns, off = 1, 0
        for r in self.radices:
            yield r, ns, self.table[off:off + ns * r]
            off += ns * r
            ns *= r


def _np_fft_plan(n: int) -> FFTPlan:
    n = int(n)
    if n < 1:
        raise ValueError(f"an FFT plan needs a length ≥ 1, got {n}")
    rest, small = n, []
    for r in SMALL_RADICES:  # 4s first, then at most one 2, then 3s and 5s
        while rest % r == 0:
            small.append(r)
            rest //= r
    radices = ([rest] if rest > 1 else []) + small
    parts, ns = [], 1
    for r in radices:
        if r in SMALL_RADICES:
            k, q = np.arange(ns)[:, None], np.arange(r)[None, :]
            parts.append(np.exp(-2j * np.pi * (k * q) / (ns * r)).reshape(-1))
        else:
            parts.append(np.exp(-2j * np.pi * np.arange(r) / r))
        ns *= r
    table = np.concatenate(parts) if parts else np.zeros(0, np.complex128)
    return FFTPlan(n, tuple(radices), table)


def _radix_dft(R: int, inverse: bool) -> np.ndarray:
    q = np.arange(R)
    return np.exp((2j if inverse else -2j) * np.pi * np.outer(q, q) / R)


def fft_plan_reference(lines: torch.Tensor, plan: FFTPlan, inverse: bool = False
                       ) -> torch.Tensor:
    """The plan's stages on complex `lines` (..., n), in plain PyTorch, in the
    kernel's order, with the plan's twiddles cast to the lines' dtype:
    the unnormalised DFT along the last axis (e^{+2πi} when inverse)."""
    lead, n = lines.shape[:-1], plan.n
    if lines.shape[-1] != n:
        raise ValueError(f"lines of {lines.shape[-1]} points for a plan of {n}")
    a = lines.reshape(-1, n)
    B = a.shape[0]
    as_t = lambda v: torch.as_tensor(v, device=a.device).to(a.dtype)  # noqa: E731
    for R, ns, tw in plan.stages():
        m = n // R
        v = a.reshape(B, R, m)                                    # element j + r·m
        if R in SMALL_RADICES:
            t = as_t(tw).reshape(ns, R)[torch.arange(m, device=a.device) % ns].T
            v = v * (t.conj() if inverse else t)                 # × w^{r·k}, k = j mod Ns
            W = as_t(_radix_dft(R, inverse))
        else:
            W = as_t(tw)[torch.as_tensor(np.outer(np.arange(R), np.arange(R)) % R,
                                         device=a.device)]
            W = W.conj() if inverse else W
        out = torch.einsum("brj,rq->bqj", v, W)                   # output q of butterfly j
        # to (j − k)·R + k + q·Ns with j = jh·Ns + k: the Stockham reorder
        a = out.reshape(B, R, m // ns, ns).permute(0, 2, 1, 3).reshape(B, n)
    return a.reshape(lead + (n,))


class K1Plan:
    """What K1 reads besides b: the three axis plans, their twiddles as
    (len, 2) real tensors, 1/Λ/(nx·ny·nz) as (nz, ny, nxr, 2), and the host
    int descriptor of the stages."""

    def __init__(self, shape_zyx, axes: tuple[FFTPlan, FFTPlan, FFTPlan],
                 inv_lam: np.ndarray, *, device: torch.device, dtype: torch.dtype):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.axes = axes  # x, y, z
        pair = lambda c: np.stack([c.real, c.imag], -1)  # noqa: E731
        self.tables = tuple(_to(np.ascontiguousarray(pair(t)), device, dtype)
                            for t in (*(p.table for p in axes), inv_lam))
        ints = []
        for p in axes:
            ints += [p.n, len(p.radices), *p.radices, *[0] * (MAX_STAGES - len(p.radices))]
        self.ints = (ctypes.c_int * len(ints))(*ints)
        self._scratch_floats = None

    @classmethod
    def from_numpy(cls, shape_zyx, ire: np.ndarray, iim: np.ndarray, *,
                   device: torch.device, dtype: torch.dtype):
        """From Re and Im of 1/Λ on the (nz, ny, nxr) half spectrum, float64."""
        nz, ny, nx = shape_zyx
        inv_lam = (np.asarray(ire) + 1j * np.asarray(iim)) / (nx * ny * nz)
        return cls(shape_zyx, (_np_fft_plan(nx), _np_fft_plan(ny), _np_fft_plan(nz)),
                   inv_lam, device=device, dtype=dtype)

    def scratch_floats(self, lib) -> int:
        """Floats of scratch one solve needs (the library's rule)."""
        if self._scratch_floats is None:
            nz, ny, nx = self.shape_zyx
            floats = int(lib.k1_scratch_floats(self.ints, nz, ny, nx))
            if floats < 0:
                raise ValueError(f"K1 refused the plan of shape {self.shape_zyx}")
            self._scratch_floats = floats
        return self._scratch_floats


def k1_passes_reference(g: torch.Tensor, plan: K1Plan) -> list[torch.Tensor]:
    """K1's five passes in plain PyTorch (`fft_plan_reference` per axis), on
    the plan's tables in g's dtype: the output of each pass, the four half
    spectra (nz, ny, nxr) complex and x (nz, ny, nx)."""
    nz, ny, nx = plan.shape_zyx
    nxr = nx // 2 + 1
    px, py, pz = plan.axes
    lam = torch.view_as_complex(plan.tables[3].to(g.device, g.dtype).contiguous())
    fft = fft_plan_reference
    s1 = fft(g.reshape(nz, ny, nx).to(complex_dtype(g.dtype)), px)[..., :nxr]
    s2 = fft(s1.transpose(1, 2), py).transpose(1, 2)
    z = fft(s2.permute(1, 2, 0), pz) * lam.permute(1, 2, 0)
    s3 = fft(z, pz, inverse=True).permute(2, 0, 1)
    s4 = fft(s3.transpose(1, 2), py, inverse=True).transpose(1, 2)
    # the hermitian row: Im of bin 0 and of bin nx/2 (even nx) dropped
    k = torch.arange(nxr, device=g.device)
    drop = (k == 0) | (2 * k == nx)
    half = torch.where(drop, s4.real.to(s4.dtype), s4)
    mirror = torch.arange(1, (nx + 1) // 2, device=g.device)  # bins with a conjugate twin
    full = torch.cat([half, half[..., mirror].conj().flip(-1)], -1)
    x = fft(full, px, inverse=True).real
    return [s1, s2, s3, s4, x.contiguous()]


# --- the kernel ----------------------------------------------------------------

def _check_kernel_inputs(g: torch.Tensor, plan: K1Plan) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"K1 needs a CUDA tensor, got one on {g.device}")
    if not isinstance(plan, K1Plan):
        raise ValueError(f"K1 needs the solver's K1Plan, got {type(plan).__name__}")
    if g.ndim != 3 or tuple(g.shape) != plan.shape_zyx:
        raise ValueError(f"K1: g has shape {tuple(g.shape)}, expected {plan.shape_zyx}")
    nz, ny, nx = g.shape
    if nz > MAX_NZ:
        raise ValueError(f"K1 holds nz ≤ {MAX_NZ} planes in shared memory, got nz={nz}")
    if nz * ny * (nx + 2) >= 2**31:
        raise ValueError(f"K1 counts points in 32-bit ints; shape {tuple(g.shape)} is too large")
    names = ("g", "twiddles x", "twiddles y", "twiddles z", "1/Λ")
    for name, t in zip(names, (g, *plan.tables)):
        if t.device != g.device:
            raise ValueError(f"K1: {name} is on {t.device}, g on {g.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"K1 computes in float32 only; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")


def k1_launch(g: torch.Tensor, plan: K1Plan, out: torch.Tensor, scratch: torch.Tensor,
              passes: int = ALL_PASSES) -> None:
    """Enqueue the passes of K1 named by the bit mask `passes` (bit i: PASSES[i])
    on PyTorch's current stream; both bits of a PLANE_PASSES mask run as one
    launch per plane where that form applies. Scratch holds the two half
    spectra, s1 then s2, as (nz, ny, nxr) complex, and the long-line buffers
    after them. Counts nothing: `fused_circulant_solve_cuda` is the solve."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    lib = load_library()
    nz, ny, nx = plan.shape_zyx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.k1_fused_circulant_solve(
        g.data_ptr(), *(t.data_ptr() for t in plan.tables), out.data_ptr(),
        scratch.data_ptr(), plan.ints, nz, ny, nx, passes, g.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err} "
                           f"({lib.k1_error_string(err).decode()})")


def k1_scratch(g: torch.Tensor, plan: K1Plan) -> torch.Tensor:
    from circulantpreconditioner_tpu_torch.native.build import load_library

    return torch.empty(plan.scratch_floats(load_library()), device=g.device,
                       dtype=torch.float32)


def fused_circulant_solve_cuda(g: torch.Tensor, plan: K1Plan,
                               precision: str = "high") -> torch.Tensor:
    """Launch K1 on g's device, on PyTorch's current stream; counts one launch."""
    check_precision(precision)
    _check_kernel_inputs(g, plan)
    out = torch.empty_like(g)
    k1_launch(g, plan, out, k1_scratch(g, plan))
    FusedCirculantSolver.launches += 1
    return out


class FusedCirculantSolver:
    """Drop-in for MatmulCirculantSolver.solve with the 3D pipeline in K1.
    Other ranks go to the staged solver (as in the JAX package)."""

    launches = 0  # K1 launches made by fused_circulant_solve_cuda

    def __init__(self, shape_zyx, arrays, plan: K1Plan, precision: str = "high"):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.arrays = tuple(arrays)  # the 14 dense tables, TABLE_NAMES order
        self.plan = plan  # what K1 reads
        self.precision = check_precision(precision)

    @classmethod
    def create(cls, shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], *,
               device: torch.device, dtype: torch.dtype, precision: str = "high"):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        if len(shape_zyx) != 3:
            return MatmulCirculantSolver.create(shape_zyx, lambdas_zyx, device=device,
                                                dtype=dtype, precision=precision)
        nz, ny, nx = shape_zyx
        F_re, F_im, B_re, B_im = _np_rdft_mats(nx)
        Cz, Sz, Ciz, Siz = _np_dft_mats(nz)
        Cy, Sy, Ciy, Siy = _np_dft_mats(ny)
        lam = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=True)  # (nz, ny, nxr)
        den = lam.real**2 + lam.imag**2
        # the JAX layout of 1/Λ, (kx·ky, kz), here without padding
        ire = (lam.real / den).transpose(2, 1, 0).reshape(-1, nz)
        iim = (-lam.imag / den).transpose(2, 1, 0).reshape(-1, nz)
        arrays = (F_re, F_im, Cy, Sy, Cz, Sz, ire, iim, Ciz, Siz, Ciy, Siy, B_re, B_im)
        return cls.from_numpy_arrays(shape_zyx, arrays, device=device, dtype=dtype,
                                     precision=precision)

    @classmethod
    def from_numpy_arrays(cls, shape_zyx, arrays, *, device: torch.device,
                          dtype: torch.dtype, precision: str = "high"):
        """From the JAX solver's 14 `arrays` as numpy. Their spectral extents
        are padded to KP/YP/ZP; the padding is cropped away, 1/Λ is laid
        out as (nz, ny, nxr), and K1's plan takes its 1/Λ from them."""
        check_real_dtype(dtype)
        nz, ny, nx = (int(v) for v in shape_zyx)
        nxr = nx // 2 + 1
        a = [np.asarray(v, dtype=np.float64) for v in arrays]
        KP, YP = a[0].shape[1], a[2].shape[1]
        lam_tab = lambda t: t.reshape(KP, YP, -1)[:nxr, :ny, :nz].transpose(2, 1, 0)  # noqa: E731
        cropped = (
            a[0][:, :nxr], a[1][:, :nxr], a[2][:, :ny], a[3][:, :ny],
            a[4][:, :nz], a[5][:, :nz], lam_tab(a[6]), lam_tab(a[7]),
            a[8][:nz, :nz], a[9][:nz, :nz], a[10][:ny, :ny], a[11][:ny, :ny],
            a[12][:nxr, :], a[13][:nxr, :],
        )
        tables = tuple(_to(np.ascontiguousarray(t), device, dtype) for t in cropped)
        plan = K1Plan.from_numpy((nz, ny, nx), cropped[6], cropped[7], device=device,
                                 dtype=dtype)
        return cls((nz, ny, nx), tables, plan, precision)

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, precision: str = "high"):
        return cls.create(op.shape_zyx, op.lambdas_zyx, device=op.device, dtype=op.dtype,
                          precision=precision)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = C⁻¹ b for real b shaped (nz, ny, nx) or flat."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx)
        if g.device.type == "cpu":
            x = fused_circulant_reference(g, self.arrays, self.precision)
        else:
            x = fused_circulant_solve_cuda(g, self.plan, self.precision)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self):
        return self.solve
