"""Kernel K6 (ops/block_jacobi.py, csrc/block_jacobi.cu): point-block Jacobi
out = zn + ω·Dinv·(r − y) on field-major vectors, at its three call sites:

- "grid": the grid V-cycle's generic field-major smoothing step on a grid
  level (the hex fine level; Dinv cell-major (N, b, b), g = 1);
- "site": the same on a supercell level (a tet mesh's site level; Dinv
  cell-major (g·S, b, b), site-major cells);
- "pbjacobi": `pbjacobi_fm`'s apply and its `fused` form (Dinv field-major,
  (b, b, N) or (g, b, b, S)), which the multiplicative composite calls.

On the CPU (tier 1): each site's plain version is the einsum it replaced
(bit for bit, float64), and all three are one function of the cell-major
blocks (a NumPy reference); the multiplicative composite with the fused
smoother is z + Ms(r − A z); a CPU apply counts `block_jacobi_plain` and
launches no K6, as does a whole V-cycle apply_fm (two smoothing steps of
its first level); the wrapper refuses b = 9 and mixed or other dtypes.
The GPU tests (marker `gpu`, skipped without a card) hold K6 to the plain
version in float32 and float64 at Kershaw 64³'s and Kershaw-tet 50³'s
shapes in every Dinv layout, at small shapes of b = 1 to 8 and an
unaligned Dinv, through the dispatch and a whole V-cycle apply; a captured
apply replays bit for bit; the wrapper and the dispatch refuse what K6
cannot take.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_block_jacobi.py -q
"""

import numpy as np
import pytest
import torch

from circulantpreconditioner_tpu_torch.ops import block_jacobi as bj
from circulantpreconditioner_tpu_torch.solvers import aggregation_pc as ap
from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
from circulantpreconditioner_tpu_torch.utils.graphs import STATS

OMEGA = 0.8
CPU = torch.device("cpu")
F64 = torch.float64


def _blocks(S, g, b, device, dtype, seed=0):
    """Cell-major (g·S, b, b) blocks, cell g·s + k: near the identity, as
    inverted diagonal blocks of the implicit operators are."""
    rng = np.random.default_rng(seed)
    D = np.eye(b)[None] + 0.3 * rng.standard_normal((g * S, b, b))
    return torch.as_tensor(D, device=device, dtype=dtype)


def _vec(n, device, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n), device=device,
                           dtype=dtype)


def _field(D, g):
    """The cell-major blocks in pbjacobi_fm's layout: (b, b, N) or (g, b, b, S)."""
    b = D.shape[-1]
    if g == 1:
        return D.permute(1, 2, 0).contiguous()
    return D.reshape(-1, g, b, b).permute(1, 2, 3, 0).contiguous()


class _Site:
    """A call site on cell-major blocks D: `call(r, zn, y)` through the
    dispatch, `einsum(v)` the contraction it replaced (ω·Dinv·v), `omega`."""

    def __init__(self, name, D, g):
        b = D.shape[-1]
        S = D.shape[0] // g
        self.name, self.g, self.b = name, g, b
        if name == "grid":
            L = ap._GridLevel(Dinv=D, cnt_inv=None, shape_xyz=(S, 1, 1),
                              cshape_xyz=(-(-S // 2), 1, 1), b=b)
            self.omega = OMEGA
            self.call = lambda r, zn=None, y=None: ap._smooth_step_fm(ap._grid_smooth_fm, L,
                                                                      OMEGA, r, zn, y)
            self.plain = lambda v: ap._grid_smooth_fm(L, OMEGA, v)
            self.einsum = lambda v: OMEGA * torch.einsum("nij,jn->in", D,
                                                         v.reshape(b, -1)).reshape(-1)
        elif name == "site":
            L = ap._Level(A=None, Dinv=D, cnt_inv=None, n=g * S, b=b, factor=g, n_agg=S)
            self.omega = OMEGA
            self.call = lambda r, zn=None, y=None: ap._smooth_step_fm(ap._smooth_fm, L, OMEGA, r,
                                                                      zn, y)
            self.plain = lambda v: ap._smooth_fm(L, OMEGA, v)
            self.einsum = lambda v: OMEGA * torch.einsum(
                "nkij,kjn->kin", D.reshape(S, g, b, b), v.reshape(g, b, S)).reshape(-1)
        else:
            pj = pcs.PointBlockJacobiFM(_field(D, g), g)
            DT = pj.DinvT
            self.omega = 1.0
            self.call = lambda r, zn=None, y=None: (pj(r) if zn is None and y is None
                                                    else pj.fused(r, zn, y))
            self.plain = pj._plain
            self.einsum = (
                (lambda v: torch.einsum("ijn,jn->in", DT, v.reshape(b, -1)).reshape(-1)) if g == 1
                else (lambda v: torch.einsum("kijn,kjn->kin", DT, v.reshape(g, b, -1)).reshape(-1)))


def _reference(D, g, omega, r, zn, y) -> np.ndarray:
    """zn + ω·Dinv·(r − y) in NumPy float64 from the cell-major blocks."""
    D = D.double().cpu().numpy()
    b = D.shape[-1]
    S = D.shape[0] // g
    v = r.double().cpu().numpy() - (0.0 if y is None else y.double().cpu().numpy())
    out = omega * np.einsum("skij,kjs->kis", D.reshape(S, g, b, b), v.reshape(g, b, S))
    return out.reshape(-1) + (0.0 if zn is None else zn.double().cpu().numpy())


# (site, g): the grid level has one cell a site
_SITES = [("grid", 1), ("site", 1), ("site", 6), ("pbjacobi", 1), ("pbjacobi", 6)]
_SITE_IDS = [f"{s}-g{g}" for s, g in _SITES]
_FORMS = {"r": (False, False), "r-y": (False, True), "zn+r": (True, False), "zn+r-y": (True, True)}


def _inputs(n, device, dtype, form):
    with_zn, with_y = _FORMS[form]
    return (_vec(n, device, dtype, 1), _vec(n, device, dtype, 2) if with_zn else None,
            _vec(n, device, dtype, 3) if with_y else None)


# --- CPU: the plain versions, the composite, the counters, the refusals ---------

@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("site,g", _SITES, ids=_SITE_IDS)
def test_plain_version_is_the_einsum_it_replaces(site, g, b, form):
    S = 11
    D = _blocks(S, g, b, CPU, F64, seed=b + g)
    s = _Site(site, D, g)
    r, zn, y = _inputs(g * b * S, CPU, F64, form)
    out = s.call(r, zn, y)
    v = r if y is None else r - y
    want = s.einsum(v) if zn is None else zn + s.einsum(v)
    assert torch.equal(out, want)
    np.testing.assert_allclose(out.numpy(), _reference(D, g, s.omega, r, zn, y), rtol=0,
                               atol=1e-13 * np.abs(want.numpy()).max())


@pytest.mark.parametrize("g", [1, 6])
def test_multiplicative_with_the_fused_smoother(g):
    """multiplicative(A, Mc, pbjacobi_fm) = z + Ms(r − A z), z = Mc r, with
    one point-block Jacobi apply (the fused form) a cycle."""
    b, S = 4, 9
    n = g * b * S
    D = _blocks(S, g, b, CPU, F64, seed=5)
    pj = pcs.PointBlockJacobiFM(_field(D, g), g)
    Am = torch.as_tensor(np.random.default_rng(6).standard_normal((n, n)), dtype=F64)
    A = lambda x: Am @ x  # noqa: E731
    coarse = pcs.PointBlockJacobiFM(_field(_blocks(S, g, b, CPU, F64, seed=7), g), g)
    r = _vec(n, CPU, F64, 8)
    STATS.reset()
    out = pcs.multiplicative(A, coarse, pj)(r)
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (0, 2)  # Mc and the fused Ms
    z = coarse(r)
    assert torch.equal(out, z + pj(r - A(z)))


@pytest.mark.parametrize("site,g", [("grid", 1), ("site", 6), ("pbjacobi", 6)],
                         ids=["grid", "site", "pbjacobi"])
def test_cpu_apply_counts_plain_and_launches_no_k6(site, g):
    b, S = 4, 7
    s = _Site(site, _blocks(S, g, b, CPU, F64), g)
    r, zn, y = _inputs(g * b * S, CPU, F64, "zn+r-y")
    STATS.reset()
    before = bj.BlockJacobiKernel.launches
    s.call(r)
    s.call(r, zn, y)
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (0, 2)
    assert STATS.snapshot()["block_jacobi_plain"] == 2
    assert bj.BlockJacobiKernel.launches == before


def _hex_pc(n, device, dtype):
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    model = WaveSystem(kershaw_mesh(((-0.5, 0.5),) * 3, n), cfl=1e3 / 3, device=device,
                       dtype=dtype)
    return ap.GridVCyclePC.from_grid_model(model.divergence, n, A0_apply=model.implicit_matvec(),
                                           A0_apply_fm=model.implicit_matvec_fm(),
                                           bottom_max=60, dtype=dtype)


def _tet_pc(n, device, dtype):
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    mesh = kershaw_tet_mesh(((-0.5, 0.5),) * 3, n, eps=0.3)
    model = WaveSystem(mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    return ap.GridVCyclePC.from_grid_model(
        model.divergence, mesh.topology_shape, cells_per_site=model.cells_per_site,
        A0_apply=model.implicit_matvec(), A0_apply_fm=model.implicit_matvec_fm(),
        bottom_max=20, dtype=dtype)


_PCS = [("hex8", _hex_pc, (8, 8, 8)), ("tet4", _tet_pc, (4, 4, 4))]


@pytest.mark.parametrize("case", _PCS, ids=[c[0] for c in _PCS])
def test_cpu_vcycle_counts_its_first_levels_smoothing_as_plain(case):
    """A V(1,1) apply_fm smooths its first level (the hex fine level, the tet
    site level) twice: two plain applies on the CPU, no K6 launch."""
    _, build, n = case
    pc = build(n, CPU, F64)
    first = pc.levels[0]
    assert isinstance(first, ap._Level if case[0] == "tet4" else ap._GridLevel)
    g = _vec(int(np.prod(n)) * (24 if case[0] == "tet4" else 4), CPU, F64, 9)
    STATS.reset()
    before = bj.BlockJacobiKernel.launches
    pc.apply_fm(g)
    pc.apply_fm(g)
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (0, 4)
    assert bj.BlockJacobiKernel.launches == before


_REFUSED = [("b9", 9, torch.float32, torch.float32, "b ≤ 8"),
            ("mixed", 4, torch.float32, torch.float64, "Dinv is torch.float64"),
            ("half", 4, torch.float16, torch.float16, "float32 or float64")]


@pytest.mark.parametrize("case", _REFUSED, ids=[c[0] for c in _REFUSED])
def test_dispatch_refuses(case):
    """b = 9, mixed dtypes and half precision are not K6's: `refusal` says
    why, and the wrapper raises it before it looks at the device."""
    _, b, dt, ddt, why = case
    assert why in bj.refusal(b, dt, ddt)
    S = 5
    D = _blocks(S, 1, b, CPU, ddt)
    r = _vec(b * S, CPU, dt, 1)
    with pytest.raises(ValueError, match=why):
        bj.apply_cuda(D, "cell", 1, OMEGA, r)
    if dt == ddt:  # on the CPU the plain version runs it, as the einsum did
        s = _Site("grid", D.double(), 1)
        STATS.reset()
        out = s.call(r.double())
        assert STATS.block_jacobi_plain == 1
        assert torch.equal(out, s.einsum(r.double()))
    assert bj.refusal(8, torch.float64, torch.float64) is None


# --- GPU: the kernel against its plain versions --------------------------------
# Tolerance: K6 sums a cell's j in another order than the einsum (cuBLAS's
# gemv) and contracts into FMAs: a few ulp, 1e-5 · max|plain| in float32,
# 1e-12 in float64.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("runs on the card (K6 is a CUDA kernel): need a GPU "
                    "(torch.cuda.is_available() is False)")
    return torch.device("cuda")


_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the main paths' shapes: (name, site, S, g) with b = 4; Kershaw 64³ hex
# (the V-cycle's fine level, dct2lm's pbjacobi_fm), Kershaw-tet 50³ (the
# site level, pbjacobi_fm on the site view)
_MAIN = [("hex64-vcycle", "grid", 64 ** 3, 1), ("hex64-pbjacobi", "pbjacobi", 64 ** 3, 1),
         ("tet50-site", "site", 50 ** 3, 6), ("tet50-pbjacobi", "pbjacobi", 50 ** 3, 6)]


def _relerr(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["r", "zn+r-y"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", _MAIN, ids=[c[0] for c in _MAIN])
def test_k6_matches_plain_at_the_main_paths_shapes(cuda, case, dtype, form):
    _, site, S, g = case
    s = _Site(site, _blocks(S, g, 4, cuda, dtype), g)
    r, zn, y = _inputs(g * 4 * S, cuda, dtype, form)
    STATS.reset()
    before = bj.BlockJacobiKernel.launches
    got = s.call(r, zn, y)
    torch.cuda.synchronize()
    assert bj.BlockJacobiKernel.launches == before + 1
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (1, 0)
    v = r if y is None else r - y
    want = s.plain(v) if zn is None else zn + s.plain(v)
    assert _relerr(got, want) <= _TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 2, 3, 8])
@pytest.mark.parametrize("site,g", _SITES, ids=_SITE_IDS)
def test_k6_matches_plain_at_every_block_size(cuda, site, g, b, dtype):
    S = 1000
    s = _Site(site, _blocks(S, g, b, cuda, dtype, seed=b), g)
    r, zn, y = _inputs(g * b * S, cuda, dtype, "zn+r-y")
    got = s.call(r, zn, y)
    want = zn + s.plain(r - y)
    assert _relerr(got, want) <= _TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_reads_an_unaligned_dinv(cuda, dtype):
    """A cell-major Dinv whose base is not 16-byte aligned takes the scalar
    loads."""
    S, b = 4099, 4
    D0 = _blocks(S, 1, b, cuda, dtype)
    buf = torch.empty(D0.numel() + 1, device=cuda, dtype=dtype)
    buf[1:] = D0.reshape(-1)
    D = buf[1:].view(S, b, b)
    assert D.data_ptr() % 16 != 0
    r, zn, y = _inputs(b * S, cuda, dtype, "zn+r-y")
    got = bj.apply_cuda(D, "cell", 1, OMEGA, r, zn, y)
    want = bj.apply_cuda(D0, "cell", 1, OMEGA, r, zn, y)
    assert _relerr(got, want) <= _TOL[dtype]
    assert _relerr(got, zn + _Site("grid", D0, 1).plain(r - y)) <= _TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _PCS, ids=[c[0] for c in _PCS])
def test_k6_in_a_whole_vcycle_apply(cuda, case):
    """apply_fm on the card, two K6 launches an apply on its first level,
    against the same hierarchy's apply on the CPU (K5 below, the plain
    stages there)."""
    _, build, n = case
    pc, pc_cpu = build(n, cuda, F64), build(n, CPU, F64)
    g = _vec(int(np.prod(n)) * (24 if case[0] == "tet4" else 4), CPU, F64, 9)
    STATS.reset()
    before = bj.BlockJacobiKernel.launches
    got = pc.apply_fm(g.to(cuda))
    torch.cuda.synchronize()
    assert bj.BlockJacobiKernel.launches == before + 2
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (2, 0)
    assert _relerr(got.cpu(), pc_cpu.apply_fm(g)) <= 1e-10


@pytest.mark.gpu
def test_k6_captured_apply_replays_bit_for_bit(cuda):
    """The multiplicative composite's fused smoothing captured in a GraphSet
    replays its eager warm-up's answer bit for bit; each replay adds its K6
    launches and fused applies."""
    from circulantpreconditioner_tpu_torch.utils.graphs import GraphSet

    g, b, S = 6, 4, 50 ** 3
    pj = pcs.PointBlockJacobiFM(_field(_blocks(S, g, b, cuda, torch.float32), g), g)
    coarse = _Site("site", _blocks(S, g, b, cuda, torch.float32, seed=3), g).call
    M = pcs.multiplicative(lambda x: 0.5 * x, coarse, pj)
    r = _vec(g * b * S, cuda, torch.float32, 4)
    out = torch.zeros_like(r)
    graphs = GraphSet(cuda)
    STATS.reset()
    before = bj.BlockJacobiKernel.launches
    graphs.run("M", lambda: out.copy_(M(r)))  # the eager warm-up, then the capture
    eager = out.clone()
    assert bj.BlockJacobiKernel.launches == before + 2 and STATS.block_jacobi_fused == 2
    for _ in range(5):
        out.zero_()
        graphs.run("M", lambda: out.copy_(M(r)))
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert bj.BlockJacobiKernel.launches == before + 12
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (12, 0)


@pytest.mark.gpu
def test_k6_wrapper_refuses_what_it_cannot_take(cuda):
    S, b = 100, 4
    D = _blocks(S, 1, b, cuda, torch.float32)
    r = torch.ones(b * S, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        bj.apply_cuda(D.cpu(), "cell", 1, OMEGA, r.cpu())
    with pytest.raises(ValueError, match="float64"):
        bj.apply_cuda(D.double(), "cell", 1, OMEGA, r)
    with pytest.raises(ValueError, match="b ≤ 8"):
        bj.apply_cuda(_blocks(S, 1, 9, cuda, torch.float32), "cell", 1, OMEGA,
                      torch.ones(9 * S, device=cuda))
    with pytest.raises(ValueError, match="values"):
        bj.apply_cuda(D, "cell", 1, OMEGA, r[:-4])
    with pytest.raises(ValueError, match="values"):
        bj.apply_cuda(D, "cell", 1, OMEGA, r, y=r[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        bj.apply_cuda(D.transpose(1, 2), "cell", 1, OMEGA, r)
    with pytest.raises(ValueError, match="layout"):
        bj.apply_cuda(D, "rows", 1, OMEGA, r)
    with pytest.raises(ValueError, match="float32"):
        bj.apply_cuda(D.half(), "cell", 1, OMEGA, r.half())
    # the dispatch raises them too on the card: no fall-back to the plain version
    plain = lambda v: v  # noqa: E731
    STATS.reset()
    with pytest.raises(ValueError, match="b ≤ 8"):
        bj.run(plain, _blocks(S, 1, 9, cuda, torch.float32), "cell", 1, OMEGA,
               torch.ones(9 * S, device=cuda))
    with pytest.raises(ValueError, match="float64"):
        bj.run(plain, D.double(), "cell", 1, OMEGA, r)
    assert (STATS.block_jacobi_fused, STATS.block_jacobi_plain) == (0, 0)
