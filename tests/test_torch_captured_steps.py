"""The port's captured steps (utils/graphs.CapturedStep) against the JAX
package's jitted steps, through both time loops, float64 on the CPU.

Every explicit and direct stepper of the transport, wave and diffusion
models runs 7 steps three ways on each side: `run_time_loop` step by step,
`run_time_loop` with chunk 3 (chunks of 3, 3 and 1: the JAX package's
jax.jit(lax.scan) per chunk length, the port's one graph per chunk length)
and `scan_steps`. Every state the loop hands to `on_output` equals the JAX
package's within 1e-12 × max|U| (the same float64 arithmetic; the FFT
libraries round differently), and every dnorm it records within 1e-12 ×
‖U‖₂: a dnorm is the norm of a difference of two states, so its roundoff
scales with the states (the direct steps' dnorms fall to 1e-7 of them). A captured step holds its
state in one buffer, so a loop that kept the wrong buffer would return a
state one step old: the per-step states pin that.

A captured step called as a function stays functional, as a jitted impl is:
the state it returned is unchanged by the next call, and so is its
argument.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import DiffusionEquation as JDiffusion
from circulantpreconditioner_tpu.models import TransportEquation as JTransport
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.models import run_time_loop as j_run
from circulantpreconditioner_tpu.models.runner import scan_steps as j_scan
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cartesian
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as t_kershaw
from circulantpreconditioner_tpu_torch.models import DiffusionEquation as TDiffusion
from circulantpreconditioner_tpu_torch.models import TransportEquation as TTransport
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.models import run_time_loop as t_run
from circulantpreconditioner_tpu_torch.models import scan_steps as t_scan
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep

F64 = dict(device=torch.device("cpu"), dtype=torch.float64)
BOUNDS = ((-0.5, 0.5),) * 3
N_STEPS, CHUNK, TOL = 7, 3, 1e-12


def _cartesian(n, periodic):
    return j_cartesian(BOUNDS, n, periodic=periodic), t_cartesian(BOUNDS, n, periodic=periodic)


@functools.lru_cache(maxsize=None)
def _models(family: str):
    """(JAX model, port model) of a family, built once per test process."""
    if family == "transport":
        jm, tm = _cartesian((8, 6, 5), True)
        return (JTransport(jm, (1.0, -0.5, 0.25), cfl=0.3, dtype=jnp.float64),
                TTransport(tm, (1.0, -0.5, 0.25), cfl=0.3, **F64))
    if family == "transport-direct":
        jm, tm = _cartesian((8, 6, 5), True)
        return (JTransport(jm, (1.0, 0.5, 0.25), cfl=1e3 / 3, dtype=jnp.float64),
                TTransport(tm, (1.0, 0.5, 0.25), cfl=1e3 / 3, **F64))
    if family == "wave-kershaw":
        jm, tm = j_kershaw(BOUNDS, (8, 8, 8)), t_kershaw(BOUNDS, (8, 8, 8))
        return JWave(jm, dtype=jnp.float64), TWave(tm, **F64)
    if family in ("wave-periodic", "wave-wall"):
        jm, tm = _cartesian((6, 5, 4), family == "wave-periodic")
        return (JWave(jm, cfl=1e3 / 3, dtype=jnp.float64),
                TWave(tm, cfl=1e3 / 3, **F64))
    if family == "diffusion":
        jm, tm = _cartesian((8, 6, 5), False)
        return JDiffusion(jm, cfl=0.9, dtype=jnp.float64), TDiffusion(tm, cfl=0.9, **F64)
    if family == "diffusion-periodic":
        jm, tm = _cartesian((8, 6, 5), True)
        return JDiffusion(jm, cfl=100.0, dtype=jnp.float64), TDiffusion(tm, cfl=100.0, **F64)
    raise ValueError(family)


def _flat(m):
    return m.initial_state()


def _fm(m):
    return m.pack_fm(m.initial_state())


# (model family, stepper, initial state) per captured stepper of the models
STEPPERS = {
    "transport-explicit": ("transport", lambda m: m.explicit_stepper(), _flat),
    "transport-fft": ("transport-direct", lambda m: m.fft_stepper("fft"), _flat),
    "transport-matmul": ("transport-direct", lambda m: m.fft_stepper("matmul"), _flat),
    "wave-explicit": ("wave-kershaw", lambda m: m.explicit_stepper(), _flat),
    "wave-explicit-fm": ("wave-kershaw", lambda m: m.explicit_stepper_fm(), _fm),
    "wave-blockfft": ("wave-periodic", lambda m: m.block_fft_stepper(), _flat),
    "wave-dctfft": ("wave-wall", lambda m: m.dct_fft_stepper(), _flat),
    "wave-dctfft-fm": ("wave-wall", lambda m: m.dct_fft_stepper_fm(), _fm),
    "diffusion-explicit": ("diffusion", lambda m: m.explicit_stepper(), _flat),
    "diffusion-fft": ("diffusion-periodic", lambda m: m.fft_stepper(), _flat),
}


def _close(x, ref, tol=TOL):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


def _close_dnorms(d, ref, U):
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref), rtol=0,
                               atol=TOL * np.linalg.norm(np.asarray(U)))


def _loop(run, step, U0, dt, chunk):
    """The states handed to on_output and the diagnostics' dnorms."""
    states = []
    res = run(step, U0, dt, tmax=1e9, ntmax=N_STEPS, precision=0.0, log=None, chunk=chunk,
              on_output=lambda it, t, U, ex: states.append((it, np.array(U))))
    return res, states, [d["dnorm"] for d in res.diagnostics]


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["per-step", "chunk3"])
@pytest.mark.parametrize("name", list(STEPPERS))
def test_time_loop_matches_jax(name, chunk):
    family, make, init = STEPPERS[name]
    mj, mt = _models(family)
    step = make(mt)
    assert isinstance(step, CapturedStep)
    rj, sj, dj = _loop(j_run, make(mj), init(mj), mj.dt, chunk)
    rt, st, dt_ = _loop(t_run, step, init(mt), mt.dt, chunk)
    assert rt.iterations == rj.iterations == N_STEPS
    assert [it for it, _ in st] == [it for it, _ in sj] == (
        list(range(1, N_STEPS + 1)) if chunk is None else [3, 6, 7])
    for (_, ut), (_, uj) in zip(st, sj):
        _close(ut, uj)
    _close_dnorms(dt_, dj, rj.state)
    _close(rt.state, rj.state)
    assert rt.state.data_ptr() != step.state.data_ptr()  # the loop's result is its own


@pytest.mark.parametrize("name", list(STEPPERS))
def test_scan_steps_matches_jax(name):
    family, make, init = STEPPERS[name]
    mj, mt = _models(family)
    uj, dj = j_scan(make(mj), init(mj), N_STEPS)
    ut, dt_ = t_scan(make(mt), init(mt), N_STEPS)
    assert dt_.shape == (N_STEPS,)
    _close(ut, uj)
    _close_dnorms(dt_.numpy(), np.asarray(dj).reshape(-1), uj)


@pytest.mark.parametrize("name", list(STEPPERS))
def test_call_is_functional(name):
    """Call k's state survives call k + 1, the argument is never written, and
    two calls equal two steps of the loop."""
    family, make, init = STEPPERS[name]
    _, mt = _models(family)
    step = make(mt)
    U0 = init(mt)
    U0_copy = U0.clone()
    U1, d1 = step(U0)
    U1_copy, d1_copy = U1.clone(), d1.clone()
    U2, d2 = step(U1)
    assert torch.equal(U0, U0_copy) and torch.equal(U1, U1_copy) and torch.equal(d1, d1_copy)
    assert not torch.equal(U2, U1)
    ref = t_run(make(mt), U0, mt.dt, tmax=1e9, ntmax=2, precision=0.0, log=None)
    assert torch.equal(U2, ref.state)
    assert [float(d1), float(d2)] == [d["dnorm"] for d in ref.diagnostics]


def test_buffer_follows_the_state_and_the_norms():
    """A step reused on another state shape, or under another global_norms,
    sets itself up anew; the norms run on each chunk's dnorms."""
    _, mt = _models("transport")
    step = mt.explicit_stepper()
    U0 = mt.initial_state()
    ref = t_run(mt.explicit_stepper(), U0, mt.dt, tmax=1e9, ntmax=4, precision=0.0, log=None)
    doubled = t_run(step, U0, mt.dt, tmax=1e9, ntmax=4, precision=0.0, log=None, chunk=2,
                    global_norms=lambda d: 2 * d)
    assert torch.equal(doubled.state, ref.state)
    assert [d["dnorm"] for d in doubled.diagnostics] == \
        [2 * d["dnorm"] for d in ref.diagnostics[1::2]]
    U_half = U0[: U0.numel() // 2]
    with pytest.raises(RuntimeError):  # the operator needs the whole state
        step(U_half)
    U1, _ = step(U0)
    assert torch.equal(U1, t_scan(mt.explicit_stepper(), U0, 1)[0])
