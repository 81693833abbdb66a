"""The port's drivers (`--device cpu`) against the JAX drivers on the same
command lines, float64: final state within 1e-10 × max|u| and the same GMRES
iterations in every step."""

import numpy as np
import pytest

from circulantpreconditioner_tpu.drivers import transport_fft as j_fft
from circulantpreconditioner_tpu.drivers import transport_implicit as j_imp
from circulantpreconditioner_tpu_torch.drivers import transport_fft as t_fft
from circulantpreconditioner_tpu_torch.drivers import transport_implicit as t_imp


def _args(tmp_path, extra):
    return extra + ["--tmax", "1e9", "--ntmax", "3", "--f64", "--result-dir", str(tmp_path)]


def _same(rt, rj):
    assert rt.iterations == rj.iterations
    uj = np.asarray(rj.state)
    np.testing.assert_allclose(rt.state.numpy(), uj, rtol=0, atol=1e-10 * np.abs(uj).max())
    its = lambda r: [d["extras"][0] for d in r.diagnostics if d["extras"]]
    assert its(rt) == its(rj)


@pytest.mark.parametrize("argv", [["10", "10"], ["12", "12", "12"],
                                  ["10", "10", "--method", "matmul", "--chunk", "2"]])
def test_transport_fft_driver_matches_jax(tmp_path, argv):
    rj = j_fft.main(_args(tmp_path, argv))
    rt = t_fft.main(_args(tmp_path, argv + ["--device", "cpu"]))
    _same(rt, rj)


@pytest.mark.parametrize("argv", [["10", "10"], ["12", "12", "12", "--pc", "circulant"],
                                  ["12", "12", "12", "--pc", "jacobi"],
                                  ["10", "10", "--periodic", "--pc", "circulant"]])
def test_transport_implicit_driver_matches_jax(tmp_path, argv):
    rj = j_imp.main(_args(tmp_path, argv))
    rt = t_imp.main(_args(tmp_path, argv + ["--device", "cpu"]))
    _same(rt, rj)
    assert all(d["extras"][2] for d in rt.diagnostics)  # GMRES converged every step


def test_driver_checkpoint_output(tmp_path):
    from circulantpreconditioner_tpu_torch.io import load_checkpoint

    res = t_fft.main(_args(tmp_path, ["8", "8", "--device", "cpu", "--checkpoint-freq", "1"]))
    state, t, it, _ = load_checkpoint(str(tmp_path / "cartesian_8x8_ckpt.npz"))
    assert it == res.iterations and np.array_equal(state, res.state.numpy())


@pytest.mark.parametrize("extra", [["--shard", "slab", "--devices", "2"],
                                   ["--shard", "pencil", "--pq", "3", "1"]])
def test_unported_driver_options_raise(tmp_path, extra):
    """What still raises, now that --shard runs (tests/test_torch_parallel_drivers.py):
    --devices 2 with no process group and no torchrun environment, and a
    --pq whose pencil mesh does not tile the grid (checked before any rank
    starts)."""
    exc, match = {"slab": (RuntimeError, "torchrun --nproc-per-node 2"),
                  "pencil": (ValueError, "need nz%p==0")}[extra[1]]
    with pytest.raises(exc, match=match):
        t_fft.main(_args(tmp_path, ["4", "4", "4", "--device", "cpu"] + extra))


@pytest.mark.parametrize("option", ["--med", "--vtk"])
def test_driver_output_options_write_the_state(tmp_path, option):
    """--med and --vtk (once raising, now ported): one output a step, the
    last holding the final state, as the JAX driver writes it."""
    import os

    from circulantpreconditioner_tpu_torch.io import read_med_field

    res = t_fft.main(_args(tmp_path, ["4", "4", "4", "--device", "cpu", option]))
    rj = j_fft.main(_args(tmp_path / "jax", ["4", "4", "4", option]))
    u = res.state.numpy()
    if option == "--med":
        series = read_med_field(str(tmp_path / "cartesian_4x4x4_temperature.med"), "temperature")
        assert [it for it, _, _ in series] == [1, 2, 3]
        assert np.array_equal(series[-1][2][:, 0], u)
    else:
        name = "cartesian_4x4x4_temperature_000003.vtk"
        text = open(tmp_path / name).read()
        assert text.split("LOOKUP_TABLE default\n")[1].split() == [str(v) for v in u]
        assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".vtk")) == sorted(
            f for f in os.listdir(tmp_path / "jax") if f.endswith(".vtk"))
        np.testing.assert_allclose(u, np.asarray(rj.state), rtol=0, atol=1e-10 * np.abs(u).max())


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no silent CPU fallback"):
        t_imp.main(_args(tmp_path, ["4", "4"]))
