"""The port's diffusion driver (`--device cpu --f64`) against the JAX
driver on the same command lines, for every --method: the same step count;
in every step the same Krylov iterations and the same ‖uⁿ⁺¹ − uⁿ‖ to 1e-10
relative; final states within 1e-10 × max|u|. `--method pc` runs the port's
projection PC with its default coarse solve (torch.fft) against the JAX
package's (the staged DFT): the same operator, rounded differently."""

import numpy as np
import pytest

from circulantpreconditioner_tpu.drivers import diffusion_implicit as j_diff
from circulantpreconditioner_tpu_torch.drivers import diffusion_implicit as t_diff

CASES = {
    "cg": ["6", "5", "4"],
    "gmres": ["6", "5", "4"],
    "fft": ["6", "5", "4"],  # forces --periodic
    "pc": ["--mesh-family", "kershaw", "6", "6", "6"],
}


@pytest.mark.parametrize("method", list(CASES))
def test_diffusion_driver_matches_jax(tmp_path, method):
    argv = CASES[method] + ["--method", method, "--tmax", "1e9", "--ntmax", "3", "--f64",
                            "--cfl", "50", "--result-dir", str(tmp_path)]
    rj = j_diff.main(argv)
    rt = t_diff.main(argv + ["--device", "cpu"])
    assert rt.iterations == rj.iterations == 3
    its = lambda r: [d["extras"][0] for d in r.diagnostics if d["extras"]]  # noqa: E731
    assert its(rt) == its(rj)
    assert len(its(rt)) == (0 if method == "fft" else 3)
    assert all(d["extras"][2] for d in rt.diagnostics if d["extras"])  # every solve converged
    np.testing.assert_allclose([d["dnorm"] for d in rt.diagnostics],
                               [d["dnorm"] for d in rj.diagnostics], rtol=1e-10)
    uj = np.asarray(rj.state)
    np.testing.assert_allclose(rt.state.numpy(), uj, rtol=0, atol=1e-10 * np.abs(uj).max())


def test_diffusion_driver_defaults(tmp_path):
    """--method cg is the default, and the drivers agree on dt and the mesh."""
    argv = ["4", "4", "--tmax", "1e9", "--ntmax", "2", "--f64", "--result-dir", str(tmp_path)]
    rj = j_diff.main(argv)
    rt = t_diff.main(argv + ["--device", "cpu"])
    assert rt.iterations == rj.iterations == 2 and rt.time == rj.time
    uj = np.asarray(rj.state)
    np.testing.assert_allclose(rt.state.numpy(), uj, rtol=0, atol=1e-10 * np.abs(uj).max())
