"""Port vs reference: the FEM QA suite (apps/qa_suite_fem.py) on the CPU in
float64: one sphere case on a small spherical shell (3 layers of the
subdivision-1 icosphere) gives the reference's rel_l2 (1e-9), its JSON and
its closed form (1e-12); the cylinder's closed form at scattered (r, theta)
pairs equals the port's cylinder_scattering_2d on the grid through them.
"""

import json

import numpy as np
import pytest
import torch

from mathaudio_tpu.apps import qa_suite_fem as jax_qa
from mathaudio_tpu_torch.apps import qa_suite_fem
from mathaudio_tpu_torch.wave.analytical import cylinder_scattering_2d

CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sphere_case_matches_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    ref = jax_qa.sphere_case(1.0, 3, 1, "gmres_ilu", str(tmp_path / "ref"), verbose=0)
    got = qa_suite_fem.sphere_case(1.0, 3, 1, "gmres_ilu", str(tmp_path), verbose=0, **CPU64)
    assert got.name == ref.name == "fem_sphere_ka1_gmres_ilu"
    assert got.parameters == ref.parameters
    assert abs(got.metrics.l2_relative - ref.metrics.l2_relative) <= 1e-9 * ref.metrics.l2_relative
    for field in ("pressure_real", "pressure_imag"):
        np.testing.assert_allclose(getattr(got.analytical, field), getattr(ref.analytical, field),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(getattr(got.computed, field), getattr(ref.computed, field),
                                   rtol=0, atol=1e-9)
    assert got.metadata.backend == "cpu" and got.metadata.num_dofs == ref.metadata.num_dofs
    with open(tmp_path / "fem_sphere_ka1_gmres_ilu.json") as fh:
        assert json.load(fh)["name"] == got.name


def test_cylinder_closed_form_is_the_grid_oracle():
    r = np.array([1.0, 1.3, 2.4])
    theta = np.array([-2.5, 0.0, 0.7, 3.0])
    grid = cylinder_scattering_2d(2.0, 1.0, 40, r, theta, **CPU64).pressure.numpy().reshape(3, 4)
    rr, tt = np.meshgrid(r, theta, indexing="ij")
    got = qa_suite_fem._cylinder_exact(2.0, 1.0, 40, rr.ravel(), tt.ravel(), device="cpu")
    np.testing.assert_allclose(got.numpy(), grid.ravel(), rtol=0, atol=1e-12)
