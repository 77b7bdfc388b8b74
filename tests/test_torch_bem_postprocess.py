"""Port vs reference: Kirchhoff–Helmholtz field evaluation
(bem/postprocess.py: evaluate_field, FieldResult and the point
generators).

Both packages get the same mesh and the same seeded surface fields (numpy
arrays) on the CPU in float64: a rigid surface under a plane wave (double
layer only) and a radiating one with dp/dn (single and double layer), in
one shot and in chunks of 24 field points (50 points leave a ragged last
chunk of 2, which the reference pads). Fields agree to 1e-10 of max|p|.
The reference's jitted evaluation runs eagerly (``jax.disable_jit``).
"""

import jax
import numpy as np
import pytest
import torch

from mathaudio_tpu.bem import postprocess as jax_post
from mathaudio_tpu.bem.incident import plane_wave as jax_plane_wave
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu_torch.bem import postprocess as post
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.convert import surface_mesh_from_numpy

K = 1.7


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jm = jax_icosphere(1.0, 1)
    rng = np.random.default_rng(5)
    n = jm.num_elements
    p_surf = rng.normal(size=n) + 1j * rng.normal(size=n)
    q_surf = rng.normal(size=n) + 1j * rng.normal(size=n)
    points = np.concatenate([
        post.generate_sphere_eval_points(2.0, 4, 6),
        post.generate_line_eval_points((1.5, 0.0, 0.0), (4.0, 1.0, -2.0), 10),
        post.generate_plane_eval_points((0.0, 0.0, 2.5), (0.0, 0.0, 1.0), 1.0, 4),
    ])
    assert points.shape == (50, 3)
    return jm, surface_mesh_from_numpy(jm.nodes, jm.elements), p_surf, q_surf, points


@pytest.mark.parametrize("row_block", [None, 24], ids=["one_shot", "rows24_ragged"])
@pytest.mark.parametrize("radiating", [False, True], ids=["rigid", "with_q_surf"])
@pytest.mark.parametrize("with_incident", [True, False], ids=["plane_wave", "no_incident"])
def test_evaluate_field_matches_reference(setup, with_incident, radiating, row_block):
    jm, tm, p_surf, q_surf, points = setup
    d = (0.2, 0.1, 1.0)
    with jax.disable_jit():
        ref = jax_post.evaluate_field(
            jm, p_surf, points, K, jax_plane_wave(d) if with_incident else None,
            q_surf=q_surf if radiating else None, row_block=row_block)
    got = post.evaluate_field(
        tm, p_surf, points, K, plane_wave(d) if with_incident else None,
        q_surf=q_surf if radiating else None, row_block=row_block,
        dtype=torch.float64, device="cpu")
    assert got.p_scat.dtype == torch.complex128 and tuple(got.p_total.shape) == (50,)
    scale = np.max(np.abs(np.asarray(ref.p_total)))
    for field in ("p_inc", "p_scat", "p_total"):
        err = np.max(np.abs(getattr(got, field).numpy() - np.asarray(getattr(ref, field))))
        assert err < 1e-10 * scale, (field, err)
    np.testing.assert_allclose(got.spl_db.numpy(), np.asarray(ref.spl_db), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.points.numpy(), points, rtol=0, atol=0)


def test_field_row_block_is_the_kernel_sizing_of_the_reference():
    """On the CPU; on the GPU the chunk follows the kernel's output planes
    (the rule of the assembly), which needs no card to evaluate."""
    from types import SimpleNamespace

    from mathaudio_tpu.bem.assembly import _auto_row_block

    like = torch.zeros(1, dtype=torch.float64)
    for n in (80, 2048, 5120, 20480):
        for want_single in (True, False):
            assert post.field_row_block(n, 8192, like, want_single) == _auto_row_block(n, 3)
    card = SimpleNamespace(device=torch.device("cuda"), element_size=lambda: 4)
    assert post.field_row_block(5120, 8192, card, True) == 8192  # 0.67 GB of planes: one launch
    assert post.field_row_block(5120, 512, card, True) == 512
    # 4 GiB / (81920 elements x 4 planes x 4 B) = 3276 rows -> 2048; without S, 6553 -> 4096
    assert post.field_row_block(81920, 8192, card, True) == 2048
    assert post.field_row_block(81920, 8192, card, False) == 4096


@pytest.mark.parametrize("shape", [(3, 5), (1, 1), (64, 128)])
def test_sphere_points_match_reference(shape):
    np.testing.assert_array_equal(post.generate_sphere_eval_points(2.5, *shape),
                                  jax_post.generate_sphere_eval_points(2.5, *shape))


@pytest.mark.parametrize("n", [1, 2, 17])
def test_line_points_match_reference(n):
    args = ((0.1, -1.0, 2.0), (3.0, 0.5, -2.0), n)
    np.testing.assert_array_equal(post.generate_line_eval_points(*args),
                                  jax_post.generate_line_eval_points(*args))


@pytest.mark.parametrize("normal", [(0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.3, -0.5, 0.8)])
def test_plane_points_match_reference(normal):
    args = ((0.5, 0.0, -1.0), normal, 2.0, 5)
    np.testing.assert_array_equal(post.generate_plane_eval_points(*args),
                                  jax_post.generate_plane_eval_points(*args))


def test_fmm_evaluation_names_its_slice():
    with pytest.raises(ValueError, match="slice 5"):
        post.evaluate_field_fmm(None, None, None, 1.0)
