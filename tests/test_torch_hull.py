"""Port vs reference: the 3D convex hull (slice 7b, host numpy in both).

On the point sets of the reference's own tests (tests/test_hull.py) the
port's Quickhull keeps the same points, finds the same vertices and the same
faces in the same order, with volume and area within 1e-12, exports the same
OBJ and HTML strings, and raises the same ValueError on degenerate input.
The test-data generators draw the same seeded numpy streams.
"""

import numpy as np
import pytest

from mathaudio_tpu import hull as ref_hull
from mathaudio_tpu.hull import testdata as ref_testdata
from mathaudio_tpu_torch import hull
from mathaudio_tpu_torch.hull import testdata

POINT_SETS = {
    "cube+30": lambda td: td.cube_points(extra_interior=30),
    "tetra": lambda td: np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]),
    "normal50": lambda td: np.random.default_rng(0).standard_normal((50, 3)),
    "normal200": lambda td: np.random.default_rng(1).standard_normal((200, 3)),
    "normal500": lambda td: np.random.default_rng(2).standard_normal((500, 3)),
    "sphere150": lambda td: td.sphere_points(150),
    "cube": lambda td: td.cube_points(),
    "cube-twice": lambda td: np.vstack([td.cube_points(), td.cube_points()]),
    "cube*1e-6": lambda td: td.cube_points() * 1e-6,
    "cube*1e6": lambda td: td.cube_points() * 1e6,
    "octahedron": lambda td: np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                                       [0, 0, 1], [0, 0, -1]], float),
    "cube+interior": lambda td: np.vstack(
        [td.cube_points(), np.random.default_rng(7).uniform(0.3, 0.7, (200, 3))]),
    "icosahedron": lambda td: td.icosahedron_points(),
    "fibonacci180": lambda td: td.fibonacci_sphere_points(180, radius=2.0),
    "random500": lambda td: td.random_points(500),
    "sphere500": lambda td: td.sphere_points(500),
}
DEGENERATE = {
    "flat": np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.0]]),
    "coplanar": np.column_stack([np.random.default_rng(0).random((20, 2)), np.zeros(20)]),
    "three points": np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]),
    "one x": np.array([[0.0, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 1]]),
    "collinear": np.array([[0.0, 0, 0], [1, 1, 1], [2, 2, 2], [3, 3, 3]]),
}


@pytest.mark.parametrize("name", POINT_SETS)
def test_hull_is_the_reference(name):
    pts = POINT_SETS[name](testdata)
    np.testing.assert_array_equal(pts, POINT_SETS[name](ref_testdata))
    got, want = hull.quickhull_3d(pts), ref_hull.quickhull_3d(pts)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert [f.vertices for f in got.faces] == [f.vertices for f in want.faces]
    for f, r in zip(got.faces, want.faces):
        np.testing.assert_array_equal(f.normal, r.normal)
        assert f.offset == r.offset
    assert got.num_faces == want.num_faces
    np.testing.assert_allclose(got.volume(), want.volume(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.surface_area(), want.surface_area(), rtol=1e-12, atol=0)
    assert hull.hull_to_obj(got) == ref_hull.hull_to_obj(want)
    assert hull.hull_to_html(got, title=name) == ref_hull.hull_to_html(want, title=name)
    probe = pts.mean(axis=0) + np.array([0.1, -0.2, 0.3]) * np.ptp(pts, axis=0)
    assert got.contains(probe) == want.contains(probe)


@pytest.mark.parametrize("name", DEGENERATE)
def test_degenerate_input_raises_as_the_reference(name):
    with pytest.raises(ValueError) as ref_err:
        ref_hull.quickhull_3d(DEGENERATE[name])
    with pytest.raises(ValueError) as err:
        hull.convex_hull_3d(DEGENERATE[name])
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("gen,args", [("cube_points", (5, 3)), ("sphere_points", (40, 2.0, 9)),
                                      ("random_points", (40, 5)),
                                      ("fibonacci_sphere_points", (33, 0.5)),
                                      ("icosahedron_points", (3.0,))])
def test_testdata_draws_the_reference_streams(gen, args):
    np.testing.assert_array_equal(getattr(testdata, gen)(*args), getattr(ref_testdata, gen)(*args))
    np.testing.assert_array_equal(getattr(testdata, gen)(), getattr(ref_testdata, gen)())
