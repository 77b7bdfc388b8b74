"""3D convex hull (counterpart of mathaudio_tpu/hull; the reference crate
math-convex-hull).

Quickhull runs on host numpy, as in the JAX package (irregular, tiny,
preprocessing-only — SURVEY.md §7 point 7), from the port's own copy of
its code; exports OBJ/HTML like the reference, string for string.
"""

from mathaudio_tpu_torch.hull.quickhull import (  # noqa: F401
    ConvexHull3D,
    Face,
    quickhull_3d,
    convex_hull_3d,
)
from mathaudio_tpu_torch.hull.export import hull_to_obj, hull_to_html  # noqa: F401
from mathaudio_tpu_torch.hull.testdata import cube_points, sphere_points, random_points  # noqa: F401
