"""Surface BEM Helmholtz engine (counterpart of mathaudio_tpu/bem).

Constant-element collocation as batched pairwise kernels (hand-written
CUDA on the GPU, ops/bem_assembly.py), Burton–Miller coupling, dense LU
or GMRES solves, Kirchhoff–Helmholtz field evaluation as a second
pairwise kernel, and the interior room BEM. The FMM engines are a later
slice of the port.
"""

from mathaudio_tpu_torch.bem.types import (  # noqa: F401
    PhysicsParams,
    BCType,
    BemMethod,
    BoundaryCondition,
    SolverMethod,
    BemSolverConfig,
)
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh, icosphere  # noqa: F401
from mathaudio_tpu_torch.bem.incident import IncidentField, plane_wave, point_source  # noqa: F401
from mathaudio_tpu_torch.bem.assembly import (  # noqa: F401
    assemble_collocation_matrix,
    assemble_burton_miller,
    assemble_mixed_system,
)
from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver, BemSolution  # noqa: F401
from mathaudio_tpu_torch.bem.postprocess import (  # noqa: F401
    FieldResult,
    evaluate_field,
    generate_line_eval_points,
    generate_plane_eval_points,
    generate_sphere_eval_points,
)
