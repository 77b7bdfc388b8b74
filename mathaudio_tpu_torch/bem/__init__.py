"""Surface BEM Helmholtz engine (counterpart of mathaudio_tpu/bem).

Constant-element collocation as batched pairwise kernels (hand-written
CUDA on the GPU, ops/bem_assembly.py), Burton–Miller coupling, dense LU
or GMRES solves, Kirchhoff–Helmholtz field evaluation as a second
pairwise kernel, the interior room BEM, and the single-level FMM
(bem/fmm.py) with its near-field preconditioners. The multilevel FMM is
slice 5b of the port; the reference's ``fmm_chip`` names (re/im planes for
a transport without complex numbers) have no counterpart.
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
from mathaudio_tpu_torch.bem.fmm import (  # noqa: F401
    ClusterBlockPreconditioner,
    build_room_fmm_system,
    build_slfmm_mixed_system,
    build_slfmm_system,
    gather_form,
    sel_form,
    near_ilu_preconditioner,
)
