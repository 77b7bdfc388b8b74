"""Surface BEM Helmholtz engine (counterpart of mathaudio_tpu/bem).

Constant-element collocation as batched pairwise kernels (hand-written
CUDA on the GPU, ops/bem_assembly.py), Burton–Miller coupling, dense LU
or GMRES solves, Kirchhoff–Helmholtz field evaluation as a second
pairwise kernel, the interior room BEM, and the fast multipole methods
(bem/fmm.py: the single-level FMM, the two-level MLFMM and the MLFMM tree)
with their near-field preconditioners and the cluster-major solve
(bem/fmm_chip.py). The reference's other ``fmm_chip`` names (re/im planes
for a transport without complex numbers) have no counterpart.
"""

from mathaudio_tpu_torch.bem.types import (  # noqa: F401
    PhysicsParams,
    BCType,
    BemMethod,
    BoundaryCondition,
    SolverMethod,
    BemSolverConfig,
)
from mathaudio_tpu_torch.bem.mesh import (  # noqa: F401
    SurfaceMesh,
    icosphere,
    uv_sphere,
    cylinder_mesh,
)
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
    build_mlfmm_system,
    build_mlfmm_tree_mixed_system,
    build_mlfmm_tree_system,
    build_room_fmm_system,
    build_slfmm_mixed_system,
    build_slfmm_system,
    gather_form,
    sel_form,
    near_ilu_preconditioner,
)
from mathaudio_tpu_torch.bem.fmm_chip import fmm_chip_solve_cm_fn  # noqa: F401
