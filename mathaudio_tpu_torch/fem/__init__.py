"""Volume FEM Helmholtz engine (counterpart of mathaudio_tpu/fem).

Meshes are generated and analysed on the host (numpy); assembly and
solves run on the device: element matrices from one batched contraction
over all elements, one ``index_add_`` into a fixed CSR/ELL sparsity shared
across the frequency sweep, and per-frequency values as one elementwise
combine K - k^2 M + sum(coeff_tag * B_tag). Re-exports the reference's
names that are ported; the quadrilateral and hexahedral generators come
with the rest of slice 6c.
"""

from mathaudio_tpu_torch.fem.mesh import (  # noqa: F401
    Mesh,
    rectangular_mesh_triangles,
    box_mesh_tetrahedra,
    circular_mesh_triangles,
    annular_mesh_triangles,
    spherical_shell_mesh_tetrahedra,
    unit_square_triangles,
    unit_cube_tetrahedra,
)
from mathaudio_tpu_torch.fem.basis import element_tables  # noqa: F401
from mathaudio_tpu_torch.fem.assembly import (  # noqa: F401
    assemble_stiffness_mass,
    assemble_lumped_mass,
    assemble_boundary_mass,
    assemble_rhs,
    HelmholtzAssembler,
)
from mathaudio_tpu_torch.fem.boundary import DirichletBC, RobinBC, NeumannBC  # noqa: F401
from mathaudio_tpu_torch.fem.problem import HelmholtzProblem, solve_helmholtz  # noqa: F401
