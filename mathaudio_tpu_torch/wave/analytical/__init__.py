"""Analytical wave/Helmholtz solutions, the validation oracle (counterpart
of mathaudio_tpu/wave/analytical). Positions and pressures are tensors.
"""

from mathaudio_tpu_torch.wave.analytical.solution import (  # noqa: F401
    AnalyticalSolution,
    l2_error,
    relative_l2_error,
    linf_error,
    from_spherical,
    from_polar,
)
from mathaudio_tpu_torch.wave.analytical.solutions_1d import (  # noqa: F401
    plane_wave_1d,
    standing_wave_1d,
    damped_wave_1d,
    helmholtz_1d_mode,
)
from mathaudio_tpu_torch.wave.analytical.solutions_2d import (  # noqa: F401
    cylinder_scattering_2d,
    cylinder_directivity_2d,
    cylinder_scattering_cross_section_2d,
    plane_wave_2d,
    rigid_cylinder_coefficients,
)
from mathaudio_tpu_torch.wave.analytical.solutions_3d import (  # noqa: F401
    sphere_scattering_3d,
    sphere_scattered_pressure_3d,
    rigid_sphere_coefficients,
    classify_regime,
    sphere_rcs_3d,
    sphere_scattering_efficiency_3d,
    plane_wave_3d,
    point_source_3d,
)
