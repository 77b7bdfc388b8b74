"""Special functions (counterpart of mathaudio_tpu/wave/special): all
orders at once, stacked ``(nmax+1, *x.shape)``, so series summations
become single contractions.
"""

from mathaudio_tpu_torch.wave.special.bessel import (  # noqa: F401
    bessel_jn_all,
    bessel_jn_yn_all,
    hankel1_all,
    bessel_j0,
    bessel_j1,
    bessel_y0,
    bessel_y1,
)
from mathaudio_tpu_torch.wave.special.spherical import (  # noqa: F401
    spherical_jn_all,
    spherical_yn_all,
    spherical_jn_yn_all,
    spherical_hankel1_all,
    spherical_bessel_derivative,
)
from mathaudio_tpu_torch.wave.special.legendre import (  # noqa: F401
    legendre_all,
    legendre_p,
    legendre_derivative_all,
    associated_legendre_all,
    normalized_associated_legendre_all,
)
from mathaudio_tpu_torch.wave.special.helmholtz import (  # noqa: F401
    greens_function_3d,
    greens_function_2d,
    greens_function_gradient_3d,
    greens_function_normal_derivative_3d,
    greens_function_adjoint_derivative_3d,
    greens_function_hypersingular_3d,
    all_kernels_3d,
    laplace_greens_function_3d,
    laplace_greens_function_2d,
)
