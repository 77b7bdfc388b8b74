"""Physics parameters and configs (counterpart of mathaudio_tpu/bem/types.py;
pure Python and numpy).

Includes the Burton–Miller beta variants (plain i/k, bounded i/(k+k_ref),
element-size-optimal, scaled) and the solver/method enums.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from mathaudio_tpu_torch.xtypes import AIR_DENSITY, SPEED_OF_SOUND


@dataclasses.dataclass
class PhysicsParams:
    """Frequency-domain physics."""

    frequency: float
    speed_of_sound: float = SPEED_OF_SOUND
    density: float = AIR_DENSITY
    is_interior: bool = False
    harmonic_factor: float = 1.0  # tau in the reference

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * self.frequency

    @property
    def wave_number(self) -> float:
        return self.omega / self.speed_of_sound

    @classmethod
    def from_wave_number(cls, k: float, **kw) -> "PhysicsParams":
        c = kw.pop("speed_of_sound", SPEED_OF_SOUND)
        return cls(frequency=k * c / (2.0 * math.pi), speed_of_sound=c, **kw)

    # Burton–Miller coupling variants
    def burton_miller_beta(self) -> complex:
        """Classic beta = i/k."""
        return 1j * self.harmonic_factor / self.wave_number

    def burton_miller_beta_bounded(self, k_ref: float) -> complex:
        """beta = i/(k + k_ref): avoids the 1/k blowup at low frequency."""
        return 1j / (self.wave_number + k_ref)

    def burton_miller_beta_optimal(self, avg_element_size: float) -> complex:
        """Element-size-aware bound: k_ref = 1/h."""
        return self.burton_miller_beta_bounded(1.0 / max(avg_element_size, 1e-12))

    def burton_miller_beta_scaled(self, scale: float) -> complex:
        return scale * self.burton_miller_beta()

    def optimal_beta_scale(self, ka: float) -> float:
        """Empirical scale vs ka: larger
        coupling at low ka, ~1 in the geometric regime."""
        if ka < 0.5:
            return 4.0
        if ka < 2.0:
            return 2.0
        return 1.0


class BCType(enum.IntEnum):
    """Per-element boundary-condition kind."""

    VELOCITY = 0  # prescribed normal velocity (Neumann); unknown is p
    PRESSURE = 1  # prescribed pressure (Dirichlet); unknown is dp/dn


@dataclasses.dataclass
class BoundaryCondition:
    """Struct-of-arrays per-element boundary data: ``types[i]`` in BCType,
    ``values[i]`` the prescribed velocity [m/s] (VELOCITY) or pressure [Pa]
    (PRESSURE).

    ``admittance[i]`` (normalized, beta = rho c Y) couples a velocity
    element to a locally-reacting absorber: dp/dn = i omega rho v_n
    - i k beta p (absorbing for Re beta > 0, normals into the fluid; the
    same -ik beta convention as the FEM absorbing Robin BC)."""

    types: "object"  # (N,) int array-like
    values: "object"  # (N,) complex array-like
    admittance: "object" = None  # (N,) complex, velocity elements only

    @staticmethod
    def _expand(values, n):
        v = np.atleast_1d(np.asarray(values, complex))
        if n is not None:
            v = np.array(np.broadcast_to(v, (n,)))
        return v

    @classmethod
    def velocity(cls, values, n: int | None = None) -> "BoundaryCondition":
        v = cls._expand(values, n)
        return cls(types=np.zeros(len(v), np.int32), values=v)

    @classmethod
    def velocity_with_admittance(
        cls, values, admittance, n: int | None = None
    ) -> "BoundaryCondition":
        """Structural velocity plus a normalized surface admittance (see class docstring for the sign
        convention)."""
        v = cls._expand(values, n)
        a = cls._expand(admittance, len(v))
        return cls(types=np.zeros(len(v), np.int32), values=v, admittance=a)

    @classmethod
    def pressure(cls, values, n: int | None = None) -> "BoundaryCondition":
        p = cls._expand(values, n)
        return cls(types=np.full(len(p), 1, np.int32), values=p)


class BemMethod(enum.Enum):
    TBEM = "tbem"  # dense collocation
    SLFMM = "slfmm"  # single-level FMM
    MLFMM = "mlfmm"  # multi-level FMM


class SolverMethod(enum.Enum):
    """Linear solver of the assembled system. The iterative methods are
    Jacobi-preconditioned; GMRES_ILU runs Jacobi-GMRES, as in the JAX
    package."""

    LU = "lu"
    GMRES = "gmres"
    GMRES_ILU = "gmres_ilu"
    BICGSTAB = "bicgstab"
    CGS = "cgs"
    QMRCGSTAB = "qmrcgstab"


@dataclasses.dataclass
class BemSolverConfig:
    """Solver configuration of BemSolver."""

    method: SolverMethod = SolverMethod.LU
    assembly: BemMethod = BemMethod.TBEM
    tolerance: float = 1e-8
    max_iterations: int = 1000
    restart: int = 50
    burton_miller: bool = True
    beta_scale: float = 4.0
    # Honored as-is on every path, including mixed velocity/pressure
    # systems; raise it explicitly for tighter mixed-BC tolerances.
    quad_order: int = 3
    # A torch.distributed DeviceMesh with a "dof" axis: a rigid problem's
    # dense non-LU solve then runs row-sharded over the axis's ranks
    # (BemSolver._solve_sharded); mixed problems and the FMM ignore it.
    device_mesh: object = None
