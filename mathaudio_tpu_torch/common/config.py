"""Room JSON config schema (counterpart of mathaudio_tpu/common/config.py;
pure Python and numpy): the files under configs/ load unchanged, and
``RoomConfig.from_file(...).to_simulation()`` resolves the schema into
concrete geometry, sources and frequencies.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

from mathaudio_tpu_torch.common.geometry import LShapedRoom, RectangularRoom, RoomGeometry
from mathaudio_tpu_torch.common.source import CrossoverFilter, DirectivityPattern, Source
from mathaudio_tpu_torch.common.types import Point3D


@dataclasses.dataclass
class SurfaceSpec:
    """rigid | absorption{coefficient} | impedance{real, imag}"""

    kind: str = "rigid"
    coefficient: float = 0.0
    impedance: complex = 0.0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SurfaceSpec":
        if not d:
            return cls()
        t = d.get("type", "rigid")
        if t == "rigid":
            return cls("rigid")
        if t == "absorption":
            return cls("absorption", coefficient=float(d["coefficient"]))
        if t == "impedance":
            return cls("impedance", impedance=complex(d["real"], d["imag"]))
        raise ValueError(f"unknown surface type {t}")

    def robin_alpha(self, k: float) -> complex:
        """Robin coefficient for du/dn + alpha u = 0 on this surface.

        With the e^{+ikr}/e^{-i omega t} convention, a wall of normalized
        admittance beta = rho c / Z absorbs when alpha = -ik beta (see
        fem.boundary.RobinBC.admittance). rigid -> 0; absorption
        coefficient a maps to beta = (1-sqrt(1-a))/(1+sqrt(1-a)).
        """
        if self.kind == "rigid":
            return 0.0
        if self.kind == "absorption":
            a = min(max(self.coefficient, 0.0), 0.9999)
            root = np.sqrt(1.0 - a)
            beta = (1.0 - root) / (1.0 + root)  # normalized admittance
            return -1j * k * beta
        z = self.impedance
        if z == 0:
            return 0.0
        return -1j * k / z


@dataclasses.dataclass
class FrequencySpec:
    """Frequency grid of a run."""

    min_freq: float
    max_freq: float
    num_points: int
    spacing: str = "logarithmic"

    def generate_frequencies(self) -> np.ndarray:
        if self.num_points == 1:
            return np.asarray([self.min_freq])
        if self.spacing == "linear":
            return np.linspace(self.min_freq, self.max_freq, self.num_points)
        return np.logspace(
            np.log10(self.min_freq), np.log10(self.max_freq), self.num_points
        )


@dataclasses.dataclass
class GmresSpec:
    max_iter: int = 100
    restart: int = 50
    tolerance: float = 1e-6


@dataclasses.dataclass
class IluSpec:
    method: str = "tbem"
    scanning_degree: str = "fine"
    use_hierarchical: bool = False


@dataclasses.dataclass
class FmmSpec:
    fmm_type: str = "slfmm"
    expansion_order: int = 6
    max_particles_per_leaf: int = 50


@dataclasses.dataclass
class SolverSpec:
    """Solver settings of a run."""

    method: str = "direct"
    mesh_resolution: int = 2
    gmres: GmresSpec = dataclasses.field(default_factory=GmresSpec)
    ilu: IluSpec = dataclasses.field(default_factory=IluSpec)
    fmm: FmmSpec = dataclasses.field(default_factory=FmmSpec)
    adaptive_integration: bool = False
    adaptive_meshing: Optional[bool] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SolverSpec":
        d = d or {}
        return cls(
            method=d.get("method", "direct"),
            mesh_resolution=int(d.get("mesh_resolution", 2)),
            gmres=GmresSpec(**d.get("gmres", {})),
            ilu=IluSpec(**d.get("ilu", {})),
            fmm=FmmSpec(**d.get("fmm", {})),
            adaptive_integration=bool(d.get("adaptive_integration", False)),
            adaptive_meshing=d.get("adaptive_meshing"),
        )


@dataclasses.dataclass
class VisualizationSpec:
    generate_slices: bool = False
    slice_resolution: int = 50
    slice_frequency_indices: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BoundarySpec:
    floor: SurfaceSpec = dataclasses.field(default_factory=SurfaceSpec)
    ceiling: SurfaceSpec = dataclasses.field(default_factory=SurfaceSpec)
    walls: SurfaceSpec = dataclasses.field(default_factory=SurfaceSpec)
    front_wall: Optional[SurfaceSpec] = None
    back_wall: Optional[SurfaceSpec] = None
    left_wall: Optional[SurfaceSpec] = None
    right_wall: Optional[SurfaceSpec] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "BoundarySpec":
        d = d or {}

        def opt(key):
            return SurfaceSpec.from_dict(d[key]) if key in d and d[key] else None

        return cls(
            floor=SurfaceSpec.from_dict(d.get("floor")),
            ceiling=SurfaceSpec.from_dict(d.get("ceiling")),
            walls=SurfaceSpec.from_dict(d.get("walls")),
            front_wall=opt("front_wall"),
            back_wall=opt("back_wall"),
            left_wall=opt("left_wall"),
            right_wall=opt("right_wall"),
        )

    def wall_specs(self) -> Dict[str, SurfaceSpec]:
        """Per-wall spec with overrides resolved. Keys match the FEM box
        tags: left=1(x0), right=2(x1), front=3(y0), back=4(y1),
        floor=5(z0), ceiling=6(z1)."""
        return {
            "left": self.left_wall or self.walls,
            "right": self.right_wall or self.walls,
            "front": self.front_wall or self.walls,
            "back": self.back_wall or self.walls,
            "floor": self.floor,
            "ceiling": self.ceiling,
        }


WALL_TAGS = {"left": 1, "right": 2, "front": 3, "back": 4, "floor": 5, "ceiling": 6}


@dataclasses.dataclass
class RoomConfig:
    """Top-level JSON schema."""

    room: Dict[str, Any]
    sources: List[Dict[str, Any]]
    listening_positions: List[Dict[str, float]]
    frequencies: FrequencySpec
    boundaries: BoundarySpec = dataclasses.field(default_factory=BoundarySpec)
    solver: SolverSpec = dataclasses.field(default_factory=SolverSpec)
    visualization: VisualizationSpec = dataclasses.field(default_factory=VisualizationSpec)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoomConfig":
        return cls(
            room=d["room"],
            sources=d.get("sources", []),
            listening_positions=d.get("listening_positions", []),
            frequencies=FrequencySpec(**d["frequencies"]),
            boundaries=BoundarySpec.from_dict(d.get("boundaries")),
            solver=SolverSpec.from_dict(d.get("solver")),
            visualization=VisualizationSpec(**(d.get("visualization") or {})),
            metadata=d.get("metadata", {}),
        )

    @classmethod
    def from_file(cls, path: str) -> "RoomConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def to_dict(self) -> Dict[str, Any]:
        def surf(s: Optional[SurfaceSpec]):
            if s is None:
                return None
            if s.kind == "rigid":
                return {"type": "rigid"}
            if s.kind == "absorption":
                return {"type": "absorption", "coefficient": s.coefficient}
            return {"type": "impedance", "real": s.impedance.real, "imag": s.impedance.imag}

        b = {
            "floor": surf(self.boundaries.floor),
            "ceiling": surf(self.boundaries.ceiling),
            "walls": surf(self.boundaries.walls),
        }
        for key in ("front_wall", "back_wall", "left_wall", "right_wall"):
            v = getattr(self.boundaries, key)
            if v is not None:
                b[key] = surf(v)
        return {
            "room": self.room,
            "sources": self.sources,
            "listening_positions": self.listening_positions,
            "frequencies": dataclasses.asdict(self.frequencies),
            "boundaries": b,
            "solver": {
                "method": self.solver.method,
                "mesh_resolution": self.solver.mesh_resolution,
                "gmres": dataclasses.asdict(self.solver.gmres),
                "ilu": dataclasses.asdict(self.solver.ilu),
                "fmm": dataclasses.asdict(self.solver.fmm),
                "adaptive_integration": self.solver.adaptive_integration,
            },
            "visualization": dataclasses.asdict(self.visualization),
            "metadata": self.metadata,
        }

    def to_file(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    def to_simulation(self) -> "RoomSimulation":
        """Resolve into concrete geometry/sources."""
        rt = self.room.get("type", "rectangular")
        if rt == "rectangular":
            geometry = RoomGeometry(
                RectangularRoom(
                    self.room["width"], self.room["depth"], self.room["height"]
                )
            )
        elif rt == "lshaped":
            geometry = RoomGeometry(
                LShapedRoom(
                    self.room["width1"],
                    self.room["depth1"],
                    self.room["width2"],
                    self.room["depth2"],
                    self.room["height"],
                )
            )
        else:
            raise ValueError(f"unknown room type {rt}")

        sources = []
        for s in self.sources:
            dcfg = s.get("directivity", {"type": "omnidirectional"})
            if dcfg.get("type", "omnidirectional") == "omnidirectional":
                patt = DirectivityPattern.omnidirectional()
            elif dcfg.get("type") == "cardioid":  # convenience beyond the
                patt = DirectivityPattern.cardioid()  # reference's omni/custom
            else:
                patt = DirectivityPattern(
                    np.asarray(dcfg["horizontal_angles"], float),
                    np.asarray(dcfg["vertical_angles"], float),
                    np.asarray(dcfg["magnitude"], float),
                )
            ccfg = s.get("crossover", {"type": "fullrange"})
            ct = ccfg.get("type", "fullrange")
            if ct == "fullrange":
                cross = CrossoverFilter.full_range()
            elif ct == "lowpass":
                cross = CrossoverFilter.lowpass(ccfg["cutoff_freq"], ccfg.get("order", 2))
            elif ct == "highpass":
                cross = CrossoverFilter.highpass(ccfg["cutoff_freq"], ccfg.get("order", 2))
            else:
                cross = CrossoverFilter.bandpass(
                    ccfg["low_cutoff"], ccfg["high_cutoff"], ccfg.get("order", 2)
                )
            p = s["position"]
            src = Source(
                Point3D(p["x"], p["y"], p["z"]),
                patt,
                s.get("amplitude", 1.0),
                cross,
                s.get("name", "Source"),
            )
            sources.append(src)

        listening = [Point3D(p["x"], p["y"], p["z"]) for p in self.listening_positions]
        freqs = self.frequencies.generate_frequencies()
        return RoomSimulation(self, geometry, sources, listening, freqs)


@dataclasses.dataclass
class RoomSimulation:
    """Resolved simulation inputs."""

    config: RoomConfig
    geometry: RoomGeometry
    sources: List[Source]
    listening_positions: List[Point3D]
    frequencies: np.ndarray


def load_room_config(path: str) -> RoomConfig:
    return RoomConfig.from_file(path)
