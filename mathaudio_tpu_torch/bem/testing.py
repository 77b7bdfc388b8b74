"""Validation result artifacts (counterpart of mathaudio_tpu/bem/testing.py;
pure Python and numpy): computed-vs-analytical comparisons with error
metrics, execution metadata, JSON persistence, and pass/fail thresholds,
the common currency of the QA suites. ``ExecutionMetadata.backend`` holds
the torch device type ("cuda" or "cpu") where the reference writes JAX's
default backend."""

from __future__ import annotations

import dataclasses
import datetime
import json
import platform
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ErrorMetrics:
    """Absolute and relative L2 and the max error of computed vs analytical."""

    l2_error: float
    l2_relative: float
    linf_error: float

    @classmethod
    def compute(cls, computed, analytical) -> "ErrorMetrics":
        c = np.asarray(computed)
        a = np.asarray(analytical)
        diff = c - a
        l2 = float(np.linalg.norm(diff))
        norm = float(np.linalg.norm(a))
        return cls(
            l2_error=l2,
            l2_relative=l2 / norm if norm > 1e-15 else l2,
            linf_error=float(np.abs(diff).max()) if len(diff) else 0.0,
        )


@dataclasses.dataclass
class SolutionData:
    positions: List[List[float]]
    pressure_real: List[float]
    pressure_imag: List[float]

    @classmethod
    def from_arrays(cls, positions, pressure) -> "SolutionData":
        p = np.asarray(pressure)
        return cls(
            positions=np.asarray(positions).tolist(),
            pressure_real=p.real.tolist(),
            pressure_imag=p.imag.tolist(),
        )


@dataclasses.dataclass
class ExecutionMetadata:
    timestamp: str = dataclasses.field(
        default_factory=lambda: datetime.datetime.now().isoformat()
    )
    host: str = dataclasses.field(default_factory=platform.node)
    backend: str = ""
    wall_time_s: float = 0.0
    solver: str = ""
    num_dofs: int = 0


@dataclasses.dataclass
class ValidationResult:
    """One QA case: parameters, both solutions, metrics, metadata."""

    name: str
    parameters: Dict[str, Any]
    analytical: SolutionData
    computed: SolutionData
    metrics: ErrorMetrics
    metadata: ExecutionMetadata

    @classmethod
    def create(
        cls,
        name: str,
        positions,
        computed_pressure,
        analytical_pressure,
        parameters: Optional[Dict[str, Any]] = None,
        metadata: Optional[ExecutionMetadata] = None,
    ) -> "ValidationResult":
        return cls(
            name=name,
            parameters=parameters or {},
            analytical=SolutionData.from_arrays(positions, analytical_pressure),
            computed=SolutionData.from_arrays(positions, computed_pressure),
            metrics=ErrorMetrics.compute(
                np.asarray(computed_pressure), np.asarray(analytical_pressure)
            ),
            metadata=metadata or ExecutionMetadata(),
        )

    def passed(self, threshold: float) -> bool:
        """Relative L2 below ``threshold``."""
        return self.metrics.l2_relative < threshold

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save_json(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    @classmethod
    def load_json(cls, path: str) -> "ValidationResult":
        with open(path) as fh:
            d = json.load(fh)
        return cls(
            name=d["name"],
            parameters=d["parameters"],
            analytical=SolutionData(**d["analytical"]),
            computed=SolutionData(**d["computed"]),
            metrics=ErrorMetrics(**d["metrics"]),
            metadata=ExecutionMetadata(**d["metadata"]),
        )

    def print_summary(self) -> str:
        s = (
            f"{self.name}: rel L2 = {self.metrics.l2_relative:.3e}, "
            f"Linf = {self.metrics.linf_error:.3e}, "
            f"N = {self.metadata.num_dofs}, solver = {self.metadata.solver}"
        )
        print(s)
        return s
