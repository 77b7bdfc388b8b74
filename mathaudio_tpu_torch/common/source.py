"""Sound sources: directivity patterns + crossover filters (counterpart
of mathaudio_tpu/common/source.py; pure Python and numpy)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from mathaudio_tpu_torch.common.types import Point3D


@dataclasses.dataclass
class DirectivityPattern:
    """Measured-grid directivity with bilinear interpolation
    (10-degree grid for the built-in patterns)."""

    horizontal_angles: np.ndarray  # degrees, (H,)
    vertical_angles: np.ndarray  # degrees, (V,)
    magnitude: np.ndarray  # (V, H)

    @classmethod
    def omnidirectional(cls) -> "DirectivityPattern":
        h = np.arange(36) * 10.0
        v = np.arange(19) * 10.0
        return cls(h, v, np.ones((19, 36)))

    @classmethod
    def cardioid(cls) -> "DirectivityPattern":
        h = np.arange(36) * 10.0
        v = np.arange(19) * 10.0
        theta = np.deg2rad(v)[:, None]
        phi = np.deg2rad(h)[None, :]
        forward = np.sin(theta) * np.sin(phi)
        return cls(h, v, np.maximum(0.5 * (1.0 + forward), 0.0))

    def interpolate(self, theta: float, phi: float) -> float:
        """Bilinear lookup; theta polar from +z, phi azimuth (radians)."""
        theta_deg = math.degrees(theta)
        phi_deg = math.degrees(phi) % 360.0
        h_idx = min(int(phi_deg / 10.0), len(self.horizontal_angles) - 1)
        v_idx = min(int(theta_deg / 10.0), len(self.vertical_angles) - 1)
        h_next = (h_idx + 1) % len(self.horizontal_angles)
        v_next = min(v_idx + 1, len(self.vertical_angles) - 1)
        h_frac = phi_deg / 10.0 - h_idx
        v_frac = theta_deg / 10.0 - v_idx
        m00 = self.magnitude[v_idx, h_idx]
        m01 = self.magnitude[v_idx, h_next]
        m10 = self.magnitude[v_next, h_idx]
        m11 = self.magnitude[v_next, h_next]
        m0 = m00 * (1 - h_frac) + m01 * h_frac
        m1 = m10 * (1 - h_frac) + m11 * h_frac
        return float(m0 * (1 - v_frac) + m1 * v_frac)

    def interpolate_array(self, theta, phi):
        """Vectorized bilinear lookup over numpy arrays (same semantics as
        ``interpolate``)."""
        mag = np.asarray(self.magnitude)
        nh = len(self.horizontal_angles)
        nv = len(self.vertical_angles)
        theta_deg = np.rad2deg(theta)
        phi_deg = np.rad2deg(phi) % 360.0
        h_idx = np.minimum((phi_deg / 10.0).astype(np.int32), nh - 1)
        v_idx = np.minimum((theta_deg / 10.0).astype(np.int32), nv - 1)
        h_next = (h_idx + 1) % nh
        v_next = np.minimum(v_idx + 1, nv - 1)
        h_frac = phi_deg / 10.0 - h_idx
        v_frac = theta_deg / 10.0 - v_idx
        m0 = mag[v_idx, h_idx] * (1 - h_frac) + mag[v_idx, h_next] * h_frac
        m1 = mag[v_next, h_idx] * (1 - h_frac) + mag[v_next, h_next] * h_frac
        return m0 * (1 - v_frac) + m1 * v_frac


@dataclasses.dataclass
class CrossoverFilter:
    """Butterworth-magnitude crossover; kind one of
    fullrange | lowpass | highpass | bandpass."""

    kind: str = "fullrange"
    cutoff_freq: float = 0.0
    low_cutoff: float = 0.0
    high_cutoff: float = 0.0
    order: int = 2

    @classmethod
    def full_range(cls) -> "CrossoverFilter":
        return cls()

    @classmethod
    def lowpass(cls, cutoff_freq: float, order: int = 2):
        return cls("lowpass", cutoff_freq=cutoff_freq, order=order)

    @classmethod
    def highpass(cls, cutoff_freq: float, order: int = 2):
        return cls("highpass", cutoff_freq=cutoff_freq, order=order)

    @classmethod
    def bandpass(cls, low_cutoff: float, high_cutoff: float, order: int = 2):
        return cls("bandpass", low_cutoff=low_cutoff, high_cutoff=high_cutoff, order=order)

    def amplitude_at_frequency(self, frequency: float) -> float:
        if self.kind == "fullrange":
            return 1.0
        if self.kind == "lowpass":
            ratio = frequency / self.cutoff_freq
            return 1.0 / math.sqrt(1.0 + ratio ** (2 * self.order))
        if self.kind == "highpass":
            ratio = self.cutoff_freq / frequency
            return 1.0 / math.sqrt(1.0 + ratio ** (2 * self.order))
        hp = 1.0 / math.sqrt(1.0 + (self.low_cutoff / frequency) ** (2 * self.order))
        lp = 1.0 / math.sqrt(1.0 + (frequency / self.high_cutoff) ** (2 * self.order))
        return hp * lp


@dataclasses.dataclass
class Source:
    """Point source with directivity/crossover."""

    position: Point3D
    directivity: DirectivityPattern
    amplitude: float = 1.0
    crossover: CrossoverFilter = dataclasses.field(default_factory=CrossoverFilter)
    name: str = "Source"

    @classmethod
    def omnidirectional(cls, position: Point3D, amplitude: float = 1.0) -> "Source":
        return cls(position, DirectivityPattern.omnidirectional(), amplitude)

    def with_crossover(self, crossover: CrossoverFilter) -> "Source":
        self.crossover = crossover
        return self

    def with_name(self, name: str) -> "Source":
        self.name = name
        return self

    def amplitude_towards(self, point: Point3D, frequency: float) -> float:
        """Directional amplitude toward a point at a frequency."""
        d = point - self.position
        r = d.norm()
        cf = self.crossover.amplitude_at_frequency(frequency)
        if r < 1e-10:
            return self.amplitude * cf
        theta = math.acos(max(-1.0, min(1.0, d.z / r)))
        phi = math.atan2(d.y, d.x)
        return self.amplitude * self.directivity.interpolate(theta, phi) * cf
