"""FIR filters: windowed-sinc design + convolution processing
(counterpart of mathaudio_tpu/dsp/fir.py; math-iir-fir/src/fir.rs).

Design is host-side numpy (tiny); processing is the true convolution of
the reference's ``convolve(padded, taps, "valid")``, as
``torch.nn.functional.conv1d`` (a correlation) with the taps flipped; the
analytical response is the exact DTFT of the taps evaluated on the
frequency grid (fir.rs np_log_result analog).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Tuple

import numpy as np

import torch

from mathaudio_tpu_torch.dsp.iir import SRATE, _log_freq_grid, as_tensor


class FirFilterType(enum.Enum):
    LOWPASS = "LP"
    HIGHPASS = "HP"
    BANDPASS = "BP"
    BANDSTOP = "BS"


class WindowType(enum.Enum):
    RECTANGULAR = "rect"
    HAMMING = "hamming"
    HANN = "hann"
    BLACKMAN = "blackman"
    KAISER = "kaiser"


def generate_window(window: WindowType, n: int, kaiser_beta: float = 8.6) -> np.ndarray:
    """Window functions (fir.rs:529 generate_window)."""
    t = np.arange(n)
    if window == WindowType.RECTANGULAR:
        return np.ones(n)
    if window == WindowType.HAMMING:
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if window == WindowType.HANN:
        return 0.5 * (1 - np.cos(2 * np.pi * t / (n - 1)))
    if window == WindowType.BLACKMAN:
        return (
            0.42
            - 0.5 * np.cos(2 * np.pi * t / (n - 1))
            + 0.08 * np.cos(4 * np.pi * t / (n - 1))
        )
    if window == WindowType.KAISER:
        return np.i0(kaiser_beta * np.sqrt(1 - (2 * t / (n - 1) - 1) ** 2)) / np.i0(
            kaiser_beta
        )
    raise ValueError(window)


def _sinc_taps(cutoff_norm: float, n: int) -> np.ndarray:
    m = (n - 1) / 2.0
    t = np.arange(n) - m
    return 2 * cutoff_norm * np.sinc(2 * cutoff_norm * t)


@dataclasses.dataclass
class Fir:
    """Windowed-sinc FIR filter (fir.rs:9 Fir)."""

    filter_type: FirFilterType
    freq: float  # cutoff (LP/HP) or center (BP/BS), Hz
    srate: float = SRATE
    num_taps: int = 101
    window: WindowType = WindowType.HAMMING
    bandwidth: float = 0.0  # Hz, for BP/BS
    kaiser_beta: float = 8.6

    def __post_init__(self):
        if self.num_taps % 2 == 0:
            self.num_taps += 1  # force odd for symmetric linear phase
        w = generate_window(self.window, self.num_taps, self.kaiser_beta)
        fn = self.freq / self.srate
        n = self.num_taps
        if self.filter_type == FirFilterType.LOWPASS:
            h = _sinc_taps(fn, n)
        elif self.filter_type == FirFilterType.HIGHPASS:
            h = -_sinc_taps(fn, n)
            h[(n - 1) // 2] += 1.0
        else:
            bw_n = (self.bandwidth if self.bandwidth > 0 else self.freq / 2) / self.srate
            lo, hi = fn - bw_n / 2, fn + bw_n / 2
            band = _sinc_taps(hi, n) - _sinc_taps(lo, n)
            if self.filter_type == FirFilterType.BANDPASS:
                h = band
            else:  # BANDSTOP
                h = -band
                h[(n - 1) // 2] += 1.0
        h = h * w
        if self.filter_type == FirFilterType.LOWPASS:
            h = h / h.sum()  # unit DC gain
        self.taps = h

    def process_block(self, x, state: Optional[np.ndarray] = None, *, device=None):
        """Causal filtering of a block; ``state`` carries the previous
        num_taps-1 input samples (ring-buffer semantics of fir.rs:151)."""
        x = as_tensor(x, device)
        nt = self.num_taps
        if state is None:
            state = torch.zeros(nt - 1, dtype=x.dtype, device=x.device)
        padded = torch.cat([torch.as_tensor(state, dtype=x.dtype, device=x.device), x])
        taps = torch.as_tensor(self.taps[::-1].copy(), dtype=x.dtype, device=x.device)
        y = torch.nn.functional.conv1d(padded[None, None], taps[None, None])[0, 0]
        new_state = padded[-(nt - 1):]
        return y, new_state

    def process(self, x, *, device=None):
        y, _ = self.process_block(x, device=device)
        return y

    def np_log_result(self, freqs, *, device=None):
        """Exact DTFT magnitude in dB at the given frequencies."""
        freqs = as_tensor(freqs, device)
        n = self.num_taps
        k = torch.arange(n, device=freqs.device)
        phase = -2j * math.pi * freqs[:, None] * k[None, :] / self.srate
        taps = torch.as_tensor(self.taps, device=freqs.device)
        h = torch.sum(taps[None, :] * torch.exp(phase), dim=1)
        mag = torch.clamp_min(torch.abs(h), 1e-10)
        return 20.0 * torch.log10(mag)


@dataclasses.dataclass
class FirBank:
    """Weighted bank of FIR filters (fir.rs:708 FirBank)."""

    filters: List[Tuple[float, Fir]]

    def np_log_result(self, freqs, *, device=None):
        freqs = as_tensor(freqs, device)
        out = torch.zeros_like(freqs)
        for weight, f in self.filters:
            out = out + weight * f.np_log_result(freqs)
        return out

    def preamp_gain(self, *, device=None) -> float:
        freqs = _log_freq_grid(200, device)
        return -float(torch.clamp_min(torch.max(self.np_log_result(freqs)), 0.0))
