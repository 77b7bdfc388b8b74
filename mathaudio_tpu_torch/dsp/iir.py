"""Biquad filters and parametric EQ (counterpart of mathaudio_tpu/dsp/iir.py;
math-iir-fir/src/iir.rs).

Coefficients follow the RBJ Audio-EQ-Cookbook exactly as the reference
(iir.rs:236-323), including its Q defaulting rules (Notch forces Q=30,
zero Q selects the type default, Q clamped to >= 0.01): host Python, as
in the JAX package. The analytical magnitude-response path uses the same
r_up/r_dw rationals in sin^2(pi f / sr) (iir.rs:371-411) on tensors.

Functions that take frequencies keep a tensor where it lies; any other
input becomes a tensor on ``device`` (the GPU unless the caller passes
``device="cpu"``), float64 unless it already is a float32 array.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Tuple

import numpy as np
import torch

from mathaudio_tpu_torch.xtypes import resolve_device

SRATE = 48000.0
DEFAULT_Q_HIGH_LOW_PASS = 1.0 / math.sqrt(2.0)
DEFAULT_Q_HIGH_LOW_SHELF = 1.0668676536332304  # bw2q(0.9)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; anything
    else becomes a tensor on ``device`` (the GPU by default), float64
    unless it is a float32 array."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    a = np.asarray(x)
    if a.dtype != np.float32:
        a = a.astype(np.float64)
    return torch.as_tensor(a, device=resolve_device(device))


def bw2q(bw: float) -> float:
    """Bandwidth in octaves -> Q (mod.rs:58)."""
    t = 2.0**bw
    return math.sqrt(t) / (t - 1.0)


def q2bw(q: float) -> float:
    """Q -> bandwidth in octaves (mod.rs:65)."""
    q2 = (2.0 * q * q + 1.0) / (2.0 * q * q)
    return math.log2(q2 + math.sqrt(q2 * q2 - 1.0))


class BiquadFilterType(enum.Enum):
    LOWPASS = "LP"
    HIGHPASS = "HP"
    HIGHPASS_VARIABLE_Q = "HPQ"
    BANDPASS = "BP"
    PEAK = "PK"
    NOTCH = "NO"
    LOWSHELF = "LS"
    HIGHSHELF = "HS"

    @property
    def short_name(self) -> str:
        return self.value

    @property
    def long_name(self) -> str:
        return {
            "LP": "Lowpass", "HP": "Highpass", "HPQ": "HighpassVariableQ",
            "BP": "Bandpass", "PK": "Peak", "NO": "Notch",
            "LS": "Lowshelf", "HS": "Highshelf",
        }[self.value]


@dataclasses.dataclass
class Biquad:
    """One RBJ biquad. Coefficients are computed eagerly on the host (they
    are 5 scalars); processing and responses run on tensors."""

    filter_type: BiquadFilterType
    freq: float
    srate: float = SRATE
    q: float = 0.0
    db_gain: float = 0.0

    def __post_init__(self):
        # Q defaulting rules (iir.rs:146-166)
        if self.filter_type == BiquadFilterType.NOTCH:
            self.q = 30.0
        elif self.q == 0.0:
            if self.filter_type in (
                BiquadFilterType.BANDPASS,
                BiquadFilterType.HIGHPASS,
                BiquadFilterType.LOWPASS,
            ):
                self.q = DEFAULT_Q_HIGH_LOW_PASS
            elif self.filter_type in (BiquadFilterType.LOWSHELF, BiquadFilterType.HIGHSHELF):
                self.q = DEFAULT_Q_HIGH_LOW_SHELF
        if self.q <= 0.0:
            self.q = 1.0e-2
        self._compute_coeffs()

    @classmethod
    def try_new(cls, filter_type, freq, srate=SRATE, q=0.0, db_gain=0.0):
        """Validating constructor (iir.rs:204 try_new): raises ValueError
        for non-positive sample rates, frequencies outside (0, Nyquist),
        negative Q (0 = use default), or non-finite gain."""
        if not (srate > 0.0 and math.isfinite(srate)):
            raise ValueError(f"invalid sample rate {srate}")
        nyquist = srate / 2.0
        if not (0.0 < freq < nyquist) or not math.isfinite(freq):
            raise ValueError(f"invalid frequency {freq} (nyquist {nyquist})")
        if q < 0.0 or (q != 0.0 and not math.isfinite(q)):
            raise ValueError(f"invalid Q {q}")
        if not math.isfinite(db_gain):
            raise ValueError(f"invalid gain {db_gain}")
        return cls(filter_type, freq, srate, q, db_gain)

    def _compute_coeffs(self):
        ft = self.filter_type
        a = 10.0 ** (self.db_gain / 40.0)
        omega = 2.0 * math.pi * self.freq / self.srate
        sn, cs = math.sin(omega), math.cos(omega)
        alpha = sn / (2.0 * self.q)
        beta = math.sqrt(a + a)

        if ft == BiquadFilterType.LOWPASS:
            b0, b1, b2 = (1 - cs) / 2, 1 - cs, (1 - cs) / 2
            a0, a1, a2 = 1 + alpha, -2 * cs, 1 - alpha
        elif ft in (BiquadFilterType.HIGHPASS, BiquadFilterType.HIGHPASS_VARIABLE_Q):
            b0, b1, b2 = (1 + cs) / 2, -(1 + cs), (1 + cs) / 2
            a0, a1, a2 = 1 + alpha, -2 * cs, 1 - alpha
        elif ft == BiquadFilterType.BANDPASS:
            b0, b1, b2 = alpha, 0.0, -alpha
            a0, a1, a2 = 1 + alpha, -2 * cs, 1 - alpha
        elif ft == BiquadFilterType.NOTCH:
            b0, b1, b2 = 1.0, -2 * cs, 1.0
            a0, a1, a2 = 1 + alpha, -2 * cs, 1 - alpha
        elif ft == BiquadFilterType.PEAK:
            b0, b1, b2 = 1 + alpha * a, -2 * cs, 1 - alpha * a
            a0, a1, a2 = 1 + alpha / a, -2 * cs, 1 - alpha / a
        elif ft == BiquadFilterType.LOWSHELF:
            b0 = a * ((a + 1) - (a - 1) * cs + beta * sn)
            b1 = 2 * a * ((a - 1) - (a + 1) * cs)
            b2 = a * ((a + 1) - (a - 1) * cs - beta * sn)
            a0 = (a + 1) + (a - 1) * cs + beta * sn
            a1 = -2 * ((a - 1) + (a + 1) * cs)
            a2 = (a + 1) + (a - 1) * cs - beta * sn
        elif ft == BiquadFilterType.HIGHSHELF:
            b0 = a * ((a + 1) + (a - 1) * cs + beta * sn)
            b1 = -2 * a * ((a - 1) + (a + 1) * cs)
            b2 = a * ((a + 1) + (a - 1) * cs - beta * sn)
            a0 = (a + 1) - (a - 1) * cs + beta * sn
            a1 = 2 * ((a - 1) - (a + 1) * cs)
            a2 = (a + 1) - (a - 1) * cs - beta * sn
        else:
            raise ValueError(ft)

        self.b0, self.b1, self.b2 = b0 / a0, b1 / a0, b2 / a0
        self.a1, self.a2 = a1 / a0, a2 / a0

        # response rationals (iir.rs:317-323)
        self.r_up0 = (self.b0 + self.b1 + self.b2) ** 2
        self.r_up1 = -4.0 * (self.b0 * self.b1 + 4.0 * self.b0 * self.b2 + self.b1 * self.b2)
        self.r_up2 = 16.0 * self.b0 * self.b2
        self.r_dw0 = (1.0 + self.a1 + self.a2) ** 2
        self.r_dw1 = -4.0 * (self.a1 + 4.0 * self.a2 + self.a1 * self.a2)
        self.r_dw2 = 16.0 * self.a2

    def constants(self) -> Tuple[float, float, float, float, float]:
        """(a1, a2, b0, b1, b2) like iir.rs:413."""
        return (self.a1, self.a2, self.b0, self.b1, self.b2)

    def _phi(self, f, device):
        return torch.sin(math.pi * as_tensor(f, device) / self.srate) ** 2

    def result(self, f, *, device=None):
        """|H(f)| via the sin^2 rational (iir.rs:371)."""
        phi = self._phi(f, device)
        phi2 = phi * phi
        num = self.r_up0 + self.r_up1 * phi + self.r_up2 * phi2
        den = self.r_dw0 + self.r_dw1 * phi + self.r_dw2 * phi2
        return torch.sqrt(torch.clamp_min(num / den, 0.0))

    def log_result(self, f, *, device=None):
        r = self.result(f, device=device)
        return torch.where(r > 0, 20.0 * torch.log10(torch.clamp_min(r, 1e-300)), -200.0)

    def np_log_result(self, freqs, *, device=None):
        """dB response on a frequency grid (iir.rs:394), vectorized."""
        phi = self._phi(freqs, device)
        phi2 = phi * phi
        r_up = self.r_up0 + self.r_up1 * phi + self.r_up2 * phi2
        r_dw = self.r_dw0 + self.r_dw1 * phi + self.r_dw2 * phi2
        r = torch.clamp_min(r_up / r_dw, 1e-20)
        return 20.0 * torch.log10(torch.sqrt(r))

    def process_block(self, samples, state=None, *, device=None):
        """Filter a block (time on the last axis) by the log-depth scan of
        dsp/scan.py."""
        from mathaudio_tpu_torch.dsp.scan import biquad_process_block

        return biquad_process_block(
            as_tensor(samples, device),
            (self.b0, self.b1, self.b2, self.a1, self.a2),
            state=state,
        )

    def __str__(self):
        return (
            f"Type:{self.filter_type.short_name},Freq:{self.freq:.1f},"
            f"Rate:{self.srate:.1f},Q:{self.q:.1f},Gain:{self.db_gain:.1f}"
        )


Peq = List[Tuple[float, Biquad]]  # [(weight, biquad)] like iir.rs:17


def peq_spl(freqs, peq: Peq, *, device=None):
    """Combined weighted dB response (iir.rs:1278)."""
    freqs = as_tensor(freqs, device)
    out = torch.zeros_like(freqs)
    for weight, bq in peq:
        out = out + weight * bq.np_log_result(freqs)
    return out


def compute_peq_response(freqs, peq: Peq, sample_rate: float = SRATE, *, device=None):
    """Alias with the reference's signature (iir.rs:460)."""
    return peq_spl(freqs, peq, device=device)


def peq_equal(left: Peq, right: Peq) -> bool:
    if len(left) != len(right):
        return False
    for (wl, l), (wr, r) in zip(left, right):
        if wl != wr or l.filter_type != r.filter_type:
            return False
        if (l.freq, l.srate, l.q, l.db_gain) != (r.freq, r.srate, r.q, r.db_gain):
            return False
    return True


def _log_freq_grid(n: int, device=None):
    grid = torch.linspace(math.log10(20.0), math.log10(20000.0), n, dtype=torch.float64,
                          device=resolve_device(device))
    return 10.0**grid


def peq_preamp_gain(peq: Peq, *, device=None) -> float:
    """-max positive gain over 20 Hz..20 kHz (iir.rs:1427)."""
    spl = peq_spl(_log_freq_grid(200, device), peq)
    return -float(torch.clamp_min(torch.max(spl), 0.0))


def peq_preamp_gain_max(peq: Peq, *, device=None) -> float:
    """Worst case of combined vs individual responses + 0.2 dB margin
    (iir.rs:1454)."""
    if not peq:
        return 0.0
    freqs = _log_freq_grid(200, device)
    overall = float(torch.clamp_min(torch.max(peq_spl(freqs, peq)), 0.0))
    individual = 0.0
    for _, bq in peq:
        individual = max(individual, float(torch.max(bq.np_log_result(freqs))))
    return -(max(individual, overall) + 0.2)


def _a_weighting_db(f):
    f2 = f * f
    f4 = f2 * f2
    num = 12194.0**2 * f4
    den = (
        (f2 + 20.6**2)
        * torch.sqrt((f2 + 107.7**2) * (f2 + 737.9**2))
        * (f2 + 12194.0**2)
    )
    return 20.0 * torch.log10(num / den) + 2.0


def _k_weighting_db(f):
    f_hp = 38.0
    hp = torch.where(f > 1.0, 80.0 * torch.log10(torch.clamp_min(f, 1e-6) / f_hp), -200.0)
    hp = torch.clamp_max(hp, 0.0)
    f_hs = 1500.0
    hs = torch.where(f > f_hs, 4.0 * (1.0 - torch.clamp_max((f_hs / f) ** 2, 1.0)), 0.0)
    return hp + hs


def peq_loudness_gain(peq: Peq, weighting: str = "k", *, device=None) -> float:
    """Analytical EBU-R128-approx loudness compensation (iir.rs:1368) —
    the '1000x faster than Replay Gain' path of the reference README."""
    if not peq:
        return 0.0
    n = 500
    freqs = _log_freq_grid(n, device)
    peq_db = peq_spl(freqs, peq)
    if weighting == "a":
        w_db = _a_weighting_db(freqs)
    elif weighting == "k":
        w_db = _k_weighting_db(freqs)
    else:
        w_db = torch.zeros_like(freqs)
    w_lin = 10.0 ** (w_db / 20.0)
    ratio = 10.0 ** (peq_db / 20.0)
    weighted_change = torch.sum(w_lin * w_lin * (ratio * ratio - 1.0))
    avg = weighted_change / n
    return -float(10.0 * torch.log10(1.0 + avg))


def peq_butterworth_q(order: int) -> List[float]:
    """Butterworth section Qs; odd order appends -1 sentinel (iir.rs:1567)."""
    qs = [1.0 / (2.0 * math.sin(math.pi / order * (i + 0.5))) for i in range(order // 2)]
    if order % 2 == 1:
        qs.append(-1.0)
    return qs


def peq_butterworth_lowpass(order: int, freq: float, srate: float = SRATE) -> Peq:
    return [
        (1.0, Biquad(BiquadFilterType.LOWPASS, freq, srate, q, 0.0))
        for q in peq_butterworth_q(order)
    ]


def peq_butterworth_highpass(order: int, freq: float, srate: float = SRATE) -> Peq:
    return [
        (1.0, Biquad(BiquadFilterType.HIGHPASS, freq, srate, q, 0.0))
        for q in peq_butterworth_q(order)
    ]


def peq_linkwitzriley_q(order: int) -> List[float]:
    """LR = squared Butterworth of half order (iir.rs:1634)."""
    q_bw = peq_butterworth_q(order // 2)
    if order % 4 != 0:
        qs = q_bw[:-1] + q_bw[:-1]
        qs.append(0.5)
    else:
        qs = q_bw + q_bw
    return qs


def peq_linkwitzriley_lowpass(order: int, freq: float, srate: float = SRATE) -> Peq:
    return [
        (1.0, Biquad(BiquadFilterType.LOWPASS, freq, srate, q, 0.0))
        for q in peq_linkwitzriley_q(order)
    ]


def peq_linkwitzriley_highpass(order: int, freq: float, srate: float = SRATE) -> Peq:
    return [
        (1.0, Biquad(BiquadFilterType.HIGHPASS, freq, srate, q, 0.0))
        for q in peq_linkwitzriley_q(order)
    ]


def get_filter_priority(filter_type: BiquadFilterType) -> int:
    """Band-retention priority when a hardware band limit forces drops
    (iir.rs:1975): shelves shape the overall curve (9), LP/HP (7),
    bandpass (5), peak (3), everything else (1)."""
    if filter_type in (BiquadFilterType.LOWSHELF, BiquadFilterType.HIGHSHELF):
        return 9
    if filter_type in (
        BiquadFilterType.LOWPASS,
        BiquadFilterType.HIGHPASS,
        BiquadFilterType.HIGHPASS_VARIABLE_Q,
    ):
        return 7
    if filter_type == BiquadFilterType.BANDPASS:
        return 5
    if filter_type == BiquadFilterType.PEAK:
        return 3
    return 1


def filter_peqs_by_gain(peq: Peq, max_count: int) -> Peq:
    """Keep at most ``max_count`` bands, preferring high priority then
    high |gain|, preserving the original band order (iir.rs:2000)."""
    if len(peq) <= max_count:
        return list(peq)
    ranked = sorted(
        range(len(peq)),
        key=lambda i: (-get_filter_priority(peq[i][1].filter_type), -abs(peq[i][1].db_gain)),
    )[:max_count]
    return [peq[i] for i in sorted(ranked)]


def peq_print(peq: Peq) -> str:
    """Formatted filter table (iir.rs:1697), returned as a string."""
    lines = [f"{'#':>2} {'Type':<4} {'Freq(Hz)':>9} {'Q':>6} {'Gain(dB)':>8}"]
    for i, (_, bq) in enumerate(peq):
        lines.append(
            f"{i + 1:>2} {bq.filter_type.short_name:<4} {bq.freq:>9.1f} "
            f"{bq.q:>6.2f} {bq.db_gain:>8.2f}"
        )
    return "\n".join(lines)
