"""Automatic speaker EQ: fit a parametric EQ to a target response with
differential evolution (counterpart of mathaudio_tpu/optim/peq_fit.py) —
the end-to-end flow the reference workspace exists to serve
(BASELINE.json: 'DE over Peq params against target SPL via
compute_peq_response'; the reference's AUTOEQ_DE_TIMING hooks).

The objective runs on the device: the differentiable biquad responses
(dsp.response) are summed and compared to the target on a log-frequency
grid, and DE vmaps it over the population.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mathaudio_tpu_torch.dsp.iir import SRATE, Biquad, BiquadFilterType, Peq, as_tensor, peq_spl
from mathaudio_tpu_torch.dsp.response import peq_response_db
from mathaudio_tpu_torch.optim.de import DEConfig, differential_evolution
from mathaudio_tpu_torch.xtypes import resolve_device

_KIND_TO_TYPE = {
    "PK": BiquadFilterType.PEAK,
    "LS": BiquadFilterType.LOWSHELF,
    "HS": BiquadFilterType.HIGHSHELF,
}


@dataclasses.dataclass
class PeqFitResult:
    peq: Peq
    params: np.ndarray  # (n, 3): log10 f0, Q, gain dB
    rms_error_db: float
    report: object  # DEReport

    def response_db(self, freqs, *, device=None):
        return peq_spl(freqs, self.peq, device=device)


def fit_peq(
    freqs,
    target_db,
    n_filters: int = 5,
    kinds: Optional[Sequence[str]] = None,
    freq_range: Tuple[float, float] = (20.0, 20000.0),
    q_range: Tuple[float, float] = (0.2, 8.0),
    gain_range: Tuple[float, float] = (-18.0, 18.0),
    srate: float = SRATE,
    weight=None,
    config: Optional[DEConfig] = None,
    maxiter: int = 400,
    seed: int = 0,
    *,
    device=None,
) -> PeqFitResult:
    """Fit ``n_filters`` parametric filters so their summed response
    matches ``target_db`` on ``freqs`` (least squares, optional per-point
    weights), on ``device`` (the GPU unless ``device="cpu"``). Default
    layout: LS + PK... + HS when n_filters >= 3."""
    dev = resolve_device(device)

    def f64(a):
        return as_tensor(a, dev).to(torch.float64)

    freqs = f64(freqs)
    target = f64(target_db)
    w = torch.ones_like(freqs) if weight is None else f64(weight)
    w = w / torch.sum(w)

    if kinds is None:
        if n_filters >= 3:
            kinds = ["LS"] + ["PK"] * (n_filters - 2) + ["HS"]
        else:
            kinds = ["PK"] * n_filters
    kinds = list(kinds)
    n = len(kinds)

    def objective(x):
        params = x.reshape(n, 3)
        resp = peq_response_db(kinds, params, freqs, srate)
        return torch.sum(w * (resp - target) ** 2)

    lo_f, hi_f = np.log10(freq_range[0]), np.log10(freq_range[1])
    bounds = []
    for i in range(n):
        # spread initial frequency bands logarithmically per filter slot
        span = (hi_f - lo_f) / n
        bounds.append((lo_f + i * span * 0.5, hi_f - (n - 1 - i) * span * 0.5))
        bounds.append(q_range)
        bounds.append(gain_range)

    cfg = config or DEConfig(maxiter=maxiter, seed=seed, tol=0.0, popsize=15)
    report = differential_evolution(objective, bounds, config=cfg, device=dev)

    params = np.asarray(report.x).reshape(n, 3)
    peq: Peq = []
    for kind, (lf, q, g) in zip(kinds, params):
        peq.append((1.0, Biquad(_KIND_TO_TYPE[kind], float(10.0**lf), srate, float(q), float(g))))
    rms = float(np.sqrt(report.fun))
    return PeqFitResult(peq=peq, params=params, rms_error_db=rms, report=report)
