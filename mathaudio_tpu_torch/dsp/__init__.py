"""IIR/FIR audio DSP engine (counterpart of mathaudio_tpu/dsp).

Counterpart of the reference crate ``math-iir-fir`` (SURVEY.md §2.6).
The sequential Direct-Form-I recurrence of iir.rs:324-341 becomes a
log-depth doubling scan over tensors (dsp/scan.py); the analytical
response path (np_log_result rationals) is a vectorized tensor op, and
dsp/response.py (the JAX package's jax_response.py) makes it
differentiable; designers and exporters are host Python. The denormal
guard is a documented no-op.
"""

from mathaudio_tpu_torch.dsp.iir import (  # noqa: F401
    Biquad,
    BiquadFilterType,
    Peq,
    SRATE,
    DEFAULT_Q_HIGH_LOW_PASS,
    DEFAULT_Q_HIGH_LOW_SHELF,
    bw2q,
    q2bw,
    compute_peq_response,
    peq_spl,
    peq_equal,
    peq_preamp_gain,
    peq_preamp_gain_max,
    peq_loudness_gain,
    peq_butterworth_q,
    peq_butterworth_lowpass,
    peq_butterworth_highpass,
    peq_linkwitzriley_q,
    peq_linkwitzriley_lowpass,
    peq_linkwitzriley_highpass,
    peq_print,
    get_filter_priority,
    filter_peqs_by_gain,
)
from mathaudio_tpu_torch.dsp.scan import (  # noqa: F401
    biquad_process_block,
    biquad_cascade_block,
    peq_coeff_matrix,
)
from mathaudio_tpu_torch.dsp.fir import (  # noqa: F401
    Fir,
    FirBank,
    FirFilterType,
    WindowType,
    generate_window,
)
from mathaudio_tpu_torch.dsp.denormals import ScopedFlushToZero, flush_denormals  # noqa: F401
from mathaudio_tpu_torch.dsp.formats import (  # noqa: F401
    peq_format_apo,
    peq_format_rme_channel,
    peq_format_rme_room,
    peq_format_aupreset,
)
