"""Differential evolution optimizer.

Counterpart of the reference crate ``math-differential-evolution``
(SURVEY.md §2.7): SciPy-style DE with 14 strategies, binomial/exponential
crossover, Latin-hypercube init, penalty constraints, JADE-style
adaptation, optional local polish, per-evaluation recording.

Port of mathaudio_tpu/optim (DE, the recorder and the PEQ fit; the
test-function suite is mathaudio_tpu_torch.testfunctions). The population is a
float64 tensor on the device and objective evaluation is vmapped with
``torch.func.vmap`` (the reference crate uses rayon, parallel_eval.rs:32).
``jit_loop=True`` keeps the JAX package's stopping rule without
per-generation hooks; the host-loop mode keeps per-generation
callbacks/recording exactly like the reference.
"""

from mathaudio_tpu_torch.optim.de import (  # noqa: F401
    Strategy,
    Mutation,
    Init,
    Crossover,
    LinearPenalty,
    LinearConstraintHelper,
    NonlinearConstraintHelper,
    AdaptiveConfig,
    PolishConfig,
    DEConfig,
    DEConfigBuilder,
    DEReport,
    DEIntermediate,
    CallbackAction,
    differential_evolution,
)
from mathaudio_tpu_torch.optim.recorder import (  # noqa: F401
    RecordedEvaluation,
    run_recorded_differential_evolution,
)
from mathaudio_tpu_torch.optim.peq_fit import PeqFitResult, fit_peq  # noqa: F401
