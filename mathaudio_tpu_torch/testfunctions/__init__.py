"""Optimization benchmark suite (counterpart of mathaudio_tpu/testfunctions).

Counterpart of the reference crate ``math-test-functions`` (SURVEY.md
§2.8): ~100 standard test functions with a metadata registry (bounds,
global minima, constraints, modality, admissible dimensions). All
functions are pure torch ``f(x: (n,)) -> scalar`` so ``torch.func.vmap``
batches them over DE populations on the device.
"""

from mathaudio_tpu_torch.testfunctions.registry import (  # noqa: F401
    FunctionMetadata,
    FUNCTIONS,
    get_function,
    get_function_metadata,
    list_functions,
)
