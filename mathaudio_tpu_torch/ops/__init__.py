"""Hand-written CUDA kernels' Python side for the BEM hot path
(counterpart of mathaudio_tpu/ops): the pairwise quadrature sums of the
dense collocation assembly and of the field evaluation, each dispatching
to kernels/bem_pairwise.cu on the card and to its plain torch twin on the
CPU; the ``*_xla`` names are the twins under the reference's names.
Nothing is built while this package is imported.
"""

from mathaudio_tpu_torch.ops.bem_assembly import (  # noqa: F401
    pairwise_bm,
    pairwise_bm_xla,
    pairwise_double_layer,
    pairwise_double_layer_xla,
    pairwise_kh,
    pairwise_kh_xla,
)
