"""Multi-GPU parallelism on torch.distributed (counterpart of
mathaudio_tpu/parallel/): frequency-sharded sweeps (the data-parallel
analog), DoF-sharded operators and solves (the tensor-parallel analog,
spmd.py), the cluster-sharded FMM (fmm_spmd.py) and the population-sharded
DE evaluator, over a ``torch.distributed`` DeviceMesh with the reference's
axis names. One process per rank and one card per rank (NCCL); gloo runs
the same code on the CPU. ``launch.py`` starts the ranks (or use
``torchrun``); ``dryrun.py`` is the port's multi-rank dry run.
"""

from mathaudio_tpu_torch.parallel.mesh import (  # noqa: F401
    sweep_mesh,
    shard_frequency_sweep,
    shard_room_params,
    pmean_convergence,
)
from mathaudio_tpu_torch.parallel.de import shard_population_eval  # noqa: F401
