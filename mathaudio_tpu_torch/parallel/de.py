"""Population-sharded DE evaluation (counterpart of
mathaudio_tpu/parallel/de.py; math-differential-evolution's rayon
population map, parallel_eval.rs:32): each rank evaluates its contiguous
slice of the population, and the energies are gathered back in population
order; the deferred-update selection needs no communication."""

from __future__ import annotations

import torch

from mathaudio_tpu_torch.parallel.mesh import run_split


def shard_population_eval(mesh, energy_fn, axis: str = "freq"):
    """(pop (NP, n)) -> (NP,) energies on every rank, with the population
    split over the mesh axis and ``energy_fn`` (a function of one float
    tensor) vmapped over each rank's slice on its device. NP must split
    evenly over the axis."""

    def eval_pop(pop):
        return run_split(mesh, axis, pop, torch.func.vmap(energy_fn), "individuals")

    return eval_pop
