"""The benchmark of the PyTorch/CUDA port (``mathaudio_tpu_torch``).

``BENCHMARK.json`` at the checkout's root names the cells; ``run.py`` runs
one; ``spec.py`` finds each cell's files by name: ``configs/`` (the
configurations as run), ``workloads/`` (the traffic mixes ``traffic.py``
reads), ``metrics/`` (one reader per metric), ``systems/`` (how each
configuration drives the program), ``reference/`` (the plain float64
references the check compares with). ``work.py`` and ``timeline.py`` are
the yardstick's arithmetic; ``readings.py`` gives the readings a cell's
limits are set from. Nothing here imports JAX or the JAX package.
"""
