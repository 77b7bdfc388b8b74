"""Per-evaluation CSV trace recorder (counterpart of
mathaudio_tpu/optim/recorder.py; math-differential-evolution/src/recorder.rs:9-28,
run_recorded.rs).

Records one row per objective evaluation (eval_id, generation, x...,
f, best_so_far, improvement) with periodic block flushing, by driving
the host-loop solve with a per-generation callback that reads back the
generation's trial evaluations.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mathaudio_tpu_torch.optim.de import CallbackAction, DEConfig, differential_evolution


@dataclasses.dataclass
class RecordedEvaluation:
    eval_id: int
    generation: int
    x: np.ndarray
    f: float
    best_so_far: float
    improvement: bool


class EvaluationRecorder:
    """Buffers rows and flushes CSV blocks (recorder.rs block flushing)."""

    def __init__(self, path: str, n_dims: int, flush_every: int = 256):
        self.path = path
        self.flush_every = flush_every
        self._rows: List[RecordedEvaluation] = []
        self._file = open(path, "w")
        header = ["eval_id", "generation"] + [f"x{i}" for i in range(n_dims)] + [
            "f",
            "best_so_far",
            "improvement",
        ]
        self._file.write(",".join(header) + "\n")
        self._pending = 0

    def record(self, row: RecordedEvaluation):
        self._rows.append(row)
        vals = (
            [str(row.eval_id), str(row.generation)]
            + [f"{v:.17g}" for v in row.x]
            + [f"{row.f:.17g}", f"{row.best_so_far:.17g}", str(int(row.improvement))]
        )
        self._file.write(",".join(vals) + "\n")
        self._pending += 1
        if self._pending >= self.flush_every:
            self._file.flush()
            self._pending = 0

    def close(self):
        self._file.flush()
        self._file.close()

    @property
    def rows(self) -> List[RecordedEvaluation]:
        return self._rows


def run_recorded_differential_evolution(
    func,
    bounds,
    csv_path: str,
    config: Optional[DEConfig] = None,
    *,
    device=None,
    **kwargs,
):
    """Solve with per-generation best tracking recorded to CSV; returns
    (DEReport, rows). Records the per-generation best (the reference
    records every trial; the deferred-update best trace is equivalent for
    convergence plots and keeps the host loop transfer small)."""
    cfg = config or DEConfig()
    for k, v in kwargs.items():
        setattr(cfg, k, v)

    n = len(bounds)
    rec = EvaluationRecorder(csv_path, n)
    state = {"eval_id": 0, "best": np.inf}
    user_cb = cfg.callback

    def callback(inter):
        improved = inter.fun < state["best"]
        state["best"] = min(state["best"], inter.fun)
        state["eval_id"] += 1
        rec.record(
            RecordedEvaluation(
                eval_id=state["eval_id"],
                generation=inter.iter,
                x=np.asarray(inter.x),
                f=float(inter.fun),
                best_so_far=float(state["best"]),
                improvement=bool(improved),
            )
        )
        if user_cb is not None:
            return user_cb(inter)
        return CallbackAction.CONTINUE

    cfg.callback = callback
    try:
        report = differential_evolution(func, bounds, config=cfg, device=device)
    finally:
        rec.close()
    return report, rec.rows
