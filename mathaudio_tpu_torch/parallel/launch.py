"""Run one function in ``world`` processes, one rank each (port-only: the
JAX package runs one controller over all its devices, PyTorch runs one
process per rank).

    from mathaudio_tpu_torch.parallel.launch import launch
    results = launch(fn, 4, *args)                       # NCCL, cuda:0..3
    results = launch(fn, 4, *args, backend="gloo")       # the CPU

``fn(rank, world, *args)`` must be importable by name (a module-level
function of a module that a fresh interpreter can import): the children are
spawned, and each imports ``fn``'s module anew. Its return value is pickled
back to the parent, after every tensor in it has been moved to the CPU.
Under NCCL, rank r runs on ``cuda:r`` (``torch.cuda.set_device``): NCCL
refuses two ranks on one card, so the world is at most the card count.

The process group is initialised from a file in a fresh temporary
directory (no TCP port to clash with a neighbouring run), with a timeout:
a collective that one rank never joins fails every rank after
``timeout`` seconds instead of hanging. A rank that fails exits at once,
without tearing its process group down (its peers may be waiting in a
collective), and the parent then stops the others; the parent also stops
every rank still running after ``join_timeout`` seconds (3 minutes unless
the caller gives another bound), and first has it dump every thread's stack
(``faulthandler``), which the error then carries.
It raises the first failure with the failing rank's traceback. The
arguments go to the ranks through a file in that directory, not through
the spawn pipe: a pipe write larger than its buffer would wait for each
child to import torch, one child after the other. Each rank runs one intra-op
thread (``THREADS``), in torch and in the BLAS and OpenMP pools that numpy
and scipy use (set in the children's environment before they start): the
ranks share the host's cores, and some MKL builds hang in batched complex
inverses with more than one.

Under ``torchrun``, skip this module: ``torchrun`` starts the processes and
sets the environment that ``init_device_mesh`` reads.
"""

from __future__ import annotations

import datetime
import faulthandler
import multiprocessing
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback

import torch

THREADS = 1  # intra-op threads per rank
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

def _to_cpu(obj):
    """``obj`` with every tensor in it (in tuples, lists, dicts and
    NamedTuples) moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _dump(path, result):
    """Pickle ``result`` to ``path`` whole or not at all (the parent may
    kill a rank at any moment)."""
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


def _child(fn, rank, world, backend, timeout, tmp):
    import torch.distributed as dist

    out = os.path.join(tmp, f"rank{rank}.pkl")
    stack = open(os.path.join(tmp, f"rank{rank}.stack"), "w")
    faulthandler.register(signal.SIGUSR1, file=stack, all_threads=True)
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(THREADS)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "pg"),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        result = ("ok", _to_cpu(fn(rank, world, *args)))
    except Exception:  # every failure goes back to the parent, which raises it
        _dump(out, ("error", (time.time(), traceback.format_exc())))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    _dump(out, result)


def _stack(tmp, rank) -> str:
    """The stack that a timed-out ``rank`` dumped, as a suffix of its
    failure line."""
    path, text = os.path.join(tmp, f"rank{rank}.stack"), ""
    if os.path.exists(path):  # not if it was stopped before it could register
        with open(path) as f:
            text = f.read().strip()
    return f"; its stack:\n{text}" if text else "; it dumped no stack"


def launch(fn, world: int, *args, backend: str = "nccl", timeout: float = 90.0,
           join_timeout: float = 180.0):
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own spawned process under one ``backend`` process group (see the
    module docstring). Raises RuntimeError with every rank's failure, the
    earliest first, then the ranks that timed out (each with its stack),
    died or were stopped."""
    if backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"NCCL needs one card per rank: {world} ranks, "
                           f"{torch.cuda.device_count()} card(s)")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mathaudio_launch_")
    try:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_child, args=(fn, r, world, backend, timeout, tmp),
                             daemon=True)
                 for r in range(world)]
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: str(THREADS) for k in _THREAD_VARS})
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + join_timeout
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.1)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = any(p.exitcode for p in procs)
        if alive and not failed:  # timed out: each stuck rank dumps its stack
            for r in alive:
                os.kill(procs[r].pid, signal.SIGUSR1)
            time.sleep(1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results, errors, failures = [], [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                why = (("stopped after another rank failed" if failed
                        else f"timed out after {join_timeout:g} s")
                       if r in alive else f"died (exit code {procs[r].exitcode})")
                stack = _stack(tmp, r) if r in alive and not failed else ""
                failures.append(f"rank {r} {why} without a result{stack}")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append((value[0], f"rank {r} failed:\n{value[1]}"))
        failures = [msg for _, msg in sorted(errors)] + failures
        if failures:
            raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, world={world}, "
                               f"backend={backend}): " + "\n".join(failures))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
