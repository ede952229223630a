"""Multi-rank gloo groups for the port's tests of its multi-device modes.

:func:`run_group` starts ``world`` Python processes that join one gloo
group through a ``file://`` store under a test's temporary directory (no
TCP port, so parallel test workers cannot collide), each runs
``case(rank, world, **kwargs)`` given by its ``module:function`` name, and
the parent returns their results (anything picklable; tensors as numpy).
The group's timeout is 60 s; the parent joins the processes with a
deadline and kills them all and fails on expiry, never waiting forever.

The workers import ``aki_torch`` and the case's module only, never ``jax``
(a worker fails if jax was imported): the parent pytest process computes
the JAX references. The cases live in modules without JAX, such as this
one (``tests/_torch_dist_cases.py``).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_CHILD = """
import datetime, importlib, os, pickle, sys, traceback
sys.path[:0] = [{root!r}, {here!r}]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, spec, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
with open(spec, "rb") as f:
    case, kwargs, store = pickle.load(f)
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
try:
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    mod, fn = case.split(":")
    result = getattr(importlib.import_module(mod), fn)(rank, world, **kwargs)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "aki_tpu"))
    assert not bad, f"a worker imported {{bad[:5]}}"
    dist.barrier()
    dist.destroy_process_group()
    payload = ("ok", result)
except BaseException:
    payload = ("error", traceback.format_exc())
with open(out, "wb") as f:
    pickle.dump(payload, f)
sys.exit(0 if payload[0] == "ok" else 1)
"""


def run_group(case: str, world: int, tmp_path, timeout: float = 240.0, **kwargs) -> list:
    """Run ``case`` ("module:function") on ``world`` gloo ranks; returns the
    ranks' results in rank order. Raises with the failing ranks' tracebacks,
    or after ``timeout`` seconds with every process killed."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store_{os.getpid()}_{time.monotonic_ns()}"
    spec = tmp / "case.pkl"
    with open(spec, "wb") as f:
        pickle.dump((case, kwargs, str(store)), f)
    code = _CHILD.format(root=str(ROOT), here=str(HERE))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONHASHSEED": "0"}
    procs, outs, logs = [], [], []
    for r in range(world):
        outs.append(tmp / f"rank{r}.pkl")
        logs.append(open(tmp / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(spec), str(outs[r])],
            cwd=str(ROOT), env=env, stdout=logs[r], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            left = deadline - time.monotonic()
            p.wait(timeout=max(left, 0.01))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        tails = [(tmp / f"rank{r}.log").read_text()[-3000:] for r in range(world)]
        raise TimeoutError(f"{case} on {world} ranks passed its {timeout} s deadline; "
                           f"killed.\n" + "\n".join(tails))
    finally:
        for log in logs:
            log.close()
    results, errors = [], []
    for r, out in enumerate(outs):
        if not out.exists():
            errors.append(f"rank {r}: no result (exit {procs[r].returncode}):\n"
                          + (tmp / f"rank{r}.log").read_text()[-3000:])
            continue
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if errors:
        raise RuntimeError(f"{case} failed:\n" + "\n".join(errors))
    return results
