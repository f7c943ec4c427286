"""Run a function on several local ranks joined by ``initialize_multihost``.

    results = run_ranks("path/to/file.py:fn", 4, args=(...,), timeout=300)

starts ``world_size`` fresh interpreters (``python -m
csgrenderer_tpu_torch.parallel.launch``, never a fork, so a parent that
already holds a CUDA context is safe), joins them into one gloo world on a
free localhost port (on the loopback interface, ``lo``, unless
``GLOO_SOCKET_IFNAME`` names another), calls ``fn(*args)`` in each and
returns each rank's result in rank order (pickled through a scratch
directory; return CPU tensors and plain values). The target is "module:function" or
"file.py:function"; a file is loaded as a module of its own, so its
``if __name__ == "__main__"`` block does not run. The children see this
package through ``PYTHONPATH``.

A rank that fails makes ``run_ranks`` stop the others and raise
RuntimeError with its error output; a world that has not finished within
``timeout`` seconds is stopped and raises TimeoutError. Every collective
times out after the same ``timeout``, so a rank left waiting does not
wait forever.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def run_ranks(target: str, world_size: int, args: tuple = (), timeout: float = 300.0,
              env: dict | None = None) -> list:
    """``target(*args)`` on ``world_size`` ranks; each rank's result, in
    rank order. ``env`` adds to the children's environment."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    work = Path(tempfile.mkdtemp(prefix="csgr_ranks_"))
    try:
        return _run(work, target, world_size, args, timeout, env)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(work, target, world_size, args, timeout, env) -> list:
    with open(work / "args.pkl", "wb") as f:
        pickle.dump(tuple(args), f)
    child_env = dict(os.environ, **(env or {}))
    child_env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # a localhost world: the loopback interface
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), child_env.get("PYTHONPATH", "")) if p)
    port = free_port()
    procs = []
    for rank in range(world_size):
        child_env["LOCAL_RANK"] = str(rank)
        with open(work / f"rank{rank}.out", "w") as out, open(work / f"rank{rank}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, target, str(rank), str(world_size), str(port),
                 str(work), str(timeout)],
                stdout=out, stderr=err, env=child_env, cwd=str(REPO)))
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"rank {r} of {world_size} ({target}) exited with {codes[r]}:\n"
                                   f"{_tail(work / f'rank{r}.out')}\n{_tail(work / f'rank{r}.err')}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                waiting = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"ranks {waiting} of {world_size} ({target}) still running "
                                   f"after {timeout} s:\n{_tail(work / f'rank{waiting[0]}.err')}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    results = []
    for rank in range(world_size):
        with open(work / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _resolve(target: str):
    where, _, name = target.rpartition(":")
    if not where or not name:
        raise ValueError(f"target must be 'module:function' or 'file.py:function', got {target!r}")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(f"_ranks_{Path(where).stem}", where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _child(argv: list[str]) -> int:
    target, rank, world_size, port, work, timeout = argv
    import torch.distributed as dist

    from .mesh import initialize_multihost

    fn = _resolve(target)
    with open(Path(work) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    initialize_multihost(f"127.0.0.1:{port}", int(world_size), int(rank),
                         timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        result = fn(*args)
        dist.barrier()  # no rank tears its groups down while another still uses them
    finally:
        dist.destroy_process_group()
    with open(Path(work) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
