"""Start the ranks of a ``torch.distributed`` world on this host.

    python -m ecog2txt_tpu_torch.parallel.launch   # one rank (internal)

:func:`spawn` starts ``world_size`` processes, one a rank, that each run
``initialize_distributed`` on a free localhost port and then call
``module:function(**kwargs)``; each rank's return value comes back
pickled.  A rank that exits non-zero, or a world that outlasts
``timeout``, stops every rank and raises ``RuntimeError`` with the
failing rank's last output: a lost or hung peer never hangs the caller.
The ranks' device and backend are the caller's choice
(``initialize_distributed``'s rule when ``backend`` is None); on a host
with one card every rank may share it (gloo).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world_size: int, kwargs: dict | None = None, timeout: float = 600.0,
          backend: str | None = None, device: str = "cpu", pythonpath=(),
          env: dict | None = None) -> list:
    """Run ``target`` (``"module:function"``) on ``world_size`` ranks;
    returns the ranks' return values in rank order.  ``pythonpath``:
    directories to put on the ranks' ``sys.path`` (where ``module`` lives);
    ``device`` is passed to the backend choice; ``env`` adds variables."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "kwargs.pkl"), "wb") as f:
            pickle.dump(kwargs or {}, f)
        base = dict(os.environ, **(env or {}))
        base["PYTHONPATH"] = os.pathsep.join(
            [*map(str, pythonpath), *[p for p in sys.path if p and os.path.isdir(p)]]
        )
        procs, logs = [], []
        for rank in range(world_size):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(world_size),
                            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            cmd = [sys.executable, "-m", "ecog2txt_tpu_torch.parallel.launch", target, tmp,
                   backend or "", device, str(timeout)]
            procs.append(subprocess.Popen(cmd, env=rank_env, stdout=log,
                                          stderr=subprocess.STDOUT))
            logs.append(log)
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            else:
                failed = next((r for r, p in enumerate(procs) if p.returncode), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed is not None or any(p.returncode for p in procs):
            rank = failed if failed is not None else 0
            logs[rank].seek(0)
            tail = logs[rank].read()[-4000:]
            why = "timed out" if failed is None else f"exited with {procs[rank].returncode}"
            raise RuntimeError(f"{target}: rank {rank} of {world_size} {why}:\n{tail}")
        results = []
        for rank, log in enumerate(logs):
            log.seek(0)
            sys.stdout.write(log.read())
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
            log.close()
        return results


def _rank_main(target: str, tmp: str, backend: str, device: str, timeout: str) -> None:
    import importlib

    import torch.distributed as dist

    from .multihost import initialize_distributed

    initialize_distributed(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
        backend or None, float(timeout), device,
    )
    module, _, name = target.partition(":")
    with open(os.path.join(tmp, "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(**kwargs)
    with open(os.path.join(tmp, f"result{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:6])
