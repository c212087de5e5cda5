"""Start the ranks of a mesh: the port's counterpart of the JAX package's
single-controller device discovery (``jax.devices()``).

``run_ranks(fn, n, ...)`` runs ``fn(*args)`` once on each of n ranks of a
``torch.distributed`` process group and returns their results in rank
order. It spawns the ranks (``torch.multiprocessing``, the ``spawn`` start
method: a process that has touched CUDA is never forked), each of which

- binds ``cuda:rank`` (modulo the visible cards) before the group starts,
  when it runs on the card;
- initialises the group on a ``FileStore`` in a temporary directory of its
  own, so launches running side by side never share a rendezvous, with
  ``timeout`` on its collectives;
- runs ``fn``, destroys the group and sends its result (tensors moved to
  the host) or its traceback back.

The parent waits at most ``timeout`` seconds in all. When a rank fails,
dies or the time runs out it terminates every rank and raises, with the
failing rank's traceback. Under ``torchrun`` (``RANK`` and ``WORLD_SIZE``
set) this process is one rank: it joins that group (``env://``), runs
``fn`` and returns its own result alone, in a list of one.

``fn`` and ``args`` are pickled: ``fn`` must be a module-level function;
a rank that cannot start (a lambda, an argument that does not pickle)
raises ``RankError`` chained from the pickling error.
The ranks run on the cards unless the caller passes ``device="cpu"``; with
no card, the default raises before any rank starts. The backend follows
the device: NCCL for ``"cuda"``, gloo for ``"cpu"``; ``backend`` overrides
it (gloo with CUDA tensors, several ranks on one
card: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device


class RankError(RuntimeError):
    """A rank failed, died or ran out of time."""


def _to_host(obj):
    """``obj`` with every tensor in it moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _backend(device: str, backend: str | None) -> str:
    return backend or ("nccl" if device == "cuda" else "gloo")


def _rank_main(fn, args, rank, n, device, backend, store, timeout, conn):
    """One spawned rank: set up, run ``fn``, report; see the module note."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout))
        out = _to_host(fn(*args))
        dist.destroy_process_group()
        msg = (True, out)
    except BaseException:               # reported, then this rank exits 1
        msg = (False, traceback.format_exc())
    conn.send_bytes(pickle.dumps(msg))
    conn.close()
    if not msg[0]:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _joined(fn, args, n, device, backend, timeout):
    """Run ``fn`` as this process's rank of the group ``torchrun`` set up."""
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"run_ranks(n={n}) under a launcher of {world} "
                         "ranks")
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group(_backend(device, backend),
                                timeout=timedelta(seconds=timeout))
    return [fn(*args)]


def run_ranks(fn, n: int, *args, backend: str | None = None,
              timeout: float = 120.0, device=None) -> list:
    """``[fn(*args) on rank 0, ..., on rank n-1]``, each rank a process of
    one process group on ``device``'s kind (default: the cards; see the
    module note). Raises ``RankError`` with the rank's traceback when one
    fails, or when ``timeout`` seconds pass."""
    if n < 1:
        raise ValueError(f"n={n} ranks")
    device = resolve_device(device, "run_ranks").type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _joined(fn, args, n, device, backend, timeout)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mbfp_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs, conns = [], []
        deadline = time.monotonic() + timeout
        results: dict[int, object] = {}
        try:
            for rank in range(n):
                recv, send = ctx.Pipe(duplex=False)
                conns.append(recv)
                proc = ctx.Process(target=_rank_main, daemon=True, args=(
                    fn, args, rank, n, device, _backend(device, backend),
                    store, timeout, send))
                try:
                    proc.start()
                except (pickle.PicklingError, AttributeError, TypeError) as e:
                    send.close()
                    raise RankError(
                        f"rank {rank} of {n} did not start: fn and args must "
                        "be picklable, and fn a module-level function "
                        f"({type(e).__name__}: {e})") from e
                procs.append(proc)  # only started ranks are stopped
                send.close()        # a rank that dies leaves EOF behind
            waiting = dict(enumerate(conns))
            while waiting:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankError(
                        f"ranks {sorted(waiting)} of {n} did not finish "
                        f"within {timeout:g} s")
                ready = wait(list(waiting.values()), timeout=left)
                for rank, conn in list(waiting.items()):
                    if conn not in ready:
                        continue
                    try:
                        ok, payload = pickle.loads(conn.recv_bytes())
                    except EOFError:
                        procs[rank].join(5)
                        ok, payload = False, (
                            f"exited with code {procs[rank].exitcode} and "
                            "no result")
                    if not ok:
                        raise RankError(f"rank {rank} of {n} failed:\n"
                                        f"{payload}")
                    results[rank] = payload
                    del waiting[rank]
        finally:
            _stop(procs)
            for c in conns:
                c.close()
    return [results[r] for r in range(n)]
