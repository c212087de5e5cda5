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

``start_ranks(n, ...)`` starts a group that stays up, for a service that
keeps state on its ranks between calls (``parallel.gallery.ShardedGallery``).
Rank 0 is the calling process, on ``cuda:0`` (or the CPU); ranks 1..n-1 are
spawned once, bound as above, and loop on rank 0's calls until
``RankGroup.close()``. ``RankGroup.call(fn, *args, data=...)`` runs
``fn(ctx, data, *args)`` on every rank: ``ctx`` is the rank's
``RankContext`` (its mesh, and a dict it keeps between calls); ``data`` is
rank 0's own (never pickled; None on the other ranks), and whatever the
ranks exchange goes over the group's collectives. Only ``fn`` and ``args``,
pickled, travel to the followers, over a pipe each. The group's
collectives time out after ``timeout`` seconds; a follower that fails or
dies makes the call raise ``RankError`` (before the call when it is found
dead, at once when its pipe closes mid-call, else at the collectives'
time limit), and the group is closed for further calls. A group of one
rank spawns nothing and starts no process group: a call is ``fn`` on the
caller's one-device mesh.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
import weakref
from dataclasses import dataclass, field
from datetime import timedelta
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .mesh import Mesh, create_mesh


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


# --- a group that stays up ----------------------------------------------------

@dataclass
class RankContext:
    """What ``RankGroup.call``'s function gets on each rank: the group's
    mesh (this rank's device and position), and ``state``, a dict the rank
    keeps between calls."""
    mesh: Mesh
    state: dict = field(default_factory=dict)


def _follower_main(rank, n, device, backend, store, timeout, conn):
    """One follower of a ``RankGroup``: join the group, then run each call
    rank 0 sends until it sends None or its pipe closes."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        conn.send_bytes(pickle.dumps((True, "up")))
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout))
        ctx = RankContext(create_mesh(n, device=device))
        conn.send_bytes(pickle.dumps((True, "ready")))
        while True:
            try:
                msg = conn.recv_bytes()
            except EOFError:            # rank 0 is gone
                break
            cmd = pickle.loads(msg)
            if cmd is None:
                break
            fn, args = cmd
            fn(ctx, None, *args)
            if device == "cuda":
                torch.cuda.synchronize()
            conn.send_bytes(pickle.dumps((True, None)))
        dist.destroy_process_group()
    except BaseException:               # reported, then this rank exits 1
        try:
            conn.send_bytes(pickle.dumps((False, traceback.format_exc())))
        except OSError:
            pass
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    conn.close()


def _shutdown(procs, conns, tmp) -> None:
    """Stop what a group left running (the group's finaliser)."""
    _stop(procs)
    for c in conns:
        c.close()
    tmp.cleanup()


class RankGroup:
    """A process group of ``n`` ranks that stays up: rank 0 is this
    process, ranks 1..n-1 are followers (see the module note). Use
    ``start_ranks`` to make one; ``close()`` ends it."""

    def __init__(self, n: int, device: str, backend: str, timeout: float):
        self.n, self.device, self.timeout = n, device, timeout
        self._procs, self._conns = [], []
        self._broken: str | None = None
        self._tmp = tempfile.TemporaryDirectory(prefix="mbfp_group_")
        self._finalizer = weakref.finalize(self, _shutdown, self._procs,
                                           self._conns, self._tmp)
        if n == 1:
            self.ctx = RankContext(create_mesh(device=device))
            return
        if dist.is_available() and dist.is_initialized():
            raise ValueError("start_ranks: this process is already in a "
                             "process group")
        store = os.path.join(self._tmp.name, "store")
        mpc = mp.get_context("spawn")
        try:
            for rank in range(1, n):
                mine, theirs = mpc.Pipe(duplex=True)
                self._conns.append(mine)
                proc = mpc.Process(target=_follower_main, daemon=True, args=(
                    rank, n, device, backend, store, timeout, theirs))
                proc.start()
                self._procs.append(proc)
                theirs.close()
            deadline = time.monotonic() + timeout
            self._replies(deadline, "up")
            if device == "cuda":
                torch.cuda.set_device(0)
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    rank=0, world_size=n,
                                    timeout=timedelta(seconds=timeout))
            self.ctx = RankContext(create_mesh(n, device=device))
            self._replies(deadline, "ready")
        except BaseException:
            self._broken = "did not start"
            self.close()
            raise

    @property
    def pids(self) -> list:
        """The followers' process ids, rank order."""
        return [p.pid for p in self._procs]

    def _fail(self, why: str) -> RankError:
        self._broken = why
        return RankError(why)

    def _answer(self, rank: int) -> tuple:
        """Follower ``rank``'s next message: (True, payload), or (False,
        why) where it failed or died."""
        conn, proc = self._conns[rank - 1], self._procs[rank - 1]
        try:
            ok, payload = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            proc.join(5)
            return False, (f"rank {rank} of {self.n} exited with code "
                           f"{proc.exitcode}")
        return ok, payload if ok else f"rank {rank} of {self.n} failed:\n{payload}"

    def _replies(self, deadline: float, what) -> None:
        """Wait for the reply ``what`` from every follower; raise
        ``RankError`` on a failure, a death or the deadline."""
        waiting = dict(enumerate(self._conns, start=1))
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise self._fail(f"ranks {sorted(waiting)} of {self.n} did "
                                 f"not answer within {self.timeout:g} s")
            ready = wait(list(waiting.values()), timeout=left)
            for rank, conn in list(waiting.items()):
                if conn in ready:
                    ok, payload = self._answer(rank)
                    if not ok or payload != what:
                        raise self._fail(payload if not ok else
                                         f"rank {rank} of {self.n} answered "
                                         f"{payload!r}, not {what!r}")
                    del waiting[rank]

    def _follower_failure(self, wait_s: float) -> str | None:
        """A follower's failure or death reported within ``wait_s``
        seconds, else None."""
        ready = wait(self._conns, timeout=wait_s)
        for rank, conn in enumerate(self._conns, start=1):
            if conn in ready:
                ok, why = self._answer(rank)
                if not ok:
                    return why
        return None

    def _check(self) -> None:
        if self._broken:
            raise RankError(f"the rank group is closed ({self._broken})")
        for rank, p in enumerate(self._procs, start=1):
            if not p.is_alive():
                raise self._fail(f"rank {rank} of {self.n} exited with code "
                                 f"{p.exitcode}")

    def call(self, fn, *args, data=None):
        """``fn(ctx, data, *args)`` on every rank (``data`` on rank 0
        only); returns rank 0's result once every rank has finished its
        part. Span ``ranks.dispatch`` around handing the call to the
        followers; counts ``ranks.calls``."""
        self._check()
        if self._procs:
            with span("ranks.dispatch"):
                count("ranks.calls")
                msg = pickle.dumps((fn, args))
                try:
                    for c in self._conns:
                        c.send_bytes(msg)
                except OSError as e:
                    raise self._fail(f"a follower's pipe closed ({e})") from e
        deadline = time.monotonic() + self.timeout
        try:
            out = fn(self.ctx, data, *args)
        except Exception as e:
            if not self._procs:
                raise
            # a follower's failure or death is the cause where there is one
            self._broken = f"rank 0 failed: {type(e).__name__}: {e}"
            why = self._follower_failure(1.0)
            raise RankError(why or f"rank 0 of {self.n} failed: "
                            f"{type(e).__name__}: {e}") from e
        # the followers answer once their part is on the host, so rank 0
        # never waits on its own device for a collective a dead rank holds
        self._replies(deadline, None)
        return out

    def close(self) -> None:
        """End the group: the followers leave their loop and exit, or are
        terminated; rank 0 leaves the process group. Returns within about
        ``timeout`` seconds whatever state the followers are in."""
        if not self._finalizer.alive:
            return
        if self._procs and not self._broken:
            try:
                for c in self._conns:
                    c.send_bytes(pickle.dumps(None))
            except OSError:
                self._broken = "a follower's pipe closed"
            deadline = time.monotonic() + min(self.timeout, 30.0)
            for p in self._procs:
                p.join(max(0.0, deadline - time.monotonic()))
        if dist.is_available() and dist.is_initialized() and self._procs:
            abort = getattr(dist.distributed_c10d, "_abort_process_group",
                            None)
            if self._broken and abort is not None:
                abort()
            else:
                dist.destroy_process_group()
        self._broken = self._broken or "closed"
        self._finalizer()

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, typ, value, tb) -> bool:
        self.close()
        return False


def start_ranks(n: int, device=None, timeout: float = 120.0) -> RankGroup:
    """A ``RankGroup`` of ``n`` ranks on ``device``'s kind (default: the
    cards, rank r on ``cuda:r``, over NCCL; ``"cpu"`` for gloo ranks on the
    CPU). Raises ``RankError`` when a follower fails to start or the group
    is not up within ``timeout`` seconds.
    Until ``close()`` this process is rank 0 of the default process group,
    so ``create_mesh()`` called here is the group's mesh."""
    if n < 1:
        raise ValueError(f"n={n} ranks")
    device = resolve_device(device, "start_ranks").type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    return RankGroup(n, device, _backend(device, None), timeout)
