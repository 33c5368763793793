"""The data-parallel mesh of ``-dp`` (ranklib_tpu.parallel.dist).

The reference shards queries over a 1-D ``jax.sharding.Mesh`` and sums
every histogram and node statistic with ``lax.psum`` inside
``shard_map``. Here a mesh is a ``torch.distributed`` process group, one
process a shard. Either this package spawns the processes (below), or
the caller started them and each one joins the group (:func:`join`, the
counterpart of ``jax.distributed.initialize()``, after which the
reference's ``make_mesh`` spans every process):

* :func:`make_mesh` takes the first ``min(n, device_count())`` cards under
  NCCL, one card a rank, or ``n`` CPU ranks under gloo when the caller
  asks for the CPU (the reference's virtual host devices). Like the
  reference it silently truncates to the cards there are, so ``-dp n`` on
  one card is a one-device mesh and the fit takes the single-device path.
  A :class:`Mesh` built by hand may put several gloo ranks on one card
  (gloo reduces CUDA tensors; NCCL refuses two ranks on one card).
* :func:`run` spawns the ranks (``spawn``: CUDA cannot be forked) from
  this module alone — the caller's main module is not re-imported in them,
  so a script without a ``__main__`` guard, a test runner's worker or an
  interactive session can fit under ``-dp`` — meets
  them through a ``file://`` rendezvous in a fresh temporary directory (no
  TCP port to collide between concurrent runs), calls ``fn(rank, device,
  group, *args)`` in each and returns their results in rank order. The
  caller puts large host arrays in shared memory (``share_memory_()``)
  before the call, so the ranks map them instead of copying them.
* Rank 0 alone prints: its console lines travel to the parent, which
  prints them through :func:`~ranklib_tpu_torch.utils.logging.log` as
  they come, and it alone writes the event log. Every other rank's
  console output is dropped.
* A rank that raises fails the run with that rank's traceback
  (:class:`RankLibError`); the others are terminated. Collectives time
  out after ``TIMEOUT_S`` seconds, so a hung peer cannot hang the run.
* ``profile_dir`` (``-profile``): every rank runs ``fn`` inside the
  profiler and writes its own trace there.

Joined processes (a launcher such as ``torchrun``, one process a card, on
one host or several; or processes the caller started with an explicit
rendezvous):

* :func:`join` puts this process into the group: NCCL on
  ``cuda:LOCAL_RANK``, gloo on the CPU, or gloo on a card when asked
  (several processes on one card).
* :func:`make_mesh` then returns the world's processes as a joined
  :class:`Mesh`, and :func:`run` spawns nothing: it calls ``fn`` in this
  process and gathers every process's result, so each holds every rank's
  model and the callers check them as they check spawned ranks. Each
  process has read the whole file itself and deals itself its shard, as
  each JAX process holds the whole host array the reference's ``_place``
  slices; nothing travels in shared memory.
* Every process prints its own console lines and returns the model;
  rank 0 alone writes the event log. Every process must run the same
  flow with the same arguments: whether a process calls a collective
  depends on the data and the flags, never on its rank or its shard.
* A process whose ``fn`` raises, or whose gathering of the results
  fails, leaves the group (``destroy_process_group``: its connections
  close) and raises :class:`RankLibError`; its peers fail at their next
  collective, the one they wait in included, and leave it in turn. Under
  gloo that is at once. NCCL does not see a peer go, so there a peer
  waiting in a collective fails after ``TIMEOUT_S`` seconds, unless its
  launcher (``torchrun``) ends it first.
"""

from __future__ import annotations

import contextlib
import io
import os
import queue
import shutil
import sys
import tempfile
import traceback
import types
from dataclasses import dataclass
from datetime import timedelta

import torch

from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils import logging as L

# seconds a collective waits for its peers
TIMEOUT_S = 300


@dataclass(frozen=True)
class Mesh:
    """The ranks of a data-parallel fit: rank r runs on ``devices[r]``
    under ``backend``. ``joined``: the ranks are the processes of the
    group this process joined (:func:`join`), and each knows only its own
    device, which every entry of ``devices`` holds."""

    devices: tuple
    backend: str                  # "nccl" or "gloo"
    joined: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int, device: torch.device) -> Mesh:
    """In a joined process, the world's processes (``n_devices`` above the
    world size is cut to it, as the reference cuts to ``jax.devices()``;
    below it raises, since every process holds a shard). Otherwise the
    first ``n_devices`` cards (as many as there are) under NCCL when
    ``device`` is a card, else ``n_devices`` CPU ranks under gloo."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        if n_devices < world:
            raise RankLibError(
                f"-dp {n_devices} in a group of {world} joined processes: "
                f"every process holds a shard, so -dp takes all {world}")
        backend = torch.distributed.get_backend()
        if backend == "nccl" and device.type != "cuda":
            raise RankLibError(f"a joined NCCL group cannot fit on {device}")
        return Mesh((device,) * world, backend, joined=True)
    if device.type == "cuda":
        n = max(1, min(n_devices, torch.cuda.device_count()))
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), "nccl")
    return Mesh((torch.device("cpu"),) * max(1, n_devices), "gloo")


_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def join(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, backend: str | None = None,
         device: torch.device | str | None = None):
    """Join this process to the ``-dp`` group of processes the caller
    started; returns ``(rank, world_size, device)``.

    ``init_method``, ``world_size`` and ``rank`` (all three, as
    ``jax.distributed.initialize(coordinator_address, num_processes,
    process_id)`` takes them), or none of them: then what a launcher such
    as ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK``).

    The device: ``device``, else ``RANKLIB_TPU_TORCH_DEVICE`` (``cuda``
    without an index is ``cuda:LOCAL_RANK``), else ``cuda:LOCAL_RANK``
    (``LOCAL_RANK`` unset: this rank modulo the cards there are). With no
    card and no explicit CPU it raises, as ``choose_device`` does.
    ``backend``: NCCL on a card, gloo on the CPU; ``"gloo"`` on a card
    lets several processes share one (NCCL refuses two ranks on a card).
    On the CPU the process runs one thread, as a spawned rank does, so a
    joined fit is the spawned fit at the same size."""
    from ranklib_tpu_torch.device import DEVICE_ENV

    given = (init_method, world_size, rank)
    if any(v is None for v in given) and any(v is not None for v in given):
        raise RankLibError("join: give init_method, world_size and rank "
                           "together, or none of them")
    if init_method is None:
        missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise RankLibError(f"join: no init_method and {', '.join(missing)}"
                               f" not set (a launcher such as torchrun sets "
                               f"them)")
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if not 0 <= rank < world_size:
        raise RankLibError(f"join: rank {rank} outside a world of "
                           f"{world_size}")
    name = device or os.environ.get(DEVICE_ENV) or "cuda"
    try:
        device = torch.device(name)
    except RuntimeError as e:
        raise RankLibError(f"join: device {name!r}: {e}") from None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RankLibError(f"join: no CUDA device is available; set "
                               f"{DEVICE_ENV}=cpu to join on the CPU")
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local) if local is not None
                                  else rank % torch.cuda.device_count())
        if device.index >= torch.cuda.device_count():
            raise RankLibError(f"join: no CUDA device {device.index} "
                               f"({torch.cuda.device_count()} available)")
    elif device.type != "cpu":
        raise RankLibError(f"join: only cpu and cuda devices are supported "
                           f"(got {device})")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise RankLibError(f"join: backend {backend!r} is not nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise RankLibError("join: NCCL needs a card; the CPU joins with gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    torch.distributed.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=TIMEOUT_S))
    return rank, world_size, device


class _Lines(io.TextIOBase):
    """Rank 0's stdout: whole lines to the parent's queue."""

    def __init__(self, q):
        self._q = q
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        *lines, self._buf = self._buf.split("\n")
        for ln in lines:
            self._q.put(("line", ln))
        return len(s)


def _rank_main(rank: int, mesh: Mesh, init_file: str, fn, args, q,
               silent: bool, event_log: str | None,
               profile_dir: str | None) -> None:
    device = mesh.devices[rank]
    if device.type == "cpu":
        # the ranks share the host's cores with each other (and with
        # other processes): one thread each
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    L.set_silent(silent)
    if rank == 0:
        sys.stdout = _Lines(q)
        L.set_event_log(event_log)
    else:
        sys.stdout = open(os.devnull, "w")
    torch.distributed.init_process_group(
        mesh.backend, init_method=f"file://{init_file}",
        world_size=mesh.size, rank=rank,
        timeout=timedelta(seconds=TIMEOUT_S))
    try:
        group = torch.distributed.group.WORLD
        if profile_dir:
            from ranklib_tpu_torch.models.trainer import profiled

            with profiled(profile_dir, device, f"rank{rank}"):
                out = fn(rank, device, group, *args)
        else:
            out = fn(rank, device, group, *args)
        q.put(("result", rank, out))
    except Exception:
        # first come, first reported: a peer's failure in a collective
        # with this rank follows this rank's own error
        q.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        torch.distributed.destroy_process_group()
        L.set_event_log(None)


def _run_joined(mesh: Mesh, fn, args, profile_dir: str | None) -> list:
    """:func:`run` on a joined mesh: ``fn`` in this process, then every
    process's result, gathered (rank 0 alone keeps the event log open)."""
    dist = torch.distributed
    rank = dist.get_rank()
    device = mesh.devices[rank]
    log_path = L.event_log_path()
    if rank != 0 and log_path:
        L.set_event_log(None)
    try:
        if profile_dir:
            from ranklib_tpu_torch.models.trainer import profiled

            traced = profiled(profile_dir, device, f"rank{rank}")
        else:
            traced = contextlib.nullcontext()
        try:
            with traced:
                out = fn(rank, device, dist.group.WORLD, *args)
        except Exception:
            tb = traceback.format_exc()
            leave()
            raise RankLibError(
                f"rank {rank} of the {mesh.size}-process -dp mesh failed:\n"
                f"{tb}") from None
        results = [None] * mesh.size
        try:
            dist.all_gather_object(results, out)
        except RuntimeError as e:
            leave()
            raise RankLibError(f"rank {rank} of the {mesh.size}-process -dp "
                               f"mesh could not gather the results: {e}"
                               ) from None
    finally:
        if rank != 0 and log_path:
            L.set_event_log(log_path)
    return results


def leave() -> None:
    """Leave the joined group, if this process is in one: its connections
    close, so a peer still waiting for this process fails now (under
    gloo), not at ``TIMEOUT_S``."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def run(mesh: Mesh, fn, *args, profile_dir: str | None = None) -> list:
    """``fn(rank, device, group, *args)`` in one spawned process a rank
    (inside the profiler when ``profile_dir`` is set); returns the ranks'
    results in rank order. ``fn`` and ``args`` must pickle: a
    module-level function, host arrays (shared-memory tensors for the
    large ones). On a joined mesh, ``fn`` runs in this process, on this
    process's rank, and the results are gathered from every process."""
    if mesh.joined:
        return _run_joined(mesh, fn, args, profile_dir)
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="ranklib_dp_")
    q = mp.get_context("spawn").Queue()
    results, errors = {}, []

    def drain(block: bool) -> None:
        while True:
            try:
                msg = q.get(timeout=0.05) if block else q.get_nowait()
            except queue.Empty:
                return
            block = False
            if msg[0] == "line":
                L.log(msg[1])
            elif msg[0] == "error":
                errors.append(msg[1:])
            else:
                results[msg[1]] = msg[2]

    main = sys.modules["__main__"]
    try:
        sys.stdout.flush()
        # a __main__ with neither __spec__ nor __file__: spawn then starts
        # the ranks without re-running the caller's main module
        sys.modules["__main__"] = types.ModuleType("__main__")
        try:
            ctx = mp.start_processes(
                _rank_main, args=(mesh, os.path.join(tmp, "rendezvous"), fn,
                                  args, q, L.is_silent(),
                                  L.event_log_path(), profile_dir),
                nprocs=mesh.size, join=False, start_method="spawn")
        finally:
            sys.modules["__main__"] = main
        try:
            while not ctx.join(timeout=0):
                drain(block=True)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            drain(block=False)
            rank, tb = errors[0] if errors else (e.error_index, str(e))
            raise RankLibError(f"rank {rank} of the {mesh.size}-rank -dp "
                               f"mesh failed:\n{tb}") from None
        for _ in range(200):                 # what is still in the pipe
            if len(results) == mesh.size:
                break
            drain(block=True)
        else:
            raise RankLibError("a -dp rank exited without its result")
    finally:
        q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(mesh.size)]
