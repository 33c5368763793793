"""The data-parallel mesh of the tree rankers' ``-dp`` (ranklib_tpu.parallel.dist).

The reference shards queries over a 1-D ``jax.sharding.Mesh`` and sums
every histogram and node statistic with ``lax.psum`` inside
``shard_map``. Here a mesh is a ``torch.distributed`` process group, one
process a shard:

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
"""

from __future__ import annotations

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
    under ``backend``."""

    devices: tuple
    backend: str                  # "nccl" or "gloo"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int, device: torch.device) -> Mesh:
    """The first ``n_devices`` cards (as many as there are) under NCCL
    when ``device`` is a card, else ``n_devices`` CPU ranks under gloo."""
    if device.type == "cuda":
        n = max(1, min(n_devices, torch.cuda.device_count()))
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), "nccl")
    return Mesh((torch.device("cpu"),) * max(1, n_devices), "gloo")


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


def run(mesh: Mesh, fn, *args, profile_dir: str | None = None) -> list:
    """``fn(rank, device, group, *args)`` in one spawned process a rank
    (inside the profiler when ``profile_dir`` is set); returns the ranks'
    results in rank order. ``fn`` and ``args`` must pickle: a
    module-level function, host arrays (shared-memory tensors for the
    large ones)."""
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
