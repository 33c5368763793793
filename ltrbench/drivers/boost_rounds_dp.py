"""LambdaMART data-parallel over the cards of a multi-card cell, as users
run ``-dp n`` under ``torchrun``: one process a card, every process
reading the whole training set, each fitting its shard of the queries
with the sums taken across the ranks.

Set-up, on every rank: the program's ``Dataset`` over the generated
arrays (every worker generates the whole set from the seed), this
process joined to the program's group (``parallel.dist.join()``,
``make_mesh(dp, device)``) with one intra-op thread, as ``torchrun``
starts several processes a node (``OMP_NUM_THREADS=1``), the grid and
the whole set's bins from ``LambdaMART.rank_args`` and this rank's
shard, round and state from ``LambdaMART.prepare_shard`` (both timed as
``prep_s``), then the configuration's ``warmup_rounds`` rounds. The
window drives that step, the one ``fit_shard`` runs, round after round
as ``boost_rounds`` does on one card (:meth:`boost_rounds.Driver.call`).

The ranks run the same collectives, so they end the window at the same
round, decided together: after each round every rank all-reduces a
one-element "my time is up" flag (outside ``ranklib.step``) and reads
back the flag of the round before, whose copy to the host was queued
before the round just launched: the host never waits on the round in
flight. A flag read set ends the window after that round on every rank.
``Window.work`` counts the whole training set's docs a round, on every
rank.

Each rank's part of what the judge reads travels through the group's
key-value store (no collective) at the end of set-up and once the run's
rounds are over, outside the window and the traced span (rank 0's in
``outputs()``, the other ranks' in ``close()``): its training scores
and a digest of its trees (their model text). Rank 0's ``outputs()``
reads the ranks' parts (no collective: ``run.py`` calls it on rank 0
alone), scatters the scores back to flatten order by the program's
``_shard_queries``, and counts the ranks whose trees differ from its
own: ``rank_mismatch``, the check ``take_ranks`` makes on the
normal path. The judge is ``boost_rounds``' with that number beside.
"""

from __future__ import annotations

import hashlib
import pickle
import time

import numpy as np
import torch

from ltrbench.drivers import boost_rounds
from ltrbench.drivers.common import Window, dataset, sync, to_ref_tree

STORE_PREFIX = "ltrbench.part"


class Driver(boost_rounds.Driver):
    def __init__(self, cfg: dict, train, vali, device):
        from ranklib_tpu_torch.gbdt.boost import init_state
        from ranklib_tpu_torch.metrics.base import create_scorer
        from ranklib_tpu_torch.models.base import get_ranker_class
        from ranklib_tpu_torch.parallel import dist
        from ranklib_tpu_torch.utils.logging import set_silent

        set_silent(True)
        self.cfg = cfg
        # torchrun's environment for several processes a node
        # (OMP_NUM_THREADS=1), which the launcher does not set
        torch.set_num_threads(1)
        self.rank, self.world, self.device = dist.join(device=device)
        self.group = torch.distributed.group.WORLD
        mesh = dist.make_mesh(int(cfg["dp"]), self.device)
        self.init_state = init_state
        self.n_docs = train.n_docs
        self.ranker = get_ranker_class(cfg["ranker"])(**cfg["params"])
        self.scorer = create_scorer(cfg["metric"])
        self.ds = dataset(train)
        vds = dataset(vali) if cfg.get("validation") else None
        t0 = time.perf_counter()
        (worker, tr, binned, self.thresholds, va, vbinned, fmask, scorer,
         init, vinit) = self.ranker.rank_args(self.ds, self.scorer, vds,
                                              self.device, mesh)
        self.step, self.state, self.data = worker.prepare_shard(
            self.rank, self.device, self.group, tr, binned.numpy(),
            self.thresholds, scorer, va,
            None if vbinned is None else vbinned.numpy(), fmask, init,
            vinit)
        sync(self.device)
        self.prep_s = time.perf_counter() - t0
        from ranklib_tpu_torch.gbdt.boost_dist import _shard_queries

        self.shards = _shard_queries(self.ds, self.world)
        # this rank's real docs, the head of its flat doc layout
        self.n_shard = sum(self.ds.queries[q].n
                           for q in self.shards[self.rank])
        self.store = torch.distributed.distributed_c10d._get_default_store()
        cuda = self.device.type == "cuda"
        self.flags = [torch.zeros(1, device=self.device) for _ in range(2)]
        self.hosts = [torch.zeros(1, pin_memory=cuda) for _ in range(2)]
        self.rounds = int(self.ranker.n_trees)
        self.t = 0
        self.first = self.state
        for _ in range(int(cfg["warmup_rounds"])):
            self.call()
        self.warm_t = self.t
        self._send("setup")

    # ---- the window's end, decided together ------------------------------

    def _flag(self, k: int, up: bool):
        """All-reduce this rank's flag ``up`` into buffer ``k`` and queue
        its copy to the host; (host copy, event after it)."""
        f = self.flags[k]
        f.fill_(float(up))
        torch.distributed.all_reduce(f, group=self.group)
        if self.device.type != "cuda":
            return f, None
        self.hosts[k].copy_(f, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return self.hosts[k], ev

    @staticmethod
    def _is_up(pending) -> bool:
        host, ev = pending
        if ev is not None:
            ev.synchronize()
        return float(host[0]) > 0

    def window(self, seconds: float, events: bool = False) -> Window:
        ends = []
        sync(self.device)
        t0 = time.perf_counter()
        n, pending = 0, None
        while True:
            self.call()
            n += 1
            if events:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ends.append(ev)
            cur = self._flag(n % 2, time.perf_counter() - t0 >= seconds)
            if pending is not None and self._is_up(pending):
                break
            pending = cur
        sync(self.device)
        return Window(n, n * self.n_docs, time.perf_counter() - t0, ends)

    def spans(self) -> list:
        from ranklib_tpu_torch.gbdt import boost, grow

        return super().spans() + [(boost, "sum_across", "all_reduce"),
                                  (grow, "sum_across", "all_reduce")]

    # ---- each rank's part ------------------------------------------------

    def _held(self) -> list:
        """(state, rounds) of every tree this rank holds: the warm-up
        state's, when the window moved on to a new one, and the current
        state's."""
        held = [(self.state, self.t)]
        if self.first is not self.state:
            held.insert(0, (self.first, self.rounds))
        return held

    def _trees_text(self) -> str:
        from ranklib_tpu_torch.models.gbdt import _export

        lr = float(self.ranker.learning_rate)
        return "".join(_export(s, t, self.thresholds, lr).to_text()
                       for s, t in self._held())

    def _send(self, phase: str) -> None:
        """This rank's part of ``phase`` into the store: its training
        scores and the digest of its trees."""
        scores = self.state.scores[:self.n_shard].cpu().numpy().copy()
        digest = hashlib.sha256(self._trees_text().encode()).hexdigest()
        self.store.set(f"{STORE_PREFIX}.{phase}.{self.rank}",
                       pickle.dumps((scores, digest)))

    def _parts(self, phase: str) -> list:
        return [pickle.loads(self.store.get(f"{STORE_PREFIX}.{phase}.{r}"))
                for r in range(self.world)]

    def _whole(self, parts: list) -> np.ndarray:
        """The ranks' training scores in flatten order."""
        from ranklib_tpu_torch.data.dataset import flatten_meta

        qptr = flatten_meta(self.ds)[1]
        out = np.full(self.n_docs, np.nan, np.float32)
        for mine, (scores, _) in zip(self.shards, parts):
            rows = (np.concatenate([np.arange(qptr[q], qptr[q + 1])
                                    for q in mine])
                    if mine else np.zeros(0, np.int64))
            out[rows] = scores
        return out

    def outputs(self) -> dict:
        """Rank 0's: :meth:`boost_rounds.Driver.outputs`' rounds with
        every rank's scores, and ``rank_mismatch``."""
        from ranklib_tpu_torch.models.gbdt import _export

        lr = float(self.ranker.learning_rate)
        self._send("end")
        last = self._parts("end")
        warm = self._whole(self._parts("setup"))
        mismatch = sum(d != last[0][1] for _, d in last)

        def trees(state, keep):
            ens = _export(state, keep, self.thresholds, lr)
            return [to_ref_tree(t) for t in ens.trees]

        warm_t = self.warm_t
        seqs = []
        if self.first is not self.state:
            seqs.append({"trees": trees(self.first, warm_t),
                         "scores": {warm_t - 1: warm},
                         "val_m": self.first.val_m[:warm_t].cpu().numpy(),
                         "checked": list(range(warm_t))})
            warm_t = 0
        end = self.t - 1
        scores = {end: self._whole(last)}
        if warm_t:
            scores[warm_t - 1] = warm
        seqs.append({"trees": trees(self.state, self.t), "scores": scores,
                     "val_m": self.state.val_m[:self.t].cpu().numpy(),
                     "checked": sorted(set(range(warm_t)) | {end}),
                     "window": [warm_t, end]})
        return {"seqs": seqs, "rank_mismatch": mismatch}

    def close(self) -> None:
        from ranklib_tpu_torch.parallel.dist import leave

        if self.rank != 0:
            self._send("end")
        super().close()
        self.flags = self.hosts = self.store = None
        leave()


def judge(ctx, outputs: dict, cfg: dict, seed: int) -> dict:
    """``boost_rounds``' judge of rank 0's rounds, and ``rank_mismatch``:
    the ranks whose trees differ from rank 0's."""
    nums = boost_rounds.judge(ctx, outputs["seqs"], cfg, seed)
    nums["rank_mismatch"] = float(outputs["rank_mismatch"])
    return nums


def control(ctx, cfg: dict, seed: int, dtype) -> dict:
    """The reference in the program's place (one fit, so no rank
    differs)."""
    return {"seqs": boost_rounds.control(ctx, cfg, seed, dtype),
            "rank_mismatch": 0}
