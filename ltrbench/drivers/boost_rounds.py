"""LambdaMART (MART) rounds: the window drives the round step that
``prepare_fit`` returns, on data prepared in set-up, round after round
as the silent ``_boost_loop`` does.

Set-up: the program's ``Dataset`` over the generated arrays, the ranker
at the configuration's parameters, ``prepare_fit`` (grid, bins, buckets,
upload; timed as ``prep_s``), then the configuration's ``warmup_rounds``
rounds on that same state: the rounds that the reference follows first.
When the state's ``n_trees`` rounds are used up, a new state starts on
the same data. The traced span runs ``trace_rounds`` more rounds.

The judge checks the warm-up rounds, one round of the window drawn from
the seed, and the window's last round.
"""

from __future__ import annotations

import time

import numpy as np

from ltrbench.drivers.common import (
    Window, dataset, run_window, sync, to_ref_tree,
)


class Driver:
    def __init__(self, cfg: dict, train, vali, device):
        from ranklib_tpu_torch.gbdt.boost import init_state
        from ranklib_tpu_torch.metrics.base import create_scorer
        from ranklib_tpu_torch.models.base import get_ranker_class
        from ranklib_tpu_torch.utils.logging import set_silent

        set_silent(True)
        self.cfg, self.device = cfg, device
        self.init_state = init_state
        self.n_docs = train.n_docs
        self.ranker = get_ranker_class(cfg["ranker"])(**cfg["params"])
        self.scorer = create_scorer(cfg["metric"])
        ds = dataset(train)
        vds = dataset(vali) if cfg.get("validation") else None
        t0 = time.perf_counter()
        self.step, self.state, self.data, self.thresholds = \
            self.ranker.prepare_fit(ds, self.scorer, vds, device)
        sync(device)
        self.prep_s = time.perf_counter() - t0
        self.rounds = int(self.ranker.n_trees)
        self.t = 0
        self.first = self.state
        for _ in range(int(cfg["warmup_rounds"])):
            self.call()
        self.warm = (self.t,
                     self.state.scores[:self.n_docs].cpu().numpy().copy())

    def call(self) -> None:
        """One round; a used-up state is replaced by a new one."""
        if self.t == self.rounds:
            s = self.state
            self.state = self.init_state(
                self.rounds, int(self.ranker.n_leaves), s.scores.shape[0] - 1,
                s.vscores.shape[0] - 1, s.impacts.shape[0], self.device)
            self.t = 0
        self.state = self.step(self.state, self.t, self.data)
        self.t += 1

    def window(self, seconds: float, events: bool = False) -> Window:
        return run_window(self.call, seconds, self.n_docs, events,
                          self.device)

    def traced_calls(self) -> int:
        """The traced span: ``trace_rounds`` more rounds."""
        n = int(self.cfg["trace_rounds"])
        for _ in range(n):
            self.call()
        return n

    def spans(self) -> list:
        from ranklib_tpu_torch.gbdt import boost, grow

        return [(self, "step", "step"),
                (boost, "chunk_lambdas", "lambdas"),
                (boost, "lambda_round", "lambdas"),
                (boost, "grow_tree", "grow"),
                (boost, "leaf_outputs", "leaf_outputs"),
                (grow, "histogram", "histogram"),
                (grow, "best_splits", "split_scan")]

    def outputs(self) -> list:
        """Rounds to judge: the warm-up rounds of the first state (with
        their scores after the last of them) and the last round of the
        current state (with the final scores); ``window`` gives the
        current state's window rounds before the last, of which the
        judge draws one more."""
        from ranklib_tpu_torch.models.gbdt import _export

        lr = float(self.ranker.learning_rate)

        def trees(state, keep):
            ens = _export(state, keep, self.thresholds, lr)
            return [to_ref_tree(t) for t in ens.trees]

        warm_t, warm_scores = self.warm
        seqs = []
        if self.first is not self.state:
            seqs.append({"trees": trees(self.first, warm_t),
                         "scores": {warm_t - 1: warm_scores},
                         "val_m": self.first.val_m[:warm_t].cpu().numpy(),
                         "checked": list(range(warm_t))})
            warm_t = 0
        last = self.t - 1
        scores = {last: self.state.scores[:self.n_docs].cpu().numpy()}
        if warm_t:
            scores[warm_t - 1] = warm_scores
        seqs.append({"trees": trees(self.state, self.t), "scores": scores,
                     "val_m": self.state.val_m[:self.t].cpu().numpy(),
                     "checked": sorted(set(range(warm_t)) | {last}),
                     "window": [warm_t, last]})
        return seqs

    def close(self) -> None:
        self.state = self.first = self.data = self.step = None
        self.ranker = None


def judge(ctx, outputs: list, cfg: dict, seed: int) -> dict:
    """The worst reading of every sequence's checked rounds, with one
    round of each ``window`` range drawn from the seed."""
    from ltrbench.reference.judge import judge_boost
    from ltrbench.reference.tree import worst

    rng = np.random.default_rng(int(seed))
    nums = {}
    for seq in outputs:
        lo, hi = seq.get("window", (0, 0))
        if hi > lo:
            seq = {**seq, "checked": sorted(
                set(seq["checked"]) | {int(rng.integers(lo, hi))})}
        for k, v in judge_boost(ctx, seq, cfg).items():
            nums[k] = worst(nums.get(k, 0), v)
    return nums


def control(ctx, cfg: dict, seed: int, dtype) -> list:
    """The reference in the program's place: its own warm-up rounds in
    ``dtype``."""
    from ltrbench.reference.fit import boost

    return [boost(ctx, cfg, int(cfg["warmup_rounds"]), dtype)]
