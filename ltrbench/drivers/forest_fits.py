"""Random Forests fits: the window drives whole ``RFRanker.fit`` calls on
the in-memory ``Dataset``, as ``-train`` does once per forest: the fit's
set-up (grid, bins, upload), the bag draws and every group step.

Set-up: the program's ``Dataset`` over the generated arrays, the ranker
at the configuration's parameters, and one whole fit, which builds and
warms every shape the window's fits use (each group of bags has its
own) and shows how the program groups the bags: the set-up fit records
each group step's bags. Fits start until the window's seconds have
passed; the fit in flight finishes and counts.

The judge checks one bag of every group step of every fit, drawn from
the seed, so a fault in any group step shows in every run.
"""

from __future__ import annotations

import numpy as np

from ltrbench.drivers.common import (
    Window, dataset, run_window, to_ref_tree, wrapped,
)


class Driver:
    def __init__(self, cfg: dict, train, vali, device):
        from ranklib_tpu_torch.metrics.base import create_scorer
        from ranklib_tpu_torch.models.base import get_ranker_class
        from ranklib_tpu_torch.utils.logging import set_silent

        set_silent(True)
        self.cfg, self.device = cfg, device
        p = cfg["params"]
        self.work = (float(train.n_docs) * int(p["n_bags"])
                     * int(p["n_trees"]))
        self.ranker = get_ranker_class(cfg["ranker"])(**p)
        self.scorer = create_scorer(cfg["metric"])
        self.ds = dataset(train)
        self.fits = []
        self.groups = []              # bags of each group step, in order
        from ranklib_tpu_torch.models import rf

        with wrapped([(rf, "group_step", "group_step")], self._recording):
            self.call()

    def _recording(self, name, orig):
        def step(scores, *a, **k):
            self.groups.append(int(scores.shape[0]))
            return orig(scores, *a, **k)
        return step

    def call(self) -> None:
        """One whole fit; its bags' ensembles are kept for the judge."""
        self.ranker.fit(self.ds, self.scorer, device=self.device)
        self.fits.append(self.ranker.ensembles)

    def window(self, seconds: float, events: bool = False) -> Window:
        return run_window(self.call, seconds, self.work, events, self.device)

    def traced_calls(self) -> int:
        """The traced span: one more fit."""
        self.call()
        return 1

    def spans(self) -> list:
        from ranklib_tpu_torch.gbdt import grow
        from ranklib_tpu_torch.models import rf

        return [(self, "call", "fit"),
                (rf, "flatten_binned", "prepare"),
                (rf, "pad_binned", "prepare"),
                (rf, "upload_bins", "upload"),
                (rf.RFRanker, "_draw_bag", "bag_draws"),
                (rf, "group_step", "step"),
                (rf, "grow_forest", "grow"),
                (rf, "leaf_outputs_forest", "leaf_outputs"),
                (grow, "histogram_multi", "histogram_multi"),
                (grow, "best_splits", "split_scan")]

    def outputs(self) -> dict:
        """{"fits": per fit, the [Tree] of every bag; "groups": the bags
        of each group step}."""
        return {"fits": [[to_ref_tree(e.trees[0]) for e in fit]
                         for fit in self.fits],
                "groups": list(self.groups)}

    def close(self) -> None:
        self.ranker = None


def sample(groups: list, n_fits: int, seed: int) -> list:
    """(fit, bag) pairs to judge: one bag of each group step (``groups``:
    its bags, in bag order) of every fit, drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    starts = np.cumsum([0] + list(groups))
    return [(f, int(rng.integers(lo, hi))) for f in range(n_fits)
            for lo, hi in zip(starts[:-1], starts[1:])]


def judge(ctx, outputs: dict, cfg: dict, seed: int) -> dict:
    from ltrbench.reference.judge import judge_forest

    if sum(outputs["groups"]) != int(cfg["params"]["n_bags"]):
        raise ValueError(f"group steps of {outputs['groups']} bags, not "
                         f"{cfg['params']['n_bags']}")
    return judge_forest(ctx, outputs["fits"], cfg,
                        sample(outputs["groups"], len(outputs["fits"]),
                               seed))


def control(ctx, cfg: dict, seed: int, dtype) -> dict:
    """The reference in the program's place: the bags that the judge
    samples from one fit, grown in ``dtype``; its bags stand in two
    halves, as two group steps."""
    from ltrbench.reference.fit import forest

    n_bags = int(cfg["params"]["n_bags"])
    groups = [n_bags // 2, n_bags - n_bags // 2]
    bags = forest(ctx, cfg, sorted({b for _, b in sample(groups, 1, seed)}),
                  dtype)
    return {"fits": [[bags.get(b) for b in range(n_bags)]],
            "groups": groups}
