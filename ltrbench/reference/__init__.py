"""The plain reference: LambdaMART and Random Forests (MART residuals)
in plain torch and numpy, written from RankLib's documented rules.

It imports nothing of the program and reads only the generated arrays
(``ltrbench.gen``) and the program's outputs, which it judges:

* :mod:`.grid` — the ``-tc`` candidate split values and the bins;
* :mod:`.lambdas` — NDCG@k lambda gradients on the sorted ranking;
* :mod:`.tree` — routing, node histograms, split gains, best-first
  growth, leaf outputs;
* :mod:`.sampling` — a frozen copy of the bag draws' rule;
* :mod:`.metric` — NDCG@k of scored lists;
* :mod:`.fit` — the reference fits (the control runs them in a lower
  precision in the program's place);
* :mod:`.judge` — the numbers that decide ``correct``.
"""
