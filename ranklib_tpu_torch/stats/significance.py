"""Significance testing (ranklib_tpu.stats.significance; ref:
stats/RandomPermutationTest.java:~15, stats/BasicStats.java).

Two-sided Fisher randomization test over per-query paired differences:
the observed statistic is the mean difference; under the null each
query's difference carries either sign with equal odds, so the test flips
the signs (10,000 permutations by default) and reports the share of
permuted |mean| ≥ observed |mean|.

On the device: Rademacher signs ``[P, Q]`` from a ``torch.Generator`` on
that device, drawn in chunks of ``(1 << 22) // Q`` rows, and one
``signs @ d`` product a chunk (the reference's is a plain product too,
outside any kernel), in full f32 whatever the process's matmul precision:
under TF32 the differences would round to ~1e-3 relative, far past the
tie slack. The count stays on the device until the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.ops.batched_eval import full_f32_products
from ranklib_tpu_torch.utils.errors import RankLibError


def rademacher_draw(seed: int, device: torch.device):
    """The default sign source: ``draw(p, q)`` returns the next ``[p, q]``
    f32 block of ±1 from one generator on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(p: int, q: int) -> torch.Tensor:
        s = torch.randint(0, 2, (p, q), generator=gen, device=device,
                          dtype=torch.float32)
        return s.mul_(2.0).sub_(1.0)
    return draw


def randomization_test(base: np.ndarray, target: np.ndarray,
                       n_permutations: int = 10_000, seed: int = 0,
                       device: torch.device | None = None,
                       draw=None) -> float:
    """p-value for the paired difference target − base (two-sided).

    ``draw(p, q)``: the sign source, called once a chunk in order
    (default :func:`rademacher_draw` on ``device``); tests pass the
    reference's signs through it. ``device`` defaults to
    :func:`~ranklib_tpu_torch.device.choose_device`'s."""
    base = np.asarray(base, np.float64)
    target = np.asarray(target, np.float64)
    if base.shape != target.shape or base.ndim != 1:
        raise ValueError("randomization_test needs two equal-length vectors")
    if n_permutations <= 0:
        raise RankLibError(f"-np must be positive (got {n_permutations})")
    d = target - base
    q = d.shape[0]
    if q == 0:
        return 1.0
    if device is None:
        from ranklib_tpu_torch.device import choose_device
        device = choose_device(quiet=True)
    if draw is None:
        draw = rademacher_draw(seed, device)
    observed = abs(float(d.mean()))
    # permutations whose |mean| equals the observed one (sign flips of
    # all-zero deltas, the common mostly-tied case) count as ≥; the f32
    # product sums in another order than the f64 mean, so the slack is
    # the f32 error of the statistic, which only errs conservative
    tol = 1e-5 * float(np.abs(d).mean()) + 1e-12
    chunk = max(1, min(n_permutations, (1 << 22) // q))
    dd = torch.from_numpy(d.astype(np.float32)).to(device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    done = 0
    with full_f32_products():
        while done < n_permutations:
            p = min(chunk, n_permutations - done)
            means = (draw(p, q) @ dd).abs() / q
            count += (means >= observed - tol).sum()
            done += p
    return int(count) / n_permutations


def basic_stats(values: np.ndarray) -> dict:
    v = np.asarray(values, np.float64)
    return {"mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
            "n": int(len(v))}
