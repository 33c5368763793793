"""The port's randomization test and Analyzer (``-ana``) against the
reference's (ranklib_tpu.stats.significance, ranklib_tpu.analyzer).

* With the reference's Rademacher signs injected through the port's draw
  seam (``jax.random`` keys split once a chunk, as the reference draws
  them), p-values are equal, ties and chunking included.
* Under the port's own draws (a seeded ``torch.Generator``) p-values at
  P = 10,000 lie within 4σ of the exact p-value (every sign pattern
  enumerated), σ the Monte-Carlo error sqrt(p(1-p)/P).
* The reference's null, real-shift and identical-input cases, ``read_idv``,
  the printed table (under injected signs, line for line, also through
  ``-ana``), the error for mismatched queries and the skip of stray files.
"""

import contextlib
import io
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu import analyzer as RA
from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.stats.significance import (
    randomization_test as ref_randomization_test,
)
from ranklib_tpu_torch import analyzer as PA
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.stats import significance as S
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")


def reference_draw(seed: int = 0):
    """The reference's sign chunks, in its order."""
    key = jax.random.PRNGKey(seed)

    def draw(p, q):
        nonlocal key
        key, sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.rademacher(
            sub, (p, q), dtype=jnp.float32)))
    return draw


@pytest.fixture
def injected(monkeypatch):
    """Every port randomization test draws the reference's signs."""
    monkeypatch.setattr(S, "rademacher_draw",
                        lambda seed, device: reference_draw(seed))


def _pairs(case, rng):
    if case == "null":
        base = rng.normal(0.5, 0.1, 200)
        return base, base + rng.normal(0, 0.05, 200)
    if case == "shift":
        base = rng.normal(0.5, 0.05, 100)
        return base, base + 0.08 + rng.normal(0, 0.02, 100)
    if case == "ties":                     # mostly tied, a few moves
        base = np.round(rng.uniform(0, 1, 300), 2)
        tgt = base.copy()
        tgt[:7] += 0.25
        return base, tgt
    if case == "chunked":                  # Q large: several chunks
        base = rng.uniform(0, 1, 2500)
        return base, base + rng.normal(0.004, 0.1, 2500)
    base = np.round(rng.uniform(0, 1, 40), 4)   # "small"
    return base, np.round(base + rng.normal(0, 0.05, 40), 4)


@pytest.mark.parametrize("case", ["null", "shift", "ties", "chunked",
                                  "small"])
@pytest.mark.parametrize("seed", [0, 3])
def test_p_values_equal_under_injected_signs(injected, case, seed):
    base, tgt = _pairs(case, np.random.default_rng(seed))
    P = 10_000 if case != "chunked" else 3_000
    want = ref_randomization_test(base, tgt, P, seed=seed)
    got = S.randomization_test(base, tgt, P, seed=seed, device=CPU)
    assert got == want


def _exact_p(d):
    """Share of all 2^Q sign patterns with |mean| ≥ observed (the test's
    own tie tolerance)."""
    signs = np.array(list(itertools.product((-1.0, 1.0), repeat=len(d))))
    means = np.abs(signs @ d) / len(d)
    tol = 1e-5 * np.abs(d).mean() + 1e-12
    return float((means >= abs(d.mean()) - tol).mean())


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_own_draws_within_4_sigma_of_the_exact_p(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.03 * seed, 0.1, 14)
    base = rng.uniform(0.2, 0.6, 14)
    P = 10_000
    p = _exact_p(base + d - base)
    got = S.randomization_test(base, base + d, P, seed=seed, device=CPU)
    sigma = np.sqrt(p * (1 - p) / P)
    assert abs(got - p) <= 4 * sigma + 1e-12, (got, p, sigma)
    # the same generator seed draws the same signs
    assert S.randomization_test(base, base + d, P, seed=seed,
                                device=CPU) == got


def test_reference_cases_under_own_draws():
    rng = np.random.default_rng(0)
    base = rng.normal(0.5, 0.1, size=200)
    assert S.randomization_test(base, base + rng.normal(0, 0.05, 200), 2000,
                                seed=1, device=CPU) > 0.05
    rng = np.random.default_rng(0)
    base = rng.normal(0.5, 0.05, size=100)
    target = base + 0.08 + rng.normal(0, 0.02, size=100)
    assert S.randomization_test(base, target, 2000, seed=1,
                                device=CPU) < 0.01
    v = np.full(50, 0.3)
    assert S.randomization_test(v, v, 500, device=CPU) == pytest.approx(1.0)
    assert S.randomization_test(np.zeros(0), np.zeros(0),
                                device=CPU) == 1.0
    with pytest.raises(RankLibError, match="-np must be positive"):
        S.randomization_test(v, v, 0, device=CPU)
    with pytest.raises(ValueError):
        S.randomization_test(v, v[:3], 10, device=CPU)
    assert S.basic_stats([1.0, 2.0, 4.0]) == {
        "mean": pytest.approx(7 / 3), "std": pytest.approx(np.std(
            [1.0, 2.0, 4.0], ddof=1)), "n": 3}


def test_sign_products_run_in_full_f32():
    """The signed sums run at the "highest" matmul precision whatever the
    caller set (TF32 would round the differences far past the tie slack),
    and the caller's setting comes back."""
    seen = []

    def draw(p, q):
        seen.append(torch.get_float32_matmul_precision())
        return torch.ones(p, q)

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        v = np.linspace(0.1, 0.9, 9)
        assert S.randomization_test(v, v + 0.01, 50, device=CPU,
                                    draw=draw) == 1.0
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def _write_idv(path, qvals, metric="NDCG@10"):
    with open(path, "w") as f:
        for q, v in qvals.items():
            f.write(f"{metric}   {q}   {v:.4f}\n")
        f.write(f"{metric}   all   {np.mean(list(qvals.values())):.4f}\n")


@pytest.fixture
def runs(tmp_path):
    rng = np.random.default_rng(3)
    qids = [str(i) for i in range(1, 61)]
    base = {q: float(rng.uniform(0.2, 0.6)) for q in qids}
    better = {q: min(1.0, base[q] + float(rng.uniform(0.05, 0.3)))
              for q in qids}
    same = {q: base[q] + float(rng.normal(0, 0.01)) for q in qids}
    worse = {q: max(0.0, base[q] - float(rng.uniform(0.0, 0.9)))
             for q in qids}
    d = tmp_path / "runs"
    d.mkdir()
    _write_idv(tmp_path / "base.txt", base)
    _write_idv(d / "better.txt", better)
    _write_idv(d / "same.txt", same)
    _write_idv(d / "worse.txt", worse)
    (d / "notes.txt").write_text("foo bar baz\n")
    return str(d), str(tmp_path / "base.txt")


def _out(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue().splitlines()


def test_read_idv_and_analyze_table_match_reference(injected, runs):
    d, base = runs
    assert PA.read_idv(base) == RA.read_idv(base)
    want, want_lines = _out(RA.analyze, d, base, 2000)
    got, got_lines = _out(PA.analyze, d, base, 2000, CPU)
    assert got_lines == want_lines
    assert "Skipping notes.txt (not a per-query metric file)" in got_lines
    for g, w in zip(got, want, strict=True):
        assert {k: v for k, v in g.items() if k != "d"} == {
            k: v for k, v in w.items() if k != "d"}
        np.testing.assert_array_equal(g["d"], w["d"])
    by_name = {r["name"]: r for r in got}
    assert by_name["better.txt"]["p"] < 0.01
    assert by_name["better.txt"]["win"] == 60
    assert by_name["same.txt"]["p"] > 0.05


def test_cli_ana_prints_the_reference_table(injected, runs, capsys):
    d, base = runs
    assert ref_main(["-ana", "-all", d, "-base", base, "-np", "3000"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_main(["-ana", "-all", d, "-base", base, "-np", "3000"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == "Device: cpu" and got[1:] == want
    assert port_main(["-ana", "-all", d]) == 1
    assert ("Error: -ana requires -all <dir> and -base <file>"
            in capsys.readouterr().out)


def test_analyze_errors_and_skips(tmp_path):
    _write_idv(tmp_path / "base.txt", {"1": 0.5, "2": 0.6})
    d = tmp_path / "runs"
    d.mkdir()
    _write_idv(d / "run.txt", {"1": 0.5})
    with pytest.raises(RankLibError, match="missing 1 queries"):
        PA.analyze(str(d), str(tmp_path / "base.txt"), 100, CPU)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "README.txt").write_text("foo bar baz\n")
    with pytest.raises(RankLibError, match="No run files"):
        PA.analyze(str(empty), str(tmp_path / "base.txt"), 100, CPU)
    bad = tmp_path / "bad.idv"
    bad.write_text("one two\n")
    with pytest.raises(RankLibError, match="No per-query rows"):
        PA.read_idv(str(bad))
    base = tmp_path / "b.idv"
    base.write_text("NDCG@10   q1   0.5\nNDCG@10   all   0.5\n")
    runs_dir = tmp_path / "r2"
    runs_dir.mkdir()
    (runs_dir / "run1.idv").write_text(
        "NDCG@10   q1   0.7\nNDCG@10   all   0.7\n")
    (runs_dir / "README.txt").write_text("foo bar baz\n")
    res = PA.analyze(str(runs_dir), str(base), 100, CPU)
    assert [r["name"] for r in res] == ["run1.idv"]
