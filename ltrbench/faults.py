"""Faults planted in the program, for the checks that the comparison
deciding ``correct`` catches them (``ltrbench/tests``, and
``ltrbench.calibrate`` on the card at a cell's own size). Each is a
context manager that patches the program's calls, by the names the
program looks them up under, and restores them after:

* ``unchanged``: the step returns its state unchanged (a round records
  no tree; a group step grows nothing);
* ``half``: half of the documents left out, every sum and mean taken
  over the rest;
* ``altered``: one answer altered where it is produced (the largest leaf
  output of each tree, by 1%);
* ``nan``: one answer that is not a number (the largest leaf output of
  each tree set to NaN).

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered", "nan")


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _every_other(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) % 2 == 0


def _bump_largest(out: torch.Tensor) -> torch.Tensor:
    """``out`` [..., M] with each row's largest |value| 1% larger."""
    out = out.clone()
    i = out.abs().argmax(dim=-1, keepdim=True)
    out.scatter_(-1, i, out.gather(-1, i) * 1.01)
    return out


def _nan_largest(out: torch.Tensor) -> torch.Tensor:
    """``out`` [..., M] with each row's largest |value| set to NaN."""
    out = out.clone()
    i = out.abs().argmax(dim=-1, keepdim=True)
    out.scatter_(-1, i, torch.nan)
    return out


_ANSWERS = {"altered": _bump_largest, "nan": _nan_largest}


def boost_fault(name: str):
    """A fault of the LambdaMART round (``drivers/boost_rounds.py``)."""
    from ranklib_tpu_torch.gbdt import boost
    from ranklib_tpu_torch.models import gbdt

    if name == "unchanged":
        return _patched(gbdt, "make_round_step",
                        lambda orig: lambda *a, **k: (
                            lambda state, t, data: state))
    if name == "half":
        def make(orig):
            def made(*a, **k):
                data, npad, nvpad = orig(*a, **k)
                m = data.doc_mask
                data.doc_mask = m & _every_other(m.shape[0], m.device)
                return data, npad, nvpad
            return made
        return _patched(gbdt, "make_boost_data", make)
    if name in _ANSWERS:
        return _patched(boost, "leaf_outputs",
                        lambda orig: lambda *a, **k: _ANSWERS[name](
                            orig(*a, **k)))
    raise ValueError(name)


def forest_fault(name: str):
    """A fault of the Random Forests group step
    (``drivers/forest_fits.py``)."""
    from ranklib_tpu_torch.models import rf

    if name == "unchanged":
        def make(orig):
            def step(scores, doc_w, fmask, binned_T, labels, n_bins,
                     n_leaves, lr):
                Cb, M = scores.shape[0], 2 * n_leaves - 1
                i32 = dict(dtype=torch.int32, device=scores.device)
                none = torch.full((Cb, M), -1, **i32)
                leaf = torch.zeros((Cb, M), dtype=torch.bool,
                                   device=scores.device)
                leaf[:, 0] = True
                return scores, (none, none, none, none, leaf,
                                torch.ones(Cb, **i32),
                                torch.zeros((Cb, M), dtype=torch.float32,
                                            device=scores.device))
            return step
        return _patched(rf, "group_step", make)
    if name == "half":
        def make(orig):
            def step(scores, doc_w, *rest):
                keep = _every_other(doc_w.shape[1], doc_w.device)
                return orig(scores, doc_w * keep, *rest)
            return step
        return _patched(rf, "group_step", make)
    if name in _ANSWERS:
        return _patched(rf, "leaf_outputs_forest",
                        lambda orig: lambda *a, **k: _ANSWERS[name](
                            orig(*a, **k)))
    raise ValueError(name)


def fault(driver: str, name: str):
    """The fault ``name`` of the driver ``driver``'s timed path."""
    return {"boost_rounds": boost_fault,
            "forest_fits": forest_fault}[driver](name)
