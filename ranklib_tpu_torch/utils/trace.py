"""The port's own spans in a ``torch.profiler`` trace.

``span(name)`` is a ``record_function("ranklib.<name>")`` while a
profiler records (``-profile``, or a benchmark's traced span), so each
phase lands in the same Chrome trace as the card's kernels, on the
profiler's clock; with no profiler it is one shared null context, which
costs a check and no more (a bare ``record_function`` costs ~15 µs a
call even then).

Spans (``ranklib.`` + name), where they open, and what reads them:

* ``prepare`` (``models.gbdt`` ``prepare_fit``), with ``prepare.bin``
  (``flatten_binned``), ``prepare.pad``, ``prepare.validation_bins``,
  and, in ``gbdt.boost`` ``make_boost_data``, ``prepare.upload`` (bin
  matrices, labels, masks) and ``prepare.buckets`` (host buckets and
  their upload, chunk scales, the inverse layout, the fused round's
  data): read in a ``-profile`` trace.
* ``step``: one a LambdaMART/MART round (``gbdt.boost``
  ``make_round_step``) and one a Random Forests group step
  (``models.rf`` ``group_step``); launch calls under it over their
  number are the benchmark's ``step.launches``.
* ``round.lambdas``, ``round.grow``, ``round.leaf_outputs``,
  ``round.score_update``, ``round.train_metric``, ``round.validate``
  (the validation traversal, its score update and metric) and
  ``round.record``, inside a round's ``step``: launch calls under
  ``round.validate`` a round are ``validate.launches``.
* ``grow.root`` and one ``grow.split`` a leaf split (``gbdt.grow``
  ``grow_tree`` and ``grow_forest``): where growth leaves the card idle.
* ``host_read``: around every device-to-host read of the tree fits
  (``models.gbdt`` round loop and ``_export``, ``models.rf`` tree
  read-back, ``gbdt.boost`` ``run_silent_rounds``); their number a call
  is ``call.host_reads``.
* ``fit.setup`` (``models.rf``: everything before the first group step),
  with ``fit.bin``, ``fit.pad``, ``fit.transpose``, ``fit.upload``,
  ``fit.bag_draws`` and ``fit.doc_map``: its seconds a fit are
  ``fit.setup_s``.
* ``rf.group``, one a group of bags (``-rtype 0``) or a bag (``-rtype
  6``), with ``rf.doc_w`` (the group's doc weights, feature masks and
  scores) and ``rf.export`` (the trees read back and exported).
* ``all_reduce`` (``gbdt.grow`` ``sum_across`` under ``-dp``): the
  collectives in each rank's ``-profile`` trace.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "ranklib."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler span ``ranklib.<name>`` while a profiler records, else
    a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
