"""Data-parallel boosting: each ``-dp`` rank's shard and round
(ranklib_tpu.gbdt.boost_dist).

As in the reference, queries are dealt round-robin to the ranks within
each padded size class (:func:`_shard_queries`), so every rank holds about
the same number of queries of every size. Unlike it, nothing is stacked
along a device axis: each rank builds the ordinary per-fit
:class:`~ranklib_tpu_torch.gbdt.boost.BoostData` of its own queries
(:func:`build_sharded_data`), on its own device, and runs the ordinary
round with its process group, which sums
histograms, node sums, leaf sums and metric sums across the ranks. The
lambda phase needs no communication: every pair is query-local. A rank
dealt no query (more ranks than queries, as the reference allows) builds
a BoostData of pad documents only and adds zeros to every sum.

The reference's ``make_dist_round_step`` and ``init_dist_state`` are the
ordinary ``make_round_step(..., group=group)`` and ``init_state`` here.
Its bin-256 rule (one id type that holds the training AND the validation
ids, so that a validation id of 256 does not wrap to 0 in a uint8 shard,
ref :160-165) holds by construction: the shards keep the ids' host type
and each matrix goes to the card at its own width (``upload_bins``).
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten_meta, padded_size
from ranklib_tpu_torch.gbdt.boost import make_boost_data


def _shard_queries(ds: Dataset, n_dev: int) -> list:
    """Round-robin per size class, smallest class first → each rank's
    query indices (ref ``_shard_queries``, :53)."""
    classes = {}
    for qi, q in enumerate(ds.queries):
        classes.setdefault(padded_size(q.n), []).append(qi)
    per_dev = [[] for _ in range(n_dev)]
    for D in sorted(classes):
        for j, qi in enumerate(classes[D]):
            per_dev[j % n_dev].append(qi)
    return per_dev


def _shard_arrays(ds: Dataset, binned: np.ndarray, n_dev: int, rank: int,
                  qstart: np.ndarray | None = None):
    """Rank ``rank``'s shard (ref ``_shard_arrays``, :71): (a Dataset of
    its queries in shard order, their rows of ``binned`` [n, F]).
    ``qstart``: each query's first row in ``binned`` (default: flatten
    order), so a Random-Forests bag takes its rows straight from the full
    matrix."""
    mine = _shard_queries(ds, n_dev)[rank]
    if qstart is None:
        qstart = flatten_meta(ds)[1][:-1]
    rows = (np.concatenate([np.arange(qstart[qi], qstart[qi]
                                      + ds.queries[qi].n) for qi in mine])
            if mine else np.zeros(0, np.int64))
    sub = Dataset([ds.queries[qi] for qi in mine], ds.n_features)
    return sub, binned[rows]


def scatter_doc_values(ds: Dataset, values: np.ndarray, n_dev: int,
                       rank: int, Npad: int) -> np.ndarray:
    """Per-doc values in ``ds``'s flatten order ([N]) → rank ``rank``'s
    flat doc layout [Npad + 1] f32 (the last slot, the pad accumulator,
    0): the warm start's scores (ref ``scatter_doc_values``, :124)."""
    qptr = flatten_meta(ds)[1]
    out = np.zeros(Npad + 1, np.float32)
    pos = 0
    for qi in _shard_queries(ds, n_dev)[rank]:
        n = ds.queries[qi].n
        out[pos: pos + n] = values[qptr[qi]: qptr[qi] + n]
        pos += n
    return out


def build_sharded_data(train: Dataset, binned: np.ndarray, n_dev: int,
                       rank: int, device: torch.device,
                       validation: Dataset | None = None,
                       vbinned: np.ndarray | None = None,
                       feature_mask=None, scorer=None,
                       qstart: np.ndarray | None = None):
    """Rank ``rank``'s BoostData on ``device`` (ref
    ``build_sharded_data``, :141): (data, Npad, Nvpad). ``binned`` /
    ``vbinned``: [N, F] ids of the real docs in flatten order (or at
    ``qstart``); the shard pads its own doc axis."""
    from ranklib_tpu_torch.models.gbdt import _pad_doc_count

    sub, rows_b = _shard_arrays(train, binned, n_dev, rank, qstart)
    labels, _ = flatten_meta(sub)
    n = len(labels)
    Npad = _pad_doc_count(n)
    binned_pad = np.pad(rows_b, ((0, Npad - n), (0, 0)))
    vsub = vrows_b = None
    if validation is not None:
        vsub, vrows_b = _shard_arrays(validation, vbinned, n_dev, rank)
    return make_boost_data(
        sub, binned_pad, np.pad(labels, (0, Npad - n)), n, vsub, vrows_b,
        device, feature_mask, scorer=scorer)
