"""Host-side data model and padded query buckets (copy of the dense parts
of ranklib_tpu.data.dataset).

* :class:`Query` — one ranked list: labels[n], feats[n, F];
* :class:`Dataset` — file-ordered list of queries;
* :class:`QueryBucket` — queries padded to a common doc count D and
  stacked as ``labels[B, D]``, ``mask[B, D]`` (metrics run on these).

Numpy only; tensors start at the device boundary (metrics, forest eval).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ranklib_tpu_torch.utils.errors import RankLibError

# Padded-size ladder (the reference's, so buckets group queries alike).
BUCKET_EDGES = (8, 16, 24, 32, 40, 48, 64, 80, 96, 112, 128, 160, 192,
                224, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280,
                1536, 2048)


@dataclass
class Query:
    """One ranked list (the reference's RankList)."""

    qid: str
    labels: np.ndarray          # [n] float32 graded relevance
    feats: np.ndarray           # [n, F] float32, column j = fid j+1
    descs: list = field(default_factory=list)  # per-doc '# ...' descriptions

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])


@dataclass
class Dataset:
    queries: list               # list[Query], file order
    n_features: int             # max fid seen (1-indexed width)

    @property
    def n_docs(self) -> int:
        return sum(q.n for q in self.queries)

    def subset_features(self, fids) -> "Dataset":
        """Restrict to a feature subset, keeping column positions (unlisted
        features read as 0 — the model still addresses original fids)."""
        keep = feature_mask_from_fids(fids, self.n_features)
        out = []
        for q in self.queries:
            feats = np.where(keep[None, :], q.feats, 0.0).astype(np.float32)
            out.append(Query(q.qid, q.labels.copy(), feats, list(q.descs)))
        return Dataset(out, self.n_features)

    def with_width(self, n_features: int) -> "Dataset":
        """Pad or clip every query's features to exactly ``n_features``
        columns: aligns validation/test files to the training width. The
        reference parses all files into one global fid space, where fids
        the model never references are unused, so clipping is
        behaviourally identical and padding is missing-fid-reads-as-0."""
        if n_features == self.n_features:
            return self
        out = []
        for q in self.queries:
            feats = q.feats[:, :n_features]
            if feats.shape[1] < n_features:
                feats = np.pad(feats,
                               ((0, 0), (0, n_features - feats.shape[1])))
            out.append(Query(q.qid, q.labels, np.ascontiguousarray(feats),
                             q.descs))
        return Dataset(out, n_features)


def feature_mask_from_fids(fids, n_features: int) -> np.ndarray:
    """[F] bool mask from 1-indexed fids (a ``-feature`` file)."""
    mask = np.zeros(n_features, dtype=bool)
    for fid in fids:
        if fid < 1 or fid > n_features:
            raise RankLibError(
                f"Feature id {fid} out of range 1..{n_features}")
        mask[fid - 1] = True
    return mask


def read_feature_file(path: str):
    """Feature-subset file: one fid per line, '#' comments
    (ref: FeatureManager.readFeature, features/FeatureManager.java:~350)."""
    fids = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                fids.append(int(line))
    return fids


@dataclass
class QueryBucket:
    """Labels and masks of queries padded to the same doc count."""

    labels: np.ndarray      # [B, D] float32 (padding = 0)
    mask: np.ndarray        # [B, D] bool (True = real doc)
    qidx: np.ndarray        # [B] int32 — index of the query in Dataset.queries

    @property
    def B(self) -> int:
        return int(self.labels.shape[0])

    @property
    def D(self) -> int:
        return int(self.labels.shape[1])


def padded_size(n: int) -> int:
    for e in BUCKET_EDGES:
        if n <= e:
            return e
    return ((n + 511) // 512) * 512


def bucketize(ds: Dataset) -> list:
    """Eager list of :func:`iter_buckets`."""
    return list(iter_buckets(ds))


def iter_buckets(ds: Dataset):
    """Group queries into :class:`QueryBucket`\\ s by padded doc count;
    query order inside a bucket follows file order (macro-averaged
    metrics are order-independent). The reference's buckets can also
    carry features; the port's metrics need only labels."""
    groups = {}
    for qi, q in enumerate(ds.queries):
        groups.setdefault(padded_size(q.n), []).append(qi)
    for D in sorted(groups):
        idxs = groups[D]
        B = len(idxs)
        labels = np.zeros((B, D), dtype=np.float32)
        mask = np.zeros((B, D), dtype=bool)
        for b, qi in enumerate(idxs):
            q = ds.queries[qi]
            labels[b, : q.n] = q.labels
            mask[b, : q.n] = True
        yield QueryBucket(labels=labels, mask=mask,
                          qidx=np.asarray(idxs, dtype=np.int32))


def flatten_meta(ds: Dataset):
    """labels[N] f32 + qptr[Q+1] — :func:`flatten` without the features."""
    N = ds.n_docs
    labels = np.empty((N,), dtype=np.float32)
    qptr = np.zeros((len(ds.queries) + 1,), dtype=np.int64)
    pos = 0
    for i, q in enumerate(ds.queries):
        labels[pos: pos + q.n] = q.labels
        pos += q.n
        qptr[i + 1] = pos
    return labels, qptr


def flatten(ds: Dataset):
    """Flat doc-major arrays: feats[N, F], labels[N], qptr[Q+1]
    (ref: LambdaMART.init flattens all docs, learning/tree/LambdaMART.java:~40)."""
    N = ds.n_docs
    feats = np.empty((N, ds.n_features), dtype=np.float32)
    labels, qptr = flatten_meta(ds)
    for i, q in enumerate(ds.queries):
        feats[qptr[i]: qptr[i + 1]] = q.feats
    return feats, labels, qptr
