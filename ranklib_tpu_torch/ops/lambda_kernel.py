"""Fused lambda-gradient pair sums (ranklib_tpu.ops.lambda_kernel).

:func:`lambda_round` replaces ``ranklib_tpu/ops/lambda_kernel.py``
``_kernel`` with its wrapper ``lambda_weights_fused`` (sort and gathers
included): kernel ``csrc/lambda_pairs.cu``, one launch a boosting round
over every query; plain version :func:`lambda_round_plain`.

It applies to metrics whose swap change is product-separable over ranked
positions, ``|Δ_pq| = |A_p − A_q|·|B_p − B_q|`` (ref
metric/NDCGScorer.java:~150):

* NDCG@k: A = (2^label − 1)/idealDCG, B = truncated 1/log2(pos+2);
* DCG@k:  A = 2^label − 1,            B = truncated discount;
* P@k:    A = rel/k_eff,              B = inside-cutoff indicator.

Per pair (winner p, loser q by label), ``rho = sigmoid(s_q − s_p)``,
``lam_p += rho·|Δ|``, ``lam_q −= rho·|Δ|`` and both ``w`` get
``rho(1−rho)·|Δ|``. The torch-op paths of ``gbdt.lambdas`` materialise a
dozen ``[B, D, D]`` temporaries for this.

The round takes this route when :func:`supports_fused` holds
(``RANKLIB_TPU_FUSED_LAMBDA=1``, the reference's opt-in, for NDCG/DCG/P).
The kernel ranks each query's documents by a stable compare-count, takes
A and B from per-fit factors (:func:`round_lambda_data`: what depends only
on labels, from :func:`separable_vectors`' own f64 code) and writes the
round's ``[Npad]`` lambdas in flat document order. Its plain version runs
the reference's per-chunk route, :func:`lambda_weights_fused` (sort,
gathers, :func:`separable_vectors`, the ``[B, D, D]`` pair block of
:func:`lambda_pairs_plain`, the inverse permutation), on every bucket
chunk, then puts the chunks back in document order (:func:`chunk_lambdas`).

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel or the wrapper raises — nothing falls back. Launches count in
``lambda_round.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.metrics import scorers as S
from ranklib_tpu_torch.utils.errors import RankLibError

# metrics whose |Δ| factors as |A_i − A_j|·|B_i − B_j|: the fused kernel's
# domain, and the sort-free path's per-fit scale (gbdt.lambdas)
SEPARABLE_METRICS = ("NDCG", "DCG", "P")

# the reference's opt-in for the fused route
FUSED_ENV = "RANKLIB_TPU_FUSED_LAMBDA"

# queries wider than a block of this many threads stage through a global
# scratch row (csrc/lambda_pairs.cu kMaxThreads)
_KERNEL_TILE = 1024


def supports_fused(scorer) -> bool:
    """True when the round takes the fused route: the opt-in is set and
    the metric is separable. The reference also demands a TPU; here the
    route runs its kernel on the card and its plain version on the CPU."""
    return (os.environ.get(FUSED_ENV) == "1"
            and scorer.metric in SEPARABLE_METRICS)


def _discount64(D: int, device) -> torch.Tensor:
    """f64 ``1/log2(pos + 2)`` for positions ``0..D-1``."""
    return 1.0 / torch.log2(
        torch.arange(D, dtype=torch.float64, device=device) + 2.0)


def query_factors(scorer, L: torch.Tensor, n: torch.Tensor):
    """(factor ``[B]`` f64, k_eff ``[B]`` int32) of a separable metric:
    each query's part of A that depends only on its labels — 1/idealDCG
    (NDCG, 0 when the ideal DCG is 0), 1 (DCG), or the f32 1/k_eff (P) —
    and its effective cutoff. ``L`` labels ``[B, D]`` in any order of each
    row's valid slots (the ideal DCG sorts them), ``n`` true doc counts."""
    D = L.shape[-1]
    ke = S._k_eff(scorer.k, n)
    if scorer.metric == "P":
        # k <= 0 means no cutoff: k_eff = n (S._k_eff), never 0
        kf = ke.to(torch.float32)
        inv_k = torch.where(kf > 0, 1.0 / torch.where(kf > 0, kf, 1.0), 0.0)
        return inv_k.to(torch.float64), ke
    if scorer.metric == "DCG":
        return torch.ones(L.shape[0], dtype=torch.float64,
                          device=L.device), ke
    disc = S._ink(scorer.k, n, D).to(torch.float64) * _discount64(
        D, L.device)[None, :]
    ideal = ((torch.exp2(S._ideal(L, n).to(torch.float64)) - 1.0)
             * disc).sum(dim=-1)
    return torch.where(ideal > 0, 1.0 / torch.where(ideal > 0, ideal, 1.0),
                       0.0), ke


def separable_vectors(scorer, L: torch.Tensor, n: torch.Tensor):
    """(A, B) ``[B, D]`` f32 per-position vectors of a separable metric;
    ``L`` ranked labels ``[B, D]``, ``n`` true doc counts ``[B]``. None
    when the metric's swap change is not product-separable.

    The discount and the ideal DCG are computed in f64 and rounded once, so
    the card and the CPU give the same vectors (f32 ``log2`` and sums in
    another order differ in the last bit between the two); they are within
    an ulp of the reference's f32 values."""
    if scorer.metric not in SEPARABLE_METRICS:
        return None
    D = L.shape[-1]
    valid = S._valid(n, D)
    fac, ke = query_factors(scorer, L, n)
    ink = S._ink(scorer.k, n, D)
    if scorer.metric == "P":
        rel = (L > 0).to(torch.float32) * valid
        return rel * fac.to(torch.float32)[:, None], ink
    gain = (torch.exp2(L) - 1.0) * valid
    disc = ink.to(torch.float64) * _discount64(D, L.device)[None, :]
    return ((gain.to(torch.float64) * fac[:, None]).to(torch.float32),
            disc.to(torch.float32))


def lambda_pairs_plain(A, Bv, L, S_, V):
    """The pair block of one ranked chunk, as the reference kernel's
    ``[B, D, D]`` block in f32: row sums (winner shares) minus column
    sums (loser shares) taken in f64 and rounded once, as the kernel's."""
    delta = ((A[:, :, None] - A[:, None, :]).abs()
             * (Bv[:, :, None] - Bv[:, None, :]).abs())
    p = torch.where(L[:, :, None] > L[:, None, :],
                    V[:, :, None] * V[:, None, :], 0.0)
    rho = torch.sigmoid(S_[:, None, :] - S_[:, :, None])
    m = (p * rho * delta).to(torch.float64)
    ww = (p * (rho * (1.0 - rho)) * delta).to(torch.float64)
    return ((m.sum(dim=2) - m.sum(dim=1)).to(torch.float32),
            (ww.sum(dim=2) + ww.sum(dim=1)).to(torch.float32))


def lambda_weights_fused(scorer, labels, scores, mask):
    """The reference's fused route on one chunk, the sorted path's contract
    for separable metrics: ``[B, D]`` labels, scores and bool mask →
    (lam, w) in the chunk's doc order. Sort, gathers,
    :func:`separable_vectors` (the ideal DCG from the labels of each
    call), :func:`lambda_pairs_plain`, the inverse permutation."""
    n = mask.sum(dim=-1).to(torch.int32)
    key = torch.where(mask, -scores, torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices   # desc, pads last
    L = torch.gather(labels, -1, order)
    A, Bv = separable_vectors(scorer, L, n)
    lam_r, w_r = lambda_pairs_plain(
        A, Bv, L, torch.gather(scores, -1, order),
        torch.gather(mask.to(torch.float32), -1, order))
    # inverse permutation: ranked slot r holds doc order[r]
    lam = torch.empty_like(lam_r).scatter_(-1, order, lam_r)
    w = torch.empty_like(w_r).scatter_(-1, order, w_r)
    z = mask.to(torch.float32)
    return lam * z, w * z


def chunk_lambdas(fn, chunks, scales, scores, inv):
    """(lam, w) ``[Npad]`` in flat document order from a per-chunk path
    ``fn(labels, scores, mask, scale)`` over the bucket chunks
    ``(labels, mask, didx)``; ``inv`` is each document's slot in the
    concatenated chunk layouts (pad documents → a zero tail slot)."""
    parts_l, parts_w = [], []
    for (lab, msk, didx), scl in zip(chunks, scales):
        l_, w_ = fn(lab, scores[didx], msk, scl)
        parts_l.append(l_.reshape(-1))
        parts_w.append(w_.reshape(-1))
    zero = torch.zeros(1, dtype=scores.dtype, device=scores.device)
    return (torch.cat(parts_l + [zero])[inv],
            torch.cat(parts_w + [zero])[inv])


@dataclass
class RoundLambdas:
    """Per-fit inputs of the fused round, on the fit's device."""

    scorer: object
    labels: torch.Tensor       # [Npad] f32, pads 0
    qptr: torch.Tensor         # [Q + 1] int32: query q is docs
                               #   [qptr[q], qptr[q + 1])
    order: torch.Tensor        # [Q] int32: the queries, widest first
                               #   (the kernel's blocks, so that each SM
                               #   gets a like share of the pairs)
    qfac: torch.Tensor         # [Q] f64 (query_factors)
    keff: torch.Tensor         # [Q] int32
    disc: torch.Tensor         # [max(max_docs, 1)] f32 discount by rank
                               #   (ones for P@k)
    max_docs: int              # the widest query
    chunks: list               # (labels, mask, didx): the plain version's
    inv: torch.Tensor          # [Npad] int64 (chunk_lambdas)


def round_lambda_data(scorer, labels: torch.Tensor, qptr: np.ndarray,
                      chunks_host: list, chunks: list, inv: torch.Tensor,
                      device) -> RoundLambdas:
    """The fused round's per-fit data. Factors and the discount table are
    computed here on the CPU by :func:`query_factors` and
    :func:`separable_vectors`' discount on each host chunk ``(labels, mask,
    didx)``, at the chunk's own shape, so they equal the plain version's
    per-call values bit for bit; card and CPU fits share them."""
    Q = len(qptr) - 1
    qfac = np.ones(Q, np.float64)
    keff = np.zeros(Q, np.int32)
    for lab, msk, didx in chunks_host:
        n = msk.sum(axis=1)
        rows = np.flatnonzero(n > 0)
        fac, ke = query_factors(scorer, torch.from_numpy(lab),
                                torch.from_numpy(n.astype(np.int32)))
        q = np.searchsorted(qptr, didx[rows, 0], side="right") - 1
        qfac[q] = fac.numpy()[rows]
        keff[q] = ke.numpy()[rows]
    sizes = np.diff(qptr)
    max_docs = int(sizes.max(initial=0))
    order = np.argsort(-sizes, kind="stable").astype(np.int32)
    D = max(max_docs, 1)
    disc = (torch.ones(D, dtype=torch.float32) if scorer.metric == "P"
            else _discount64(D, "cpu").to(torch.float32))
    return RoundLambdas(
        scorer=scorer, labels=labels,
        qptr=torch.from_numpy(qptr.astype(np.int32)).to(device),
        order=torch.from_numpy(order).to(device),
        qfac=torch.from_numpy(qfac).to(device),
        keff=torch.from_numpy(keff).to(device), disc=disc.to(device),
        max_docs=max_docs, chunks=chunks, inv=inv)


def lambda_round_plain(rd: RoundLambdas, scores: torch.Tensor):
    """Plain version of :func:`lambda_round`: the reference's per-chunk
    route (:func:`lambda_weights_fused`) on every bucket chunk, then
    document order."""
    return chunk_lambdas(
        lambda lab, sc, msk, _: lambda_weights_fused(rd.scorer, lab, sc, msk),
        rd.chunks, [None] * len(rd.chunks), scores, rd.inv)


_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("lambda_pairs")
    lib.lambda_pairs.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int,
                                 _int, _i64, _int, _vp, _vp, _vp, _vp]
    lib.lambda_pairs.restype = _int
    return lib


def _check(rd: RoundLambdas, scores: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version);
    raises on what neither takes."""
    name = "lambda_round"
    npad = rd.labels.shape[0]
    if (scores.dtype != torch.float32 or scores.dim() != 1
            or scores.shape[0] < npad or not scores.is_contiguous()):
        raise RankLibError(f"{name}: scores must be a contiguous float32 "
                           f"vector of at least {npad} documents")
    dev = scores.device
    if dev.type not in ("cpu", "cuda"):
        raise RankLibError(f"{name}: tensors on {dev} are not supported")
    if any(t.device != dev for t in (rd.labels, rd.qptr, rd.order, rd.qfac,
                                     rd.keff, rd.disc)):
        raise RankLibError(f"{name}: scores on {dev} but the fit's data on "
                           f"{rd.labels.device}")
    return dev.type == "cuda"


def launch_args(rd: RoundLambdas, scores: torch.Tensor):
    """(arguments of ``lambda_pairs``, (lam, w, scratch)): one launch over
    CUDA ``scores`` with its outputs allocated — what :func:`lambda_round`
    launches, for timing the launch alone. The scratch rows (queries wider
    than the kernel stages, else None) must outlive the launch."""
    if not _check(rd, scores):
        raise RankLibError("lambda_round: launch_args takes CUDA tensors")
    dev, npad = scores.device, rd.labels.shape[0]
    lam = torch.empty(npad, dtype=torch.float32, device=dev)
    w = torch.empty(npad, dtype=torch.float32, device=dev)
    wide = (torch.empty((npad, 4), dtype=torch.float32, device=dev)
            if rd.max_docs > _KERNEL_TILE else None)
    args = (rd.labels.data_ptr(), scores.data_ptr(), rd.qptr.data_ptr(),
            rd.order.data_ptr(), rd.qfac.data_ptr(), rd.keff.data_ptr(),
            rd.disc.data_ptr(), int(rd.scorer.metric == "P"),
            rd.qptr.shape[0] - 1, npad,
            rd.max_docs, None if wide is None else wide.data_ptr(),
            lam.data_ptr(), w.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return args, (lam, w, wide)


def lambda_round(rd: RoundLambdas, scores: torch.Tensor):
    """(lam, w) ``[Npad]`` f32 in flat document order from the round's
    ``scores`` (``[Npad]`` or longer; the boosting state's ``[Npad + 1]``)
    and the per-fit ``rd`` (:func:`round_lambda_data`). Pad documents get
    0."""
    if not _check(rd, scores):
        return lambda_round_plain(rd, scores)
    args, (lam, w, _scratch) = launch_args(rd, scores)
    with torch.cuda.device(scores.device):
        rc = _kernels().lambda_pairs(*args)
    if rc != 0:
        raise RankLibError(f"lambda_round: CUDA launch failed with error "
                           f"{rc}")
    lambda_round.launches += 1
    return lam, w


lambda_round.launches = 0
