"""Fused lambda-gradient pair sums (ranklib_tpu.ops.lambda_kernel).

:func:`lambda_pairs` replaces ``ranklib_tpu/ops/lambda_kernel.py``
``_kernel`` (wrapper ``lambda_weights_fused``): kernel
``csrc/lambda_pairs.cu``, plain version :func:`lambda_pairs_plain`.

It applies to metrics whose swap change is product-separable over ranked
positions, ``|Δ_pq| = |A_p − A_q|·|B_p − B_q|`` (ref
metric/NDCGScorer.java:~150):

* NDCG@k: A = (2^label − 1)/idealDCG, B = truncated 1/log2(pos+2);
* DCG@k:  A = 2^label − 1,            B = truncated discount;
* P@k:    A = rel/k_eff,              B = inside-cutoff indicator.

Per pair (winner p, loser q by label), ``rho = sigmoid(s_q − s_p)``,
``lam_p += rho·|Δ|``, ``lam_q −= rho·|Δ|`` and both ``w`` get
``rho(1−rho)·|Δ|``. The torch-op paths of ``gbdt.lambdas`` materialise a
dozen ``[B, D, D]`` temporaries for this; the kernel reads the five ranked
``[B, D]`` vectors and writes the two ``[B, D]`` results.

:func:`lambda_weights_fused` is the round's route when
:func:`supports_fused` holds (``RANKLIB_TPU_FUSED_LAMBDA=1``, the
reference's opt-in, for NDCG/DCG/P): sort, gather, :func:`separable_vectors`,
the pair kernel, the inverse permutation. The sort and the gathers stay
torch ops, as they sit outside the ``pallas_call`` in the reference.

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel or the wrapper raises — nothing falls back. Launches count in
``lambda_pairs.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ranklib_tpu_torch.metrics import scorers as S
from ranklib_tpu_torch.utils.errors import RankLibError

# metrics whose |Δ| factors as |A_i − A_j|·|B_i − B_j|: the fused kernel's
# domain, and the sort-free path's per-fit scale (gbdt.lambdas)
SEPARABLE_METRICS = ("NDCG", "DCG", "P")

# the reference's opt-in for the fused route
FUSED_ENV = "RANKLIB_TPU_FUSED_LAMBDA"


def supports_fused(scorer) -> bool:
    """True when the round takes the fused route: the opt-in is set and
    the metric is separable. The reference also demands a TPU; here the
    route runs its kernel on the card and its plain version on the CPU."""
    return (os.environ.get(FUSED_ENV) == "1"
            and scorer.metric in SEPARABLE_METRICS)


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
    if scorer.metric == "P":
        rel = (L > 0).to(torch.float32) * valid
        # k <= 0 means no cutoff: k_eff = n (S._k_eff), never 0
        ke = S._k_eff(scorer.k, n).to(torch.float32)
        inv_k = torch.where(ke > 0, 1.0 / torch.where(ke > 0, ke, 1.0), 0.0)
        return rel * inv_k[:, None], S._ink(scorer.k, n, D)
    f64 = dict(dtype=torch.float64, device=L.device)
    disc = S._ink(scorer.k, n, D).to(torch.float64) / torch.log2(
        torch.arange(D, **f64) + 2.0)[None, :]
    gain = (torch.exp2(L) - 1.0) * valid
    if scorer.metric == "DCG":
        return gain, disc.to(torch.float32)
    ideal = ((torch.exp2(S._ideal(L, n).to(torch.float64)) - 1.0)
             * disc).sum(dim=-1)
    inv = torch.where(ideal > 0, 1.0 / torch.where(ideal > 0, ideal, 1.0),
                      0.0)
    return ((gain.to(torch.float64) * inv[:, None]).to(torch.float32),
            disc.to(torch.float32))


def lambda_pairs_plain(A, Bv, L, S_, V):
    """Plain version of :func:`lambda_pairs`: the reference kernel's
    ``[B, D, D]`` pair block in f32, row sums (winner shares) minus column
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


_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("lambda_pairs")
    lib.lambda_pairs.argtypes = [_vp, _vp, _vp, _vp, _vp, _i64, _int, _vp,
                                 _vp, _vp]
    lib.lambda_pairs.restype = _int
    return lib


def lambda_pairs(A, Bv, L, S_, V):
    """(lam, w) ``[B, D]`` f32 in ranked order from the ranked vectors
    ``A``, ``Bv`` (the metric's separable factors), ``L`` labels, ``S_``
    scores and ``V`` validity (0/1), each a contiguous ``[B, D]`` f32."""
    name = "lambda_pairs"
    ts = (A, Bv, L, S_, V)
    if any(t.dtype != torch.float32 or t.dim() != 2
           or t.shape != A.shape or not t.is_contiguous() for t in ts):
        raise RankLibError(f"{name}: inputs must be contiguous [B, D] "
                           f"float32 of one shape")
    dev = A.device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in ts):
        raise RankLibError(f"{name}: all tensors must share one cpu or "
                           f"cuda device")
    if dev.type == "cpu":
        return lambda_pairs_plain(*ts)
    rows, D = A.shape
    lam = torch.empty_like(A)
    w = torch.empty_like(A)
    if rows and D:
        with torch.cuda.device(dev):
            rc = _kernels().lambda_pairs(
                *(t.data_ptr() for t in ts), rows, D, lam.data_ptr(),
                w.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RankLibError(f"{name}: CUDA launch failed with error {rc}")
        lambda_pairs.launches += 1
    return lam, w


lambda_pairs.launches = 0


def ranked_pair_inputs(scorer, labels, scores, mask):
    """(order, (A, Bv, L, S, V)): the stable score-descending order of a
    ``[B, D]`` chunk (pads last) and the pair kernel's ranked inputs."""
    n = mask.sum(dim=-1).to(torch.int32)
    key = torch.where(mask, -scores, torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    L = torch.gather(labels, -1, order)
    Sc = torch.gather(scores, -1, order)
    V = torch.gather(mask.to(torch.float32), -1, order)
    A, Bv = separable_vectors(scorer, L, n)
    return order, (A.contiguous(), Bv.contiguous(), L, Sc, V)


def lambda_weights_fused(scorer, labels, scores, mask):
    """The sorted path's contract for separable metrics: ``[B, D]`` labels,
    scores and bool mask → (lam, w) in the chunk's doc order. The ideal
    DCG comes from the labels of each call (no per-fit scale)."""
    order, ranked = ranked_pair_inputs(scorer, labels, scores, mask)
    lam_r, w_r = lambda_pairs(*ranked)
    # inverse permutation: ranked slot r holds doc order[r]
    lam = torch.empty_like(lam_r).scatter_(-1, order, lam_r)
    w = torch.empty_like(w_r).scatter_(-1, order, w_r)
    z = mask.to(torch.float32)
    return lam * z, w * z
