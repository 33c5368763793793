"""Forest evaluation: the serving path's three CUDA kernels.

Kernels (``csrc/forest_eval.cu``, built for ``sm_90a`` by ``ops._build``):

* :func:`forest_eval_frombins` replaces ``ranklib_tpu/ops/forest_eval.py``
  ``_forest_frombins_kernel`` (wrapper ``forest_eval_pallas_frombins``):
  scores documents whose ids were binned on the host (``binsT [F, N]``
  uint8/int16). The route ``TreeEnsemble.eval_matrix`` takes.
* :func:`forest_eval_bins` replaces ``_forest_bins_kernel`` (wrapper
  ``forest_eval_pallas_bins``): bins ``X [N, F]`` f32 on the device
  (``#{grid_f < x}``, NaN → n_grid), then scores. The device-resident route.
* :func:`forest_eval_full` replaces ``_forest_full3_kernel`` /
  ``_forest_full_kernel`` (wrapper ``forest_eval_pallas_full``): scores
  ``X [N, F]`` f32 by the f32 test ``x <= threshold`` itself, for models
  the bin-space kernels do not take (more than ``MAX_GRID`` thresholds on
  a feature, or more than ``MAX_FEATURES`` columns).
* :func:`device_bins_narrow` replaces ``_bins_only_kernel`` (wrapper
  ``forest_eval_pallas_bins_split``): bins ``X [N, F]`` into uint8/int16
  ids ``[F, N]`` on the device. :func:`forest_eval_bins_split` is that pass
  then :func:`forest_eval_frombins` on the ids it wrote — the split route
  (``RANKLIB_TPU_SERVE_SPLIT=1``), whose selection half
  ``_forest_bins_split_kernel`` computes what the frombins kernel does.
* :func:`forest_eval_pred` replaces ``_forest_kernel`` (wrapper
  ``forest_eval_pallas``): folds precomputed 0/1 node tests ``predT`` into
  leaf sums through the P−Q path blocks. Like the reference's, it is a
  public function that no serving route calls.

The bin-space kernels route a document left iff ``bin <= nodebin``, the
f32 kernel iff ``x <= t`` (NaN goes right); all sum ``w·leaf``. The TPU
kernels express that as one-hot selection and path matmuls for the MXU
(the f32 one through three exact bf16 planes); the CUDA kernels walk each
tree from the root, one thread per document, with the document's ids or
values staged in shared memory once per block. Every forest walk runs on
split records packed once per model (``TreeEnsemble._pack_splits``: one
record an internal node, a leaf's value inside its parent's record),
staged a tree chunk at a time in shared memory, through one chunk loop
(see the .cu header).

Beside each kernel, a plain PyTorch version of the same function takes the
reference's ``_pack_matmul_bins`` (or ``_pack_matmul``) operands and
mirrors ``_bins_selection_epilogue`` (or ``_mm_eval``): gather, compare,
P−Q path product, leaf fold. Routing is exact in both; the kernel and the
plain version also add the leaf values in the same f32 order (tree order,
one partial per chunk of trees), so they agree bit for bit.

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel or the wrapper raises — nothing falls back. Each wrapper counts
its kernel launches in a plain int attribute, ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ranklib_tpu_torch.utils.errors import RankLibError

# Largest n_grid the bin-space kernels take (uint8/int16 ids of at most 256
# thresholds): models with more distinct thresholds on one feature take the
# f32 route, as in the reference.
MAX_GRID = 256
# Widest input the bin-space kernels take: 32 docs x F int16 bins must fit
# the 227 KB of shared memory a block can use. The f32 route takes any width.
MAX_FEATURES = 232448 // (32 * 2)


@dataclass(frozen=True, eq=False)
class ForestPack:
    """One model's device operands for the bin-space kernels, built by
    ``TreeEnsemble.forest_pack`` (all tensors on one device).

    The reference's ``_pack_matmul_bins`` layout feeds the plain versions:
    ``grid [F, Bm]`` f32 (+inf padded), ``fid_full``/``nodebin_full``
    ``[nch·TCM]``, ``PmQc [nch, TCM, TCL]``, ``csQc``/``plenc``/``outwc``
    ``[nch, TCL]`` with TCL = tree_chunk·L; tree j of a chunk owns P−Q rows
    ``j·M .. (j+1)·M`` (M = ``nodes_per_tree``). ``pred_paths``
    int32 ``[nch·tree_chunk, R]`` holds P−Q's path lists, one record a
    tree, for the predicate epilogue (``gbdt/ensemble.py _pred_paths``).
    The kernels walk split
    records (``TreeEnsemble._pack_splits``): ``splits [S, 4]`` int32
    (feature, node bin | leaf flags, left, right; a child is a leaf's
    w·output bits or a record index within the tree's chunk),
    ``split_roots [T]`` int32 (within the chunk), ``chunk_starts [nch +
    1]`` int32, ``chunk_splits``, the most records in a chunk, and
    ``max_depth``, the most tests on a root-to-leaf path."""

    n_features: int
    n_grid: int
    tree_chunk: int
    nodes_per_tree: int
    max_depth: int
    chunk_splits: int
    grid: torch.Tensor
    fid_full: torch.Tensor
    nodebin_full: torch.Tensor
    PmQc: torch.Tensor
    csQc: torch.Tensor
    plenc: torch.Tensor
    outwc: torch.Tensor
    pred_paths: torch.Tensor
    splits: torch.Tensor
    split_roots: torch.Tensor
    chunk_starts: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.splits.device

    def matmul_operands(self):
        """(fid_full, nodebin_full, PmQc, csQc, plenc, outwc)."""
        return (self.fid_full, self.nodebin_full, self.PmQc, self.csQc,
                self.plenc, self.outwc)


@dataclass(frozen=True, eq=False)
class FullPack:
    """One model's device operands for the f32 route, built by
    ``TreeEnsemble.full_pack``: the reference's ``_pack_matmul`` layout
    (``fid_full``/``thr_full`` [nch·TCM], ``PmQc``, ``csQc``, ``plenc``,
    ``outwc``; M = ``nodes_per_tree`` P−Q rows a tree) for the plain
    version, P−Q's path lists (``pred_paths``, as in :class:`ForestPack`)
    for the predicate epilogue, and f32 split records
    for the kernel: ``splits [S, 4]`` int32 (feature | left-is-leaf << 30 |
    right-is-leaf << 31, the threshold's f32 bits, left, right), with
    ``split_roots``, ``chunk_starts``, ``chunk_splits`` and ``max_depth``
    as in :class:`ForestPack`."""

    n_features: int
    tree_chunk: int
    nodes_per_tree: int
    max_depth: int
    chunk_splits: int
    fid_full: torch.Tensor
    thr_full: torch.Tensor
    PmQc: torch.Tensor
    csQc: torch.Tensor
    plenc: torch.Tensor
    outwc: torch.Tensor
    pred_paths: torch.Tensor
    splits: torch.Tensor
    split_roots: torch.Tensor
    chunk_starts: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.splits.device

    def matmul_operands(self):
        """(fid_full, thr_full, PmQc, csQc, plenc, outwc)."""
        return (self.fid_full, self.thr_full, self.PmQc, self.csQc,
                self.plenc, self.outwc)


# ---- plain PyTorch versions ----------------------------------------------

def _selection_operands(fid_full, nodebin_full, PmQc, csQc, plenc, outwc):
    """Per-chunk selection operands (ref ``_selection_operands``, :402):
    node feature ids and node bins as integers (a gather replaces the
    one-hot selection matmul), P−Q as is, and the csQ fold
    ``hits + csQ == plen  ⟺  hits == plen − csQ``."""
    nch, TCM, _ = PmQc.shape
    fid = fid_full.reshape(nch, TCM).to(torch.int64)
    nodebin = nodebin_full.reshape(nch, TCM).to(torch.int32)
    return fid, nodebin, PmQc, plenc - csQc, outwc


def _chunk_leaf_sum(pred, PmQ, plen_adj, outw, tree_chunk: int):
    """One tree chunk's leaf sum [N] from its node tests ``pred [TCM, N]``
    (0/1 f32): count path agreements with one P−Q product (small
    integers, exact in f32), take the output of the one leaf each tree's
    path reaches, and add those in tree order — the kernels' order."""
    N = pred.shape[1]
    hits = pred.T @ PmQ                                      # [N, TCL]
    contrib = torch.where(hits == plen_adj, outw, 0.0)
    per_tree = contrib.view(N, tree_chunk, -1).sum(dim=2)   # one leaf each
    partial = torch.zeros(N, dtype=torch.float32, device=pred.device)
    for j in range(tree_chunk):
        partial = partial + per_tree[:, j]
    return partial


def _bins_selection_epilogue(bins, fid, nodebin, PmQ, plen_adj, outw,
                             tree_chunk: int) -> torch.Tensor:
    """Selection + leaf fold over int32 ids ``bins [F, N]`` (ref
    ``_bins_selection_epilogue``, :244): per tree chunk, gather each
    node's feature ids, compare with the node bin, and add the chunk's
    :func:`_chunk_leaf_sum`."""
    score = torch.zeros(bins.shape[1], dtype=torch.float32,
                        device=bins.device)
    for c in range(PmQ.shape[0]):
        vals = bins.index_select(0, fid[c])                  # [TCM, N]
        pred = (vals <= nodebin[c][:, None]).to(torch.float32)
        score = score + _chunk_leaf_sum(pred, PmQ[c], plen_adj[c], outw[c],
                                        tree_chunk)
    return score


def forest_eval_frombins_plain(binsT, fid_full, nodebin_full, PmQc, csQc,
                               plenc, outwc, *, tree_chunk: int):
    """Plain version of :func:`forest_eval_frombins` on the reference's
    operands. ``binsT [F, N]`` integer ids; upcast to int32 before any
    compare (a uint8/int16 compare against 256 would wrap)."""
    bins = binsT.to(torch.int32)
    return _bins_selection_epilogue(
        bins, *_selection_operands(fid_full, nodebin_full, PmQc, csQc,
                                   plenc, outwc), tree_chunk)


def forest_eval_full_plain(X, fid_full, thr_full, PmQc, csQc, plenc, outwc,
                           *, tree_chunk: int):
    """Plain version of :func:`forest_eval_full` (ref ``_mm_eval``, :741)
    on the reference's ``_pack_matmul`` operands: per tree chunk, gather
    each node's feature row of Xᵀ, compare with its f32 threshold (NaN <=
    t is False: routed right) and add the chunk's :func:`_chunk_leaf_sum`.
    X [N, F] f32 → [N] f32."""
    nch, TCM, _ = PmQc.shape
    fid = fid_full.reshape(nch, TCM).to(torch.int64)
    thr = thr_full.reshape(nch, TCM)
    XT = X.T
    score = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for c in range(nch):
        pred = (XT.index_select(0, fid[c]) <= thr[c][:, None]).to(
            torch.float32)
        score = score + _chunk_leaf_sum(pred, PmQc[c], plenc[c] - csQc[c],
                                        outwc[c], tree_chunk)
    return score


def forest_eval_pred_plain(predT, PmQc, csQc, plenc, outwc, *,
                           tree_chunk: int):
    """Plain version of :func:`forest_eval_pred` (ref ``forest_eval_pallas``
    on the same operands): :func:`_chunk_leaf_sum` of each chunk's rows of
    ``predT`` (any 0/1 type), added in chunk order."""
    nch, TCM, _ = PmQc.shape
    score = torch.zeros(predT.shape[1], dtype=torch.float32,
                        device=predT.device)
    for c in range(nch):
        pred = predT[c * TCM:(c + 1) * TCM].to(torch.float32)
        score = score + _chunk_leaf_sum(pred, PmQc[c], plenc[c] - csQc[c],
                                        outwc[c], tree_chunk)
    return score


def device_bins(X: torch.Tensor, grid: torch.Tensor,
                n_grid: int) -> torch.Tensor:
    """``X [N, F]`` f32 → int32 ids ``[F, N]``: ``#{grid_f < x}`` over the
    first n_grid grid columns (the sorted row's lower bound; +inf pads
    never count), NaN → n_grid (routed right at every node)."""
    XT = X.T.contiguous()
    ids = torch.searchsorted(grid[:, :n_grid].contiguous(), XT).to(torch.int32)
    return torch.where(torch.isnan(XT), n_grid, ids).to(torch.int32)


def forest_eval_bins_plain(X, grid, fid_full, nodebin_full, PmQc, csQc,
                           plenc, outwc, *, n_grid: int, tree_chunk: int):
    """Plain version of :func:`forest_eval_bins` on the reference's
    operands: :func:`device_bins`, then the shared selection."""
    return _bins_selection_epilogue(
        device_bins(X, grid, n_grid),
        *_selection_operands(fid_full, nodebin_full, PmQc, csQc, plenc,
                             outwc), tree_chunk)


# ---- kernel wrappers ---------------------------------------------------------

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("forest_eval")
    walk = [_vp, _vp, _vp, _int, _int, _int, _int, _vp, _vp]
    for fn in (lib.forest_eval_frombins_u8, lib.forest_eval_frombins_i16):
        fn.argtypes = [_vp, _i64, _int, *walk]
        fn.restype = _int
    lib.forest_eval_bins.argtypes = [_vp, _i64, _int, _vp, _int, _int, *walk]
    lib.forest_eval_bins.restype = _int
    lib.forest_eval_full.argtypes = [_vp, _i64, _int, *walk]
    lib.forest_eval_full.restype = _int
    for fn in (lib.forest_bins_only_u8, lib.forest_bins_only_i16):
        fn.argtypes = [_vp, _i64, _int, _vp, _int, _int, _vp, _vp]
        fn.restype = _int
    for fn in (lib.forest_eval_pred_u8, lib.forest_eval_pred_bf16):
        fn.argtypes = [_vp, _i64, _int, _int, _int, _int, _int, _vp, _int,
                       _vp, _vp, _vp, _vp, _vp, _vp]
        fn.restype = _int
    return lib


def _check_device(x: torch.Tensor, pack, name: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise RankLibError(f"{name}: tensors on {x.device} are not supported")
    if pack.device != x.device:
        raise RankLibError(f"{name}: input on {x.device} but the model's "
                           f"pack on {pack.device}")
    return x.device.type == "cuda"


def _split_args(pack, out: torch.Tensor):
    """The split records' arguments every forest walk takes, then the
    output and the stream: records, roots, chunk starts, trees, trees a
    chunk, the most tests on a path (at least 1), the most records in a
    chunk."""
    return (pack.splits.data_ptr(), pack.split_roots.data_ptr(),
            pack.chunk_starts.data_ptr(), int(pack.split_roots.shape[0]),
            pack.tree_chunk, max(pack.max_depth, 1), pack.chunk_splits,
            out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RankLibError(f"{name}: CUDA launch failed with error {rc}")


def forest_eval_frombins(binsT: torch.Tensor, pack: ForestPack) -> torch.Tensor:
    """Scores ``[N]`` f32 of documents binned on the host: ``binsT [F, N]``
    contiguous uint8 or int16 ids against ``pack``'s grid
    (``#{grid_f < x}``, clamped to n_grid, NaN → n_grid)."""
    name = "forest_eval_frombins"
    if binsT.dtype not in (torch.uint8, torch.int16):
        raise RankLibError(f"{name}: ids must be uint8 or int16, "
                           f"got {binsT.dtype}")
    if binsT.dim() != 2 or binsT.shape[0] != pack.n_features:
        raise RankLibError(f"{name}: ids must be [{pack.n_features}, N], "
                           f"got {tuple(binsT.shape)}")
    if not binsT.is_contiguous():
        raise RankLibError(f"{name}: ids must be contiguous")
    if not _check_device(binsT, pack, name):
        return forest_eval_frombins_plain(binsT, *pack.matmul_operands(),
                                          tree_chunk=pack.tree_chunk)
    F, N = binsT.shape
    out = torch.empty(N, dtype=torch.float32, device=binsT.device)
    if N:
        lib = _kernels()
        fn = (lib.forest_eval_frombins_u8 if binsT.dtype == torch.uint8
              else lib.forest_eval_frombins_i16)
        with torch.cuda.device(binsT.device):
            _raise_on(fn(binsT.data_ptr(), N, F, *_split_args(pack, out)),
                      name)
        forest_eval_frombins.launches += 1
    return out


forest_eval_frombins.launches = 0


def _check_features(X: torch.Tensor, pack, name: str) -> bool:
    """Validates ``X [N, F]`` contiguous f32; True for CUDA (launch the
    kernel), False for CPU (plain version)."""
    if X.dtype != torch.float32:
        raise RankLibError(f"{name}: features must be float32, got {X.dtype}")
    if X.dim() != 2 or X.shape[1] != pack.n_features:
        raise RankLibError(f"{name}: features must be [N, {pack.n_features}], "
                           f"got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise RankLibError(f"{name}: features must be contiguous")
    return _check_device(X, pack, name)


def forest_eval_bins(X: torch.Tensor, pack: ForestPack) -> torch.Tensor:
    """Scores ``[N]`` f32 of device-resident features ``X [N, F]``
    (contiguous f32), binned on the device against ``pack``'s grid."""
    name = "forest_eval_bins"
    if not _check_features(X, pack, name):
        return forest_eval_bins_plain(X, pack.grid, *pack.matmul_operands(),
                                      n_grid=pack.n_grid,
                                      tree_chunk=pack.tree_chunk)
    N, F = X.shape
    out = torch.empty(N, dtype=torch.float32, device=X.device)
    if N:
        lib = _kernels()
        with torch.cuda.device(X.device):
            _raise_on(lib.forest_eval_bins(
                X.data_ptr(), N, F, pack.grid.data_ptr(),
                int(pack.grid.shape[1]), pack.n_grid,
                *_split_args(pack, out)), name)
        forest_eval_bins.launches += 1
    return out


forest_eval_bins.launches = 0


def forest_eval_full(X: torch.Tensor, pack: FullPack) -> torch.Tensor:
    """Scores ``[N]`` f32 of device-resident features ``X [N, F]``
    (contiguous f32) by each node's f32 test ``x <= threshold``: any
    number of thresholds on a feature, any width."""
    name = "forest_eval_full"
    if not _check_features(X, pack, name):
        return forest_eval_full_plain(X, *pack.matmul_operands(),
                                      tree_chunk=pack.tree_chunk)
    N, F = X.shape
    out = torch.empty(N, dtype=torch.float32, device=X.device)
    if N:
        with torch.cuda.device(X.device):
            _raise_on(_kernels().forest_eval_full(
                X.data_ptr(), N, F, *_split_args(pack, out)), name)
        forest_eval_full.launches += 1
    return out


forest_eval_full.launches = 0


def ids_dtype(n_grid: int) -> torch.dtype:
    """The narrowest id type the bin-space kernels take for a grid of
    ``n_grid`` thresholds: uint8 while every id (NaN → n_grid) is below
    256, else int16."""
    return torch.uint8 if n_grid < 256 else torch.int16


def device_bins_narrow(X: torch.Tensor, pack: ForestPack) -> torch.Tensor:
    """Ids ``[F, N]`` (:func:`ids_dtype`) of device-resident features ``X
    [N, F]`` (contiguous f32) against ``pack``'s grid: ``#{grid_f < x}``,
    NaN → n_grid. The plain version is :func:`device_bins`, narrowed."""
    name = "device_bins_narrow"
    dt = ids_dtype(pack.n_grid)
    if not _check_features(X, pack, name):
        return device_bins(X, pack.grid, pack.n_grid).to(dt)
    N, F = X.shape
    ids = torch.empty((F, N), dtype=dt, device=X.device)
    if N:
        lib = _kernels()
        fn = (lib.forest_bins_only_u8 if dt == torch.uint8
              else lib.forest_bins_only_i16)
        with torch.cuda.device(X.device):
            _raise_on(fn(X.data_ptr(), N, F, pack.grid.data_ptr(),
                         int(pack.grid.shape[1]), pack.n_grid,
                         ids.data_ptr(),
                         torch.cuda.current_stream(X.device).cuda_stream),
                      name)
        device_bins_narrow.launches += 1
    return ids


device_bins_narrow.launches = 0


def forest_eval_bins_split(X: torch.Tensor, pack: ForestPack) -> torch.Tensor:
    """Scores ``[N]`` f32 of device-resident features ``X [N, F]`` by the
    split route: :func:`device_bins_narrow` writes the ids, then
    :func:`forest_eval_frombins` scores them. Bit-equal to
    :func:`forest_eval_bins` (the same ids, the same walk)."""
    return forest_eval_frombins(device_bins_narrow(X, pack), pack)


def forest_eval_pred(predT: torch.Tensor,
                     pack: ForestPack | FullPack) -> torch.Tensor:
    """Scores ``[N]`` f32 from precomputed node tests (ref
    ``forest_eval_pallas``): ``predT [nch·TCM, N]`` contiguous 0/1 uint8 or
    bf16 (chunk-major rows, the node order of ``pack.fid_full``) against
    ``pack``'s ``PmQc [nch, TCM, TCL]`` (P−Q in {−1, 0, 1}) and
    ``csQc``/``plenc``/``outwc`` ``[nch, TCL]`` f32. The kernel reads P−Q
    through the pack's path records (``pred_paths``) and stages each
    tree's M rows of ``predT``, so M (``nodes_per_tree``) comes from
    the pack that laid P−Q out: any other M would stage the wrong rows for
    every tree after the first."""
    name = "forest_eval_pred"
    PmQc, csQc, plenc, outwc = pack.PmQc, pack.csQc, pack.plenc, pack.outwc
    tree_chunk, nodes_per_tree = pack.tree_chunk, pack.nodes_per_tree
    if PmQc.dim() != 3:
        raise RankLibError(f"{name}: PmQc must be [nch, TCM, TCL]")
    nch, TCM, TCL = PmQc.shape
    if predT.dtype not in (torch.uint8, torch.bfloat16):
        raise RankLibError(f"{name}: predT must be uint8 or bfloat16, got "
                           f"{predT.dtype}")
    if predT.dim() != 2 or predT.shape[0] != nch * TCM:
        raise RankLibError(f"{name}: predT must be [{nch * TCM}, N], got "
                           f"{tuple(predT.shape)}")
    aux = (csQc, plenc, outwc)
    if any(t.shape != (nch, TCL) for t in aux):
        raise RankLibError(f"{name}: csQc, plenc and outwc must be "
                           f"[{nch}, {TCL}]")
    if any(t.dtype != torch.float32 for t in (PmQc, *aux)):
        raise RankLibError(f"{name}: PmQc, csQc, plenc and outwc must be "
                           f"float32")
    # the packs' layout (gbdt/ensemble.py): TCM = ceil16(tree_chunk · M);
    # any other M reads the wrong [M, L] block for every tree but the first
    if (tree_chunk < 1 or nodes_per_tree < 1 or TCL % tree_chunk
            or (tree_chunk * nodes_per_tree + 15) // 16 * 16 != TCM):
        raise RankLibError(f"{name}: {tree_chunk} trees of "
                           f"{nodes_per_tree} nodes do not tile "
                           f"[{TCM}, {TCL}] chunks")
    paths = pack.pred_paths
    L = TCL // tree_chunk
    if (paths.dim() != 2 or paths.shape[0] != nch * tree_chunk
            or paths.shape[1] < 2 * L + 1 or paths.shape[1] % 4
            or paths.dtype != torch.int32):
        raise RankLibError(f"{name}: pred_paths must be int32 "
                           f"[{nch * tree_chunk}, R], R >= {2 * L + 1} a "
                           f"multiple of 4")
    ts = (predT, PmQc, *aux, paths)
    dev = predT.device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in ts):
        raise RankLibError(f"{name}: all tensors must share one cpu or "
                           f"cuda device")
    if any(not t.is_contiguous() for t in ts):
        raise RankLibError(f"{name}: tensors must be contiguous")
    if dev.type == "cpu":
        return forest_eval_pred_plain(predT, PmQc, csQc, plenc, outwc,
                                      tree_chunk=tree_chunk)
    N = predT.shape[1]
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        part = torch.empty((nch, N), dtype=torch.float32, device=dev)
        lib = _kernels()
        fn = (lib.forest_eval_pred_u8 if predT.dtype == torch.uint8
              else lib.forest_eval_pred_bf16)
        with torch.cuda.device(dev):
            _raise_on(fn(predT.data_ptr(), N, nch, TCM, TCL, tree_chunk,
                         nodes_per_tree, paths.data_ptr(), paths.shape[1],
                         csQc.data_ptr(), plenc.data_ptr(), outwc.data_ptr(),
                         part.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream), name)
        forest_eval_pred.launches += 1
    return out


forest_eval_pred.launches = 0
