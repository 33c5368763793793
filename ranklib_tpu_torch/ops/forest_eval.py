"""Bin-space forest evaluation: the serving hot path's two CUDA kernels.

Kernels (``csrc/forest_eval.cu``, built for ``sm_90a`` by ``ops._build``):

* :func:`forest_eval_frombins` replaces ``ranklib_tpu/ops/forest_eval.py``
  ``_forest_frombins_kernel`` (wrapper ``forest_eval_pallas_frombins``):
  scores documents whose ids were binned on the host (``binsT [F, N]``
  uint8/int16). The route ``TreeEnsemble.eval_matrix`` takes.
* :func:`forest_eval_bins` replaces ``_forest_bins_kernel`` (wrapper
  ``forest_eval_pallas_bins``): bins ``X [N, F]`` f32 on the device
  (``#{grid_f < x}``, NaN → n_grid), then scores. The device-resident route.

Both route a document left iff ``bin <= nodebin`` and sum ``w·leaf``. The
TPU kernels express that as one-hot selection and path matmuls for the
MXU; the CUDA kernels walk each tree from the root, one thread per
document, over per-node records packed once per model (bound on the H100
by dependent L1/L2 loads and warp divergence, not HBM; the document's bins
are staged in shared memory once per block — see the .cu header).

Beside each kernel, a plain PyTorch version of the same function takes the
reference's ``_pack_matmul_bins`` operands and mirrors
``_bins_selection_epilogue``: gather, compare, P−Q path product, leaf fold.
Routing is integer-exact in both; the kernel and the plain version also add
the leaf values in the same f32 order (tree order, one partial per chunk of
trees), so they agree bit for bit.

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

# Largest n_grid the ported kernels take: the reference routes models with
# more distinct thresholds on one feature to forest_eval_pallas_full (the
# f32 route), which is not ported yet.
MAX_GRID = 256
# Widest input the kernels take: 32 docs x F int16 bins must fit the 227 KB
# of shared memory a block can use.
MAX_FEATURES = 232448 // (32 * 2)


@dataclass(frozen=True, eq=False)
class ForestPack:
    """One model's device operands for the bin-space kernels, built by
    ``TreeEnsemble.forest_pack`` (all tensors on one device).

    The reference's ``_pack_matmul_bins`` layout feeds the plain versions:
    ``grid [F, Bm]`` f32 (+inf padded), ``fid_full``/``nodebin_full``
    ``[nch·TCM]``, ``PmQc [nch, TCM, TCL]``, ``csQc``/``plenc``/``outwc``
    ``[nch, TCL]`` with TCL = tree_chunk·L. The traversal layout feeds the
    kernels: ``nodes [S, 4]`` int32 (feature or −1 at a leaf, node bin,
    left, right — absolute slot indices), ``values [S]`` f32 (w·output at
    leaves, 0 elsewhere), ``roots [T]`` int32."""

    n_features: int
    n_grid: int
    tree_chunk: int
    max_depth: int
    grid: torch.Tensor
    fid_full: torch.Tensor
    nodebin_full: torch.Tensor
    PmQc: torch.Tensor
    csQc: torch.Tensor
    plenc: torch.Tensor
    outwc: torch.Tensor
    nodes: torch.Tensor
    values: torch.Tensor
    roots: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def matmul_operands(self):
        """(fid_full, nodebin_full, PmQc, csQc, plenc, outwc)."""
        return (self.fid_full, self.nodebin_full, self.PmQc, self.csQc,
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


def _bins_selection_epilogue(bins, fid, nodebin, PmQ, plen_adj, outw,
                             tree_chunk: int) -> torch.Tensor:
    """Selection + leaf fold over int32 ids ``bins [F, N]`` (ref
    ``_bins_selection_epilogue``, :244): per tree chunk, gather each
    node's feature ids, compare with the node bin, count path agreements
    with one P−Q product (small integers, exact in f32), and add the
    output of the one leaf each tree's path reaches. Leaf values add in
    tree order, one partial per chunk — the kernels' order."""
    N = bins.shape[1]
    score = torch.zeros(N, dtype=torch.float32, device=bins.device)
    for c in range(PmQ.shape[0]):
        vals = bins.index_select(0, fid[c])                  # [TCM, N]
        pred = (vals <= nodebin[c][:, None]).to(torch.float32)
        hits = pred.T @ PmQ[c]                               # [N, TCL]
        contrib = torch.where(hits == plen_adj[c], outw[c], 0.0)
        per_tree = contrib.view(N, tree_chunk, -1).sum(dim=2)  # one leaf each
        partial = torch.zeros_like(score)
        for j in range(tree_chunk):
            partial = partial + per_tree[:, j]
        score = score + partial
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
    walk = [_vp, _vp, _vp, _int, _int, _int, _vp, _vp]
    for fn in (lib.forest_eval_frombins_u8, lib.forest_eval_frombins_i16):
        fn.argtypes = [_vp, _i64, _int, *walk]
        fn.restype = _int
    lib.forest_eval_bins.argtypes = [_vp, _i64, _int, _vp, _int, _int, *walk]
    lib.forest_eval_bins.restype = _int
    return lib


def _check_device(x: torch.Tensor, pack: ForestPack, name: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise RankLibError(f"{name}: tensors on {x.device} are not supported")
    if pack.device != x.device:
        raise RankLibError(f"{name}: input on {x.device} but the model's "
                           f"pack on {pack.device}")
    return x.device.type == "cuda"


def _walk_args(pack: ForestPack, out: torch.Tensor):
    return (pack.nodes.data_ptr(), pack.values.data_ptr(),
            pack.roots.data_ptr(), int(pack.roots.shape[0]),
            pack.max_depth, pack.tree_chunk, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)


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
            _raise_on(fn(binsT.data_ptr(), N, F, *_walk_args(pack, out)),
                      name)
        forest_eval_frombins.launches += 1
    return out


forest_eval_frombins.launches = 0


def forest_eval_bins(X: torch.Tensor, pack: ForestPack) -> torch.Tensor:
    """Scores ``[N]`` f32 of device-resident features ``X [N, F]``
    (contiguous f32), binned on the device against ``pack``'s grid."""
    name = "forest_eval_bins"
    if X.dtype != torch.float32:
        raise RankLibError(f"{name}: features must be float32, got {X.dtype}")
    if X.dim() != 2 or X.shape[1] != pack.n_features:
        raise RankLibError(f"{name}: features must be [N, {pack.n_features}], "
                           f"got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise RankLibError(f"{name}: features must be contiguous")
    if not _check_device(X, pack, name):
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
                *_walk_args(pack, out)), name)
        forest_eval_bins.launches += 1
    return out


forest_eval_bins.launches = 0
