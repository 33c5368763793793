"""Flat tree ensembles: RankLib model-file format and serving
(ranklib_tpu.gbdt.ensemble).

Trees are flat slot arrays (feature/threshold/left/right/output per node);
the model file is the reference's ``<ensemble><tree id=.. weight=..>
<split>…`` XML (ref: learning/tree/Ensemble.java:~100, Split.java), with
1-indexed fids. Scoring is ``Σ_t w_t · tree_t(x)`` (ref: Ensemble.eval).

All host-side packing and text formatting stays in numpy, so the packs are
bit-identical to the reference's and the file bytes match; tensors start
at the device boundary (:meth:`TreeEnsemble.forest_pack`).

Serving routes (:meth:`TreeEnsemble.eval_matrix`), chosen by
:meth:`TreeEnsemble.serving_route`:

* host-binned — bin on the host against the model's own threshold grid
  (native binner), upload uint8/int16 ids, :func:`forest_eval_frombins`;
* device-resident — :meth:`TreeEnsemble._device_eval_fn`, which bins on
  the device inside :func:`forest_eval_bins`;
* f32 — :func:`forest_eval_full`, the test ``x <= threshold`` itself, for
  models the bin-space kernels do not take (more than 256 thresholds on a
  feature, or more than ``MAX_FEATURES`` columns);
* split — with ``RANKLIB_TPU_SERVE_SPLIT=1`` (the reference's opt-in) and a
  model the bin-space kernels take, :func:`forest_eval_bins_split`: a
  device binning pass writes the ids, the frombins kernel scores them. The
  flag wins over the host-binned route in :meth:`TreeEnsemble.eval_matrix`.

Each route runs its CUDA kernel on the card and its plain version on the
CPU.
"""

from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ranklib_tpu_torch.ops.forest_eval import (
    MAX_FEATURES, MAX_GRID, ForestPack, FullPack, forest_eval_bins,
    forest_eval_bins_split, forest_eval_frombins, forest_eval_full,
)
from ranklib_tpu_torch.utils.errors import RankLibError

# the reference's opt-in for the split bin-space route
SERVE_SPLIT_ENV = "RANKLIB_TPU_SERVE_SPLIT"


class Tree:
    """One tree in flat-slot form (host numpy). Slot 0 = root."""

    __slots__ = ("feature", "threshold", "left", "right", "is_leaf", "output")

    def __init__(self, feature, threshold, left, right, is_leaf, output):
        self.feature = np.asarray(feature, np.int32)      # 0-based column
        self.threshold = np.asarray(threshold, np.float32)
        self.left = np.asarray(left, np.int32)
        self.right = np.asarray(right, np.int32)
        self.is_leaf = np.asarray(is_leaf, bool)
        self.output = np.asarray(output, np.float32)

    @property
    def n_slots(self):
        return len(self.feature)

    def depth(self) -> int:
        best = 0
        stack = [(0, 0)]                  # iterative: chain trees can
        while stack:                      # exceed the recursion limit
            node, d = stack.pop()
            if self.is_leaf[node]:
                best = max(best, d)
            else:
                stack.append((int(self.left[node]), d + 1))
                stack.append((int(self.right[node]), d + 1))
        return best


class TreeEnsemble:
    """List of (Tree, weight); weight = learning rate for boosted models
    (ref: Ensemble.add(tree, learningRate))."""

    # Trees per chunk of the matmul pack (the reference's value, so the
    # packs are bit-identical) and per f32 partial sum in the kernels.
    _TREE_CHUNK = 25
    # Docs per device call of the kernels, and of the plain f32 route on
    # the CPU, which materializes a [TC·M, chunk] predicate block per tree
    # chunk.
    _KERNEL_CHUNK = 1 << 20
    _EVAL_CHUNK = 1 << 14
    # Bytes of host-binned ids per upload in the host-binned route.
    _SERVE_CHUNK_BYTES = 8 << 20

    def __init__(self):
        self.trees: list[Tree] = []
        self.weights: list[float] = []
        self._invalidate()

    def _invalidate(self):
        self._mm = None
        self._mmb = None
        self._walk = None
        self._splits = None
        self._bins_meta = None
        self._gridnp = None
        self._dev_packs = {}

    def add(self, tree: Tree, weight: float):
        self.trees.append(tree)
        self.weights.append(float(weight))
        self._invalidate()

    def truncate(self, n: int):
        """Keep the first n trees (ref: LambdaMART learn() post-loop
        truncation)."""
        self.trees = self.trees[:n]
        self.weights = self.weights[:n]
        self._invalidate()

    def __len__(self):
        return len(self.trees)

    def to_bin_space(self, thresholds: np.ndarray) -> "TreeEnsemble":
        """This ensemble with every split threshold t on feature f rewritten
        to its bin id ``b = searchsorted(thresholds[f], t, 'left')`` (ref
        ``to_bin_space``, :90), so that it scores a bin matrix exactly:
        ``value <= t ⟺ bin <= b`` whenever t is a grid point, as it is for
        every model trained on this grid (the streamed ``-sparse`` data
        keeps no raw values). Raises RankLibError when a split threshold
        is off the grid (a model trained elsewhere)."""
        out = TreeEnsemble()
        B = thresholds.shape[1]
        for tree, w in zip(self.trees, self.weights):
            split = ~tree.is_leaf
            rows = thresholds[tree.feature]                  # [S, B]
            b = (rows < tree.threshold[:, None]).sum(axis=1)  # lower_bound
            on_grid = np.take_along_axis(
                rows, np.minimum(b, B - 1)[:, None], axis=1
            )[:, 0] == tree.threshold
            if not np.all(on_grid[split] & (b[split] < B)):
                raise RankLibError(
                    "ensemble has split thresholds off the binning grid; "
                    "bin-space evaluation needs a model trained with this "
                    "grid (use the dense pipeline instead)")
            thr = np.where(split, b.astype(np.float32), 0.0)
            out.add(Tree(tree.feature, thr, tree.left, tree.right,
                         tree.is_leaf, tree.output), w)
        return out

    # ---- packs (host numpy) ------------------------------------------------

    def _nodes_per_tree(self) -> int:
        """M of the matmul packs: the most internal nodes of any tree (at
        least 1), the P−Q rows each tree owns in a chunk."""
        return int(max(max((~t.is_leaf).sum(), 1) for t in self.trees))

    def _pack_matmul(self, n_features: int):
        """(fid_full, thr_full, PmQc, csQc, plenc, outwc): the reference's
        matmul-path pack (ref ``_pack_matmul``, :157), bit-identical. Per
        leaf, P/Q mark the internal nodes whose test must be true/false on
        its root path; trees go in chunks of TC with block-diagonal P/Q;
        each chunk's node rows pad to a multiple of 16 (dead rows: fid 0,
        thr 0, zero P/Q rows)."""
        key = ("mm", n_features)
        if self._mm is None or self._mm[0] != key:
            M = self._nodes_per_tree()
            L = max(t.is_leaf.sum() for t in self.trees)
            TC = self._TREE_CHUNK
            Tp = ((len(self.trees) + TC - 1) // TC) * TC
            fid = np.zeros((Tp, M), np.int32)
            thr = np.zeros((Tp, M), np.float32)
            P = np.zeros((Tp, M, L), np.float32)
            Q = np.zeros((Tp, M, L), np.float32)
            plen = np.full((Tp, L), -1.0, np.float32)   # pads never match
            outw = np.zeros((Tp, L), np.float32)
            for ti, (t, w) in enumerate(zip(self.trees, self.weights)):
                internal = np.flatnonzero(~t.is_leaf)
                slot_of = {int(n): i for i, n in enumerate(internal)}
                for i, n in enumerate(internal):
                    fid[ti, i] = t.feature[n]
                    thr[ti, i] = t.threshold[n]
                li = 0
                stack = [(0, [])]             # DFS collecting (leaf, path)
                while stack:
                    node, path = stack.pop()
                    if t.is_leaf[node]:
                        for m, left in path:
                            (P if left else Q)[ti, slot_of[m], li] = 1.0
                        plen[ti, li] = len(path)
                        outw[ti, li] = t.output[node] * w
                        li += 1
                    else:
                        stack.append((int(t.right[node]),
                                      path + [(node, False)]))
                        stack.append((int(t.left[node]),
                                      path + [(node, True)]))
            nch = Tp // TC
            TCM = ((TC * M + 15) // 16) * 16
            fid_full = np.zeros((nch * TCM,), np.int32)
            thr_full = np.zeros((nch * TCM,), np.float32)
            Pc = np.zeros((nch, TCM, TC * L), np.float32)
            Qc = np.zeros((nch, TCM, TC * L), np.float32)
            plenc = np.full((nch, TC * L), -1.0, np.float32)
            outwc = np.zeros((nch, TC * L), np.float32)
            for c in range(nch):
                for j in range(TC):
                    ti = c * TC + j
                    col = c * TCM + j * M
                    fid_full[col: col + M] = fid[ti]
                    thr_full[col: col + M] = thr[ti]
                    Pc[c, j * M:(j + 1) * M, j * L:(j + 1) * L] = P[ti]
                    Qc[c, j * M:(j + 1) * M, j * L:(j + 1) * L] = Q[ti]
                    plenc[c, j * L:(j + 1) * L] = plen[ti]
                    outwc[c, j * L:(j + 1) * L] = outw[ti]
            self._mm = (key, (fid_full, thr_full, Pc - Qc, Qc.sum(axis=1),
                              plenc, outwc))
        return self._mm[1]

    def _pack_matmul_bins(self, n_features: int):
        """(grid, fid_full, nodebin, PmQc, csQc, plenc, outwc, n_grid): the
        bin-space pack (ref ``_pack_matmul_bins``, :224), bit-identical —
        the matmul pack plus the model's own per-feature threshold grid and
        each node's threshold as its index in that grid (an exact f32
        compare; every threshold is a grid point)."""
        key = ("mmb", n_features)
        if self._mmb is None or self._mmb[0] != key:
            fid_full, thr_full, PmQc, csQc, plenc, outwc = (
                self._pack_matmul(n_features))
            _, Bm_real = self._bins_grid_meta()
            grid = self._model_grid_np(n_features)
            # dead pad rows (fid 0, thr 0) get an arbitrary bin: their P−Q
            # rows are zero
            nodebin = (grid[np.minimum(fid_full, n_features - 1)]
                       < thr_full[:, None]).sum(axis=1).astype(np.float32)
            self._mmb = (key, (grid, fid_full, nodebin, PmQc, csQc, plenc,
                               outwc), Bm_real)
        return self._mmb[1] + (self._mmb[2],)

    def _pack_walk(self, n_features: int, f32: bool = False):
        """(nodes [S, 4] int32, values [S] f32, roots [T] int32, max_depth):
        the per-slot traversal pack that :meth:`_pack_splits` turns into
        the kernels' split records. Every tree's slots are concatenated; a
        record is (feature or −1 at a leaf, node test, left, right) with
        absolute child slots. The node test is the node bin, or with
        ``f32`` the threshold's f32 bits. Node bins and leaf values come
        from the same expressions as the matmul packs, so kernel and plain
        version route and add identically. Raises when a split reads a
        feature at or past ``n_features`` or links outside its tree (the
        kernel would read out of bounds)."""
        key = ("walk", n_features, f32)
        if self._walk is None or self._walk[0] != key:
            grid = None if f32 else self._model_grid_np(n_features)
            nodes, values, roots = [], [], []
            base = 0
            for t, w in zip(self.trees, self.weights):
                n = t.n_slots
                split = ~t.is_leaf
                kids_ok = ((t.left >= 0) & (t.left < n) & (t.right >= 0)
                           & (t.right < n))
                if np.any(split & ((t.feature < 0)
                                   | (t.feature >= n_features) | ~kids_ok)):
                    raise RankLibError(
                        f"tree {len(roots) + 1}: a split reads a feature "
                        f"outside 1..{n_features} or links outside the tree")
                if f32:
                    test = t.threshold.astype(np.float32).view(np.int32)
                else:
                    fid = np.where(split, t.feature, 0)
                    test = (grid[fid] < t.threshold[:, None]).sum(axis=1)
                rec = np.zeros((n, 4), np.int32)
                rec[:, 0] = np.where(split, t.feature, -1)
                rec[:, 1] = np.where(split, test, 0)
                rec[:, 2] = np.where(split, t.left + base, 0)
                rec[:, 3] = np.where(split, t.right + base, 0)
                val = np.zeros(n, np.float32)
                for s in np.flatnonzero(t.is_leaf):
                    val[s] = t.output[s] * w
                nodes.append(rec)
                values.append(val)
                roots.append(base)
                base += n
            max_depth = max(t.depth() for t in self.trees)
            self._walk = (key, (np.concatenate(nodes), np.concatenate(values),
                                np.asarray(roots, np.int32), max_depth))
        return self._walk[1]

    def _pack_splits(self, n_features: int, f32: bool = False):
        """(splits [S, 4] int32, roots [T] int32, chunk_starts [nch + 1]
        int32): the split records every forest kernel walks, one per
        internal node and none for leaves, derived from :meth:`_pack_walk`
        (the same node tests, the same leaf values to the bit). A bin-space
        record is (feature, node bin | left-is-leaf << 16 | right-is-leaf <<
        17, left, right); with ``f32`` it is (feature | left-is-leaf << 30 |
        right-is-leaf << 31, the threshold's f32 bits, left, right), the
        test needing all 32 bits of its word. A child is a leaf's w·output
        as f32 bits, else its record's index counted from the first record
        of the tree's chunk of ``_TREE_CHUNK`` trees, and ``roots`` count
        the same way, so a chunk is one contiguous run ``chunk_starts[c] ..
        chunk_starts[c + 1]``. A one-leaf tree is one record whose children
        are both its leaf, both flagged, so any outcome of the test (NaN
        included) reaches it."""
        key = ("splits", n_features, f32)
        if self._splits is None or self._splits[0] != key:
            nodes, values, roots, _ = self._pack_walk(n_features, f32=f32)
            vbits = values.view(np.int32)
            ends = np.append(roots[1:], len(nodes))
            recs, troots, starts = [], np.zeros(len(roots), np.int32), []
            n = 0
            for t, (lo, hi) in enumerate(zip(roots, ends)):
                if t % self._TREE_CHUNK == 0:
                    starts.append(n)
                base = n - starts[-1]
                rec = nodes[lo:hi]
                split = rec[:, 0] >= 0
                troots[t] = base
                if not split[0]:                  # a one-leaf tree
                    rec = np.array([[0, 0 if f32 else 0xFFFF, -1, -1]],
                                   np.int32)
                    leaf = np.array([vbits[lo]])
                    flags = np.array([True])
                    recs.append(_split_records(rec, leaf, flags, leaf, flags,
                                               f32, t))
                    n += 1
                    continue
                idx = np.cumsum(split) - 1 + base  # record of each split slot

                def child(slots):
                    rel = slots - lo
                    return np.where(split[rel], idx[rel], vbits[slots]), \
                        ~split[rel]

                s = rec[split]
                recs.append(_split_records(s, *child(s[:, 2]),
                                           *child(s[:, 3]), f32, t))
                n += len(s)
            starts.append(n)
            self._splits = (key, (np.concatenate(recs), troots,
                                  np.asarray(starts, np.int32)))
        return self._splits[1]

    def _pack(self):
        """[T, M] traversal arrays of :func:`_ensemble_eval` (ref
        ``_pack``, :251): feat, thr, left, right, leaf, out, weights, depth."""
        T = len(self.trees)
        M = max(t.n_slots for t in self.trees)
        depth = max(t.depth() for t in self.trees) if T else 0
        feat = np.zeros((T, M), np.int32)
        thr = np.zeros((T, M), np.float32)
        lft = np.zeros((T, M), np.int32)
        rgt = np.zeros((T, M), np.int32)
        leaf = np.ones((T, M), bool)
        out = np.zeros((T, M), np.float32)
        for i, t in enumerate(self.trees):
            m = t.n_slots
            feat[i, :m] = t.feature
            thr[i, :m] = t.threshold
            lft[i, :m] = np.maximum(t.left, 0)
            rgt[i, :m] = np.maximum(t.right, 0)
            leaf[i, :m] = t.is_leaf
            out[i, :m] = t.output
        return (feat, thr, lft, rgt, leaf, out,
                np.asarray(self.weights, np.float32), depth)

    def _bins_grid_meta(self):
        """(per-feature unique split-threshold sets, max count), cached."""
        if self._bins_meta is None:
            uniq = {}
            for t in self.trees:
                for n in np.flatnonzero(~t.is_leaf):
                    uniq.setdefault(int(t.feature[n]), set()).add(
                        np.float32(t.threshold[n]))
            Bm_real = max((len(s) for s in uniq.values()), default=1)
            self._bins_meta = (uniq, Bm_real)
        return self._bins_meta

    def _model_grid_np(self, n_features: int) -> np.ndarray:
        """[F, Bm] model threshold grid (ref ``_model_grid_np``, :361):
        each feature's split thresholds sorted, +inf padded to a multiple
        of 128. Shared by the device pack and host binning."""
        uniq, Bm_real = self._bins_grid_meta()
        if self._gridnp is None or self._gridnp[0] != n_features:
            Bm = ((Bm_real + 127) // 128) * 128
            grid = np.full((n_features, Bm), np.inf, np.float32)
            for f, s in uniq.items():
                if f < n_features:
                    v = np.sort(np.asarray(list(s), np.float32))
                    grid[f, : len(v)] = v
            self._gridnp = (n_features, grid)
        return self._gridnp[1]

    # ---- serving -----------------------------------------------------------

    def _use_bins_kernel(self, n_features: int) -> bool:
        """True when the ported kernels take this model at this width: at
        most MAX_GRID distinct thresholds on any feature and at most
        MAX_FEATURES features (ref ``_use_bins_kernel``, :383, without its
        TPU VMEM estimate)."""
        return (self._bins_grid_meta()[1] <= MAX_GRID
                and n_features <= MAX_FEATURES)

    def forest_pack(self, n_features: int, device: torch.device) -> ForestPack:
        """The bin-space kernels' operands on ``device``, uploaded once per
        (width, device) and dropped by add/truncate."""
        key = ("bins", n_features, str(device))
        if key not in self._dev_packs:
            *mm, n_grid = self._pack_matmul_bins(n_features)
            grid, fid_full, nodebin, PmQc, csQc, plenc, outwc = mm
            dev = functools.partial(_upload, device=device)
            self._dev_packs[key] = ForestPack(
                n_features=n_features, n_grid=int(n_grid),
                tree_chunk=self._TREE_CHUNK,
                nodes_per_tree=self._nodes_per_tree(),
                grid=dev(grid), fid_full=dev(fid_full),
                nodebin_full=dev(nodebin), PmQc=dev(PmQc), csQc=dev(csQc),
                plenc=dev(plenc), outwc=dev(outwc),
                pred_paths=dev(_pred_paths(PmQc, self._TREE_CHUNK,
                                           self._nodes_per_tree())),
                **self._split_fields(n_features, False, dev))
        return self._dev_packs[key]

    def full_pack(self, n_features: int, device: torch.device) -> FullPack:
        """The f32 route's operands on ``device``, uploaded once per
        (width, device) and dropped by add/truncate."""
        key = ("f32", n_features, str(device))
        if key not in self._dev_packs:
            dev = functools.partial(_upload, device=device)
            fid_full, thr_full, PmQc, csQc, plenc, outwc = (
                self._pack_matmul(n_features))
            self._dev_packs[key] = FullPack(
                n_features=n_features, tree_chunk=self._TREE_CHUNK,
                nodes_per_tree=self._nodes_per_tree(),
                fid_full=dev(fid_full), thr_full=dev(thr_full),
                PmQc=dev(PmQc), csQc=dev(csQc), plenc=dev(plenc),
                outwc=dev(outwc),
                pred_paths=dev(_pred_paths(PmQc, self._TREE_CHUNK,
                                           self._nodes_per_tree())),
                **self._split_fields(n_features, True, dev))
        return self._dev_packs[key]

    def _split_fields(self, n_features: int, f32: bool, dev) -> dict:
        """The split-record fields both packs share, uploaded by ``dev``."""
        splits, roots, starts = self._pack_splits(n_features, f32=f32)
        return {"max_depth": int(self._pack_walk(n_features, f32=f32)[3]),
                "chunk_splits": int(np.diff(starts).max()),
                "splits": dev(splits), "split_roots": dev(roots),
                "chunk_starts": dev(starts)}

    def serving_route(self, n_features: int, device_type: str):
        """(route, docs per call) of the device-resident route for this
        model, input width and device type: ``"bins"`` when the bin-space
        kernels take the model (:meth:`_use_bins_kernel`) — ``"bins_split"``
        instead under ``RANKLIB_TPU_SERVE_SPLIT=1`` (ref ``_device_eval_fn``
        :434-445) — else ``"f32"`` (ref ``_device_eval_fn``, :425, whose TPU
        gates the port drops). A route runs its kernels on CUDA and its
        plain versions on the CPU; only the plain f32 version, which
        materializes a predicate block per tree chunk, takes smaller
        calls."""
        if self._use_bins_kernel(n_features):
            split = os.environ.get(SERVE_SPLIT_ENV) == "1"
            return ("bins_split" if split else "bins"), self._KERNEL_CHUNK
        return "f32", (self._EVAL_CHUNK if device_type == "cpu"
                       else self._KERNEL_CHUNK)

    def _device_eval_fn(self, n_features: int, device: torch.device):
        """(fn, chunk): fn maps a ``device``-resident [n, F] f32 tensor to
        scores [n] on the device, through :meth:`serving_route`."""
        route, chunk = self.serving_route(n_features, device.type)
        if route in ("bins", "bins_split"):
            pack = self.forest_pack(n_features, device)
            fn = (forest_eval_bins if route == "bins"
                  else forest_eval_bins_split)
            return (lambda X: fn(X, pack)), chunk
        pack = self.full_pack(n_features, device)
        return (lambda X: forest_eval_full(X, pack)), chunk

    def eval_matrix(self, feats: np.ndarray,
                    device: torch.device) -> np.ndarray:
        """feats [N, F] → scores [N] f32 = Σ_t w_t · tree_t(x), computed on
        ``device``: the host-binned route when the bin-space kernels take
        the model, else the device route of :meth:`serving_route` on
        uploaded features. ``RANKLIB_TPU_SERVE_SPLIT=1`` wins over the
        host-binned route (ref :468-475), so the split route is what runs."""
        feats = np.asarray(feats, np.float32)
        N, F = feats.shape
        if not self.trees or N == 0:
            return np.zeros(N, np.float32)
        if self.serving_route(F, device.type)[0] == "bins":
            return self._eval_matrix_hostbin(feats, device)
        fn, C = self._device_eval_fn(F, device)
        parts = [fn(torch.from_numpy(np.ascontiguousarray(feats[lo:lo + C]))
                    .to(device)) for lo in range(0, N, C)]
        return torch.cat(parts).cpu().numpy()

    def _eval_matrix_hostbin(self, feats: np.ndarray,
                             device: torch.device) -> np.ndarray:
        """Host-binned serving (ref ``_eval_matrix_hostbin``, :499) as a
        plain loop over chunks of ~_SERVE_CHUNK_BYTES of ids: bin against
        the model grid on the host (native binner: ``#{grid < x}``, clamped
        to n_grid, NaN → n_grid, narrowed and transposed in one pass; numpy
        fallback), upload the uint8 ids (int16 when n_grid == 256, whose
        ids reach 256), score with :func:`forest_eval_frombins`."""
        from ranklib_tpu_torch.gbdt.binning import bin_features
        from ranklib_tpu_torch.native.loader import (
            native_bin_features_transposed,
        )

        N, F = feats.shape
        pack = self.forest_pack(F, device)
        grid = self._model_grid_np(F)
        n_grid = pack.n_grid
        dt = np.uint8 if n_grid < 256 else np.int16
        C = max(1, self._SERVE_CHUNK_BYTES // (F * np.dtype(dt).itemsize))
        parts = []
        for lo in range(0, N, C):
            chunk = feats[lo:lo + C]
            binsT = native_bin_features_transposed(chunk, grid, n_grid, dt)
            if binsT is None:
                bins = bin_features(chunk, grid)
                np.minimum(bins, n_grid, out=bins)
                binsT = np.ascontiguousarray(bins.astype(dt).T)
            parts.append(forest_eval_frombins(
                torch.from_numpy(binsT).to(device), pack))
        return torch.cat(parts).cpu().numpy()

    # ---- text format ---------------------------------------------------------
    def to_text(self) -> str:
        lines = ["<ensemble>"]
        for i, (t, w) in enumerate(zip(self.trees, self.weights)):
            lines.append(f"\t<tree id=\"{i + 1}\" weight=\"{w}\">")
            lines.extend(_node_text(t, 0, 2))
            lines.append("\t</tree>")
        lines.append("</ensemble>")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_text(text: str) -> "TreeEnsemble":
        """Parse the reference's ensemble XML (tolerates whitespace in
        <feature>/<threshold>/<output> text, as RankLib emits)."""
        start = text.find("<ensemble>")
        if start < 0:
            raise RankLibError("No <ensemble> found in model text")
        end = text.find("</ensemble>") + len("</ensemble>")
        try:
            root = ET.fromstring(text[start:end])
        except ET.ParseError as e:
            raise RankLibError(f"Bad ensemble XML: {e}") from e
        ens = TreeEnsemble()
        for tree_el in root.findall("tree"):
            weight = float(tree_el.get("weight", "1.0"))
            split = tree_el.find("split")
            if split is None:
                raise RankLibError("<tree> without <split>")
            nodes = []
            _parse_split(split, nodes)
            ens.add(Tree(*map(list, zip(*nodes))), weight)
        return ens


def _split_records(s, left, lleaf, right, rleaf, f32: bool,
                   t: int) -> np.ndarray:
    """[n, 4] int32 split records of tree ``t``'s internal slot records
    ``s`` (feature, node test, ·, ·) with their children and leaf flags,
    in the bin-space or the f32 layout of :meth:`TreeEnsemble._pack_splits`.
    Raises when a field does not fit its bits."""
    out = np.empty((len(s), 4), np.int32)
    if f32:
        if np.any(s[:, 0] >= 1 << 30):
            raise RankLibError(f"tree {t + 1}: a feature past 2^30 - 1 does "
                               f"not fit an f32 split record")
        u = np.uint32
        out[:, 0] = (s[:, 0].astype(u) | lleaf.astype(u) << u(30)
                     | rleaf.astype(u) << u(31)).view(np.int32)
        out[:, 1] = s[:, 1]
    else:
        if np.any(s[:, 1] > 0xFFFF):
            raise RankLibError(f"tree {t + 1}: a node bin past 65535 does "
                               f"not fit a split record")
        out[:, 0] = s[:, 0]
        out[:, 1] = s[:, 1] | lleaf << 16 | rleaf << 17
    out[:, 2] = left
    out[:, 3] = right
    return out


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _pred_paths(PmQc: np.ndarray, tree_chunk: int, M: int) -> np.ndarray:
    """The predicate epilogue kernel's path records, from ``PmQc [nch, TCM,
    TCL]`` (tree j of a chunk owning rows ``j·M .. (j+1)·M`` and columns
    ``j·L .. (j+1)·L``): one int32 row a tree (``c·tree_chunk + j``) of
    ``R`` ints, a multiple of 4 — the ``L + 1`` offsets of its leaves'
    lists, the ``L`` counts of their P rows, then the lists: each leaf's
    rows ``m`` within the tree where P−Q is +1, ascending, then those where
    it is −1, ascending; zeros pad."""
    nch, _, TCL = PmQc.shape
    L = TCL // tree_chunk
    T = nch * tree_chunk
    c, col, row = np.nonzero(np.transpose(PmQc, (0, 2, 1)))
    neg = PmQc[c, row, col] < 0
    j, leaf = col // L, col % L
    tree = c * tree_chunk + j
    order = np.lexsort((row, neg, leaf, tree))
    tree, key, m = tree[order], (tree * L + leaf)[order], (row - j * M)[order]
    counts = np.bincount(key, minlength=T * L).reshape(T, L)
    npos = np.bincount(key, weights=~neg[order], minlength=T * L)
    offs = np.zeros((T, L + 1), np.int64)
    offs[:, 1:] = np.cumsum(counts, axis=1)
    R = (2 * L + 1 + int(offs[:, L].max(initial=0)) + 3) // 4 * 4
    paths = np.zeros((T, R), np.int32)
    paths[:, :L + 1] = offs
    paths[:, L + 1:2 * L + 1] = npos.reshape(T, L)
    first = np.concatenate([[0], np.cumsum(offs[:, L])])[tree]
    paths[tree, 2 * L + 1 + np.arange(len(m)) - first] = m
    return paths


def _node_text(t: Tree, node: int, indent: int, pos: str | None = None):
    """Explicit-stack DFS (chain trees can be deeper than the recursion
    limit). Thresholds print through numpy float32 ``str``, outputs as
    ``f"{float32:.15f}"`` — the reference's bytes."""
    lines = []
    stack = [("open", node, indent, pos)]
    while stack:
        kind, nd, ind, ps = stack.pop()
        tab = "\t" * ind
        if kind == "close":
            lines.append(f"{tab}</split>")
            continue
        attr = f" pos=\"{ps}\"" if ps else ""
        lines.append(f"{tab}<split{attr}>")
        if t.is_leaf[nd]:
            lines.append(f"{tab}\t<output> {t.output[nd]:.15f} </output>")
            lines.append(f"{tab}</split>")
        else:
            lines.append(
                f"{tab}\t<feature> {int(t.feature[nd]) + 1} </feature>")
            lines.append(f"{tab}\t<threshold> {t.threshold[nd]} </threshold>")
            stack.append(("close", nd, ind, None))
            stack.append(("open", int(t.right[nd]), ind + 1, "right"))
            stack.append(("open", int(t.left[nd]), ind + 1, "left"))
    return lines


def _text_of(el, tag: str) -> str:
    child = el.find(tag)
    if child is None or child.text is None or not child.text.strip():
        raise RankLibError(f"<split> with <feature> but no <{tag}> value")
    return child.text.strip()


def _parse_split(el, nodes) -> int:
    """<split> elements → flat node tuples (feature, threshold, left,
    right, is_leaf, output) in pre-order (parent, left subtree, right
    subtree); returns the root slot. Explicit work stack. A malformed
    split (missing child, feature, threshold or output, or a value that
    does not parse) raises RankLibError."""
    root_idx = len(nodes)
    stack = [el]
    order = []
    while stack:
        e = stack.pop()
        idx = len(nodes)
        nodes.append(None)
        order.append((e, idx))
        if e.find("feature") is not None:
            kids = {c.get("pos"): c for c in e.findall("split")}
            if "left" not in kids or "right" not in kids:
                raise RankLibError("Internal <split> missing left/right child")
            stack.append(kids["right"])
            stack.append(kids["left"])
    slot_of = {id(e): idx for e, idx in order}
    try:
        for e, idx in order:
            if e.find("feature") is not None:
                kids = {c.get("pos"): c for c in e.findall("split")}
                nodes[idx] = (int(_text_of(e, "feature")) - 1,
                              float(_text_of(e, "threshold")),
                              slot_of[id(kids["left"])],
                              slot_of[id(kids["right"])], False, 0.0)
            elif e.find("output") is not None:
                nodes[idx] = (0, 0.0, -1, -1, True,
                              float(_text_of(e, "output")))
            else:
                raise RankLibError(
                    "<split> with neither children nor <output>")
    except ValueError as err:
        raise RankLibError(f"Bad number in <split>: {err}") from None
    return root_idx


def _ensemble_eval(X: torch.Tensor, feat, thr, lft, rgt, leaf, out, w,
                   depth: int) -> torch.Tensor:
    """Plain pointer traversal (ref ``_ensemble_eval``, :784): per tree,
    all docs descend in lockstep for ``depth`` rounds of (gather the split
    feature, compare ``x <= t`` in f32, select child); leaves self-loop.
    X [N, F]; tree arrays [T, M] → Σ_t w_t · out_t[leaf] [N]."""
    N = X.shape[0]
    per_tree = []
    for f_, t_, l_, r_, lf_, o_ in zip(feat.long(), thr, lft.long(),
                                       rgt.long(), leaf, out):
        node = torch.zeros(N, dtype=torch.int64, device=X.device)
        for _ in range(depth):
            v = torch.gather(X, 1, f_[node][:, None])[:, 0]
            nxt = torch.where(v <= t_[node], l_[node], r_[node])
            node = torch.where(lf_[node], node, nxt)
        per_tree.append(o_[node])
    if not per_tree:
        return torch.zeros(N, dtype=torch.float32, device=X.device)
    return w @ torch.stack(per_tree)
