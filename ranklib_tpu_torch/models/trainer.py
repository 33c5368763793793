"""Training harness (ranklib_tpu.models.trainer; ref:
learning/RankerTrainer.java:~20): create the ranker from ``-ranker N`` and
its hyperparameters, warm-start it from ``-resume``, fit it on an explicit
device (or a ``-dp`` mesh), under ``-profile`` inside the profiler, and
print the wall-clock training time, the reference's only profiling output.
"""

from __future__ import annotations

import contextlib
import inspect
import time

import torch

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import (
    Ranker, get_ranker_class, load_ranker_file,
)
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log


@contextlib.contextmanager
def profiled(profile_dir: str, device: torch.device,
             worker: str | None = None):
    """``torch.profiler`` over the block — CPU activity, and the card's
    when ``device`` is one — its trace written into ``profile_dir`` as
    ``<worker>.<time>.pt.trace.json`` (TensorBoard's layout)."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
            profile_dir, worker_name=worker)):
        yield


def train_ranker(ranker_type, train: Dataset, scorer: MetricScorer,
                 validation: Dataset | None, hparams: dict | None,
                 device: torch.device, feature_mask=None, n_dp: int = 0,
                 profile_dir: str | None = None) -> Ranker:
    """``hparams["_resume_from"]`` (``-resume``): a saved model of the
    same tree ranker whose trees the fit continues. ``feature_mask``
    (``-feature`` on the streamed ``-sparse`` path, a tree ranker's)
    reaches the fit as a split mask: for trees exactly the dense
    pipeline's column zeroing. ``n_dp > 1``: data-parallel over that many
    devices (``parallel.dist.make_mesh``; in a process that joined a group,
    over its processes) for every ranker whose ``fit`` takes a ``mesh``;
    Linear Regression has none and logs the reference's line.
    ``profile_dir``: the fit runs inside :func:`profiled` (a joined
    process's trace is named after its rank)."""
    hparams = dict(hparams or {})
    resume = hparams.pop("_resume_from", None)
    ranker = get_ranker_class(ranker_type)(**hparams)
    if resume:
        loaded = load_ranker_file(resume)
        if type(loaded) is not type(ranker):
            raise RankLibError(
                f"-resume model is a {loaded.NAME}, not a {ranker.NAME}")
        if not hasattr(loaded, "ensemble"):
            raise RankLibError(
                f"-resume is only supported for tree rankers "
                f"(got {ranker.NAME})")
        ranker.ensemble = loaded.ensemble      # warm start (tree rankers)
    kwargs = {} if feature_mask is None else {"feature_mask": feature_mask}
    worker = None
    if n_dp and n_dp > 1:
        if "mesh" in inspect.signature(ranker.fit).parameters:
            from ranklib_tpu_torch.parallel.dist import make_mesh

            mesh = make_mesh(n_dp, device)
            if mesh.joined:
                # this process is a rank: the trace below is its trace
                worker = f"rank{torch.distributed.get_rank()}"
            kwargs.update(mesh=mesh,
                          profile_dir=None if mesh.joined else profile_dir)
        else:
            log(f"({ranker.NAME} has no data-parallel path; -dp ignored)")
    t0 = time.perf_counter()
    with (profiled(profile_dir, device, worker) if profile_dir
          else contextlib.nullcontext()):
        ranker.fit(train, scorer, validation, device=device, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if profile_dir:
        log(f"Profiler trace written to: {profile_dir}")
    log("")
    log(f"Training time: {time.perf_counter() - t0:.2f} seconds")
    return ranker

