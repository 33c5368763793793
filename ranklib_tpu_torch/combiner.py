"""Combiner: merge bagged tree models from a directory into one Random
Forests model (copy of ranklib_tpu.combiner; ref: learning/Combiner.java:~20
— train bags on separate machines, combine offline).

CLI: ``-combine <dir> -o <output model file>``. Every file of the
directory (sorted by name) that holds ``<ensemble>`` blocks contributes
them in order; the output's bags keep their trees and weights.
"""

from __future__ import annotations

import os

from ranklib_tpu_torch.models.base import model_header
from ranklib_tpu_torch.models.rf import parse_ensembles
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log


def combine(directory: str, out_path: str) -> None:
    if not os.path.isdir(directory):
        raise RankLibError(f"Not a directory: {directory}")
    blocks = []
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            text = f.read()
        ensembles = parse_ensembles(text)
        if not ensembles:
            log(f"Skipping {name} (no <ensemble> blocks)")
            continue
        blocks.extend(e.to_text() for e in ensembles)
        log(f"Combined {len(ensembles)} ensemble(s) from {name}")
    if not blocks:
        raise RankLibError(f"No tree models found in {directory}")
    head = model_header("Random Forests", {"No. of bags": len(blocks)})
    with open(out_path, "w") as f:
        f.write(head + "\n" + "\n".join(blocks))
    log(f"Combined model saved to: {out_path}")
