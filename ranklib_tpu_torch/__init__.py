"""ranklib_tpu_torch — the PyTorch/CUDA port of ranklib_tpu for one NVIDIA H100.

The JAX package ``ranklib_tpu`` beside this one is the reference: every
module here sits at the same relative path as its counterpart there and is
held to its answers by the ``tests/test_torch_*.py`` files.

This package imports ``torch`` and never ``jax`` or ``ranklib_tpu``; the
host-side modules it needs (LETOR parsing, datasets, errors, logging, the
native C++ parser and binner in ``native/``) are carried as its own copies.

Ported so far: all ten rankers — training (with ``-norm``, ``-qrel``,
``-kcv`` and the extensions ``-resume``, ``-ckpt``, ``-eventlog``,
``-profile``), saving, loading, ``-test``/``-rank`` and ``-combine`` — on
dense LETOR files and with ``-sparse``; ``-dp`` for the tree rankers
(``parallel.dist``); ``-ana``, the ``features_tool`` and the library API
(``api``). Every Pallas kernel of the reference has a hand-written CUDA
counterpart in ``csrc/`` (forest evaluation, histograms, the split scan,
the fused lambdas, the compiler probes in ``tools.probes``). ``-dp`` for
the other rankers is a later slice.
"""

__version__ = "0.1.0"
