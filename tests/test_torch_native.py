"""The port's own native LETOR parser and binner (``ranklib_tpu_torch/
native/``) against the reference's loader.

* A copy of ``ranklib_tpu_torch/`` alone, with no ``ranklib_tpu/`` beside
  it, parses a fixture natively in a subprocess: the native path runs (the
  Python parser is made to raise), the library is built from the copy's
  own sources into the copy's ``_build/``, and no file under a
  ``ranklib_tpu/`` directory is opened or handed to a compiler.
* Every bound entry point gives the reference's arrays on the same files:
  the dense parse, the three streamed ``-sparse`` passes, the descriptions
  pass, the CSR parse, the capped uniques and both binners, gzip
  decompression, and the same errors on malformed and oversized input.
"""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ranklib_tpu.native import loader as R
from ranklib_tpu_torch.native import loader as P
from tests.fixtures import synth_dataset, write_letor_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def letor(tmp_path_factory):
    """A dense fixture with '#' descriptions and a sparse one (a third of
    the pairs left out, a duplicated fid, a negative value)."""
    d = tmp_path_factory.mktemp("native")
    dense = str(d / "dense.txt")
    write_letor_text(synth_dataset(n_queries=9, n_features=7, seed=4), dense)
    rng = np.random.default_rng(5)
    ds = synth_dataset(n_queries=11, n_features=12, min_docs=3, max_docs=9,
                       seed=6)
    sparse = str(d / "sparse.txt")
    with open(sparse, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                keep = rng.random(12) >= 0.35
                toks = [f"{j + 1}:{q.feats[i, j]:.6g}" for j in range(12)
                        if keep[j]]
                f.write(f"{int(q.labels[i])} qid:{q.qid} {' '.join(toks)} "
                        f"# d{q.qid}_{i}\n")
        f.write("1 qid:x 2:-1.5 2:0.25 5:3 # dup\n")
    return {"dense": dense, "sparse": sparse}


def test_port_parses_natively_without_the_reference(tmp_path, letor):
    root = tmp_path / "alone"
    shutil.copytree(os.path.join(REPO, "ranklib_tpu_torch"),
                    root / "ranklib_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes)):\n"
        "        seen.append(str(args[0]))\n"
        "    elif event == 'ctypes.dlopen':\n"
        "        seen.append(str(args[0]))\n"
        "    elif event == 'subprocess.Popen':\n"
        "        seen.extend(str(a) for a in args[1])\n"
        "sys.addaudithook(hook)\n"
        "sys.modules['jax'] = None\n"
        "import ranklib_tpu_torch.data.letor as L\n"
        "from ranklib_tpu_torch.data.binned import read_letor_binned\n"
        "from ranklib_tpu_torch.data.sparse import read_letor_sparse\n"
        "from ranklib_tpu_torch.native import loader\n"
        "def no_python(*a, **k):\n"
        "    raise AssertionError('the Python parser ran')\n"
        "L._parse_line = no_python\n"
        f"ds = L.read_letor({letor['dense']!r})\n"
        "assert ds.n_features == 7 and len(ds.queries) == 9\n"
        f"bd = read_letor_binned({letor['sparse']!r}, quiet=True)\n"
        f"cs = read_letor_sparse({letor['sparse']!r}, quiet=True)\n"
        "assert bd.binned.shape[0] == cs.n_docs\n"
        "libs = [l._name for l in (loader._parser_lib(), "
        "loader._binner_lib())]\n"
        "here = loader._DIR.rsplit('/native', 1)[0]\n"
        "assert all(l.startswith(here + '/_build/') for l in libs), libs\n"
        "bad = [p for p in seen if '/ranklib_tpu/' in p]\n"
        "assert not bad, bad\n"
        "assert any(p.endswith('/native/letor_parser.cpp') for p in seen)\n"
        "mods = [m for m in sys.modules if m == 'ranklib_tpu' "
        "or m.startswith(('ranklib_tpu.', 'jax.'))]\n"
        "assert not mods, mods\n"
        "print('OK', here)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=str(root))
    assert proc.returncode == 0, proc.stderr
    assert (proc.stdout.splitlines()[-1].split()
            == ["OK", str(root / "ranklib_tpu_torch")])
    assert not os.path.exists(root / "ranklib_tpu")
    assert any(n.startswith("letor_parser-") and n.endswith(".so")
               for n in os.listdir(root / "ranklib_tpu_torch" / "_build"))


def _same(a, b):
    assert type(a) is type(b) or (a is None) == (b is None)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _same_uniques(got, want, cap):
    """(vals, counts, minmax): only each feature's first counts[f] values
    are defined (in hash order, which both builds share)."""
    _same(got[1:], want[1:])
    for f, c in enumerate(want[1]):
        _same(got[0][f, :min(int(c), cap)], want[0][f, :min(int(c), cap)])


def _grid(path):
    feats = R.native_parse_letor(path)[1]
    return feats, R.native_feature_uniques(feats, 16)


@pytest.mark.parametrize("which", ["dense", "sparse"])
@pytest.mark.parametrize("entry", [
    "parse", "stat", "value_stats", "fill_binned", "descs", "csr",
    "uniques", "bin_i32", "bin_u8_T", "bin_i16_T",
])
def test_entry_points_match_the_reference(letor, which, entry):
    path = letor[which]
    if entry == "parse":
        got, want = P.native_parse_letor(path), R.native_parse_letor(path)
        # the reference's 7-tuple: descs as a list, max_fid the file's own
        _same(got, want)
    elif entry == "stat":
        _same(P.native_letor_stat(path), R.native_letor_stat(path))
    elif entry == "value_stats":
        F = R.native_letor_stat(path)[2]
        for cap in (4, 16, 256):
            _same_uniques(P.native_letor_value_stats(path, F, cap),
                          R.native_letor_value_stats(path, F, cap), cap)
    elif entry == "fill_binned":
        n, q, F = R.native_letor_stat(path)
        vals, counts, minmax = R.native_letor_value_stats(path, F, 8)
        from ranklib_tpu.gbdt.binning import thresholds_from_uniques
        thr, _ = thresholds_from_uniques(vals, counts, minmax, 8)
        _same(P.native_parse_letor_binned(path, thr, n, q),
              R.native_parse_letor_binned(path, thr, n, q))
    elif entry == "descs":
        n = R.native_letor_stat(path)[0]
        _same(P.native_letor_descs(path, n), R.native_letor_descs(path, n))
    elif entry == "csr":
        _same(P.native_parse_letor_csr(path),
              R.native_parse_letor_csr(path))
    else:
        feats, (vals, counts, minmax) = _grid(path)
        from ranklib_tpu.gbdt.binning import thresholds_from_uniques
        thr, _ = thresholds_from_uniques(vals, counts, minmax, 16)
        if entry == "uniques":
            _same_uniques(P.native_feature_uniques(feats, 16),
                          (vals, counts, minmax), 16)
        elif entry == "bin_i32":
            _same(P.native_bin_features(feats, thr),
                  R.native_bin_features(feats, thr))
        else:
            dt = np.uint8 if entry == "bin_u8_T" else np.int16
            _same(P.native_bin_features_transposed(feats, thr, 16, dt),
                  R.native_bin_features_transposed(feats, thr, 16, dt))


def test_gunzip_and_errors_match_the_reference(tmp_path, letor):
    gz = str(tmp_path / "s.txt.gz")
    with open(letor["sparse"], "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    for mod in (P, R):
        out = mod.gunzip_to_temp(gz)
        try:
            with open(out, "rb") as f, open(letor["sparse"], "rb") as g:
                assert f.read() == g.read()
        finally:
            os.unlink(out)
    bad = tmp_path / "bad.gz"
    bad.write_bytes(b"not gzip")
    from ranklib_tpu_torch.utils.errors import RankLibError
    with pytest.raises(RankLibError, match="cannot decompress"):
        P.gunzip_to_temp(str(bad))

    malformed = tmp_path / "malformed.txt"
    malformed.write_text("1 qid:1 1:0.5\nxyz 3:4\n")
    oversized = tmp_path / "oversized.txt"
    oversized.write_text(f"1 qid:{'q' * 80} 1:0.5\n")
    for path in (str(malformed), str(oversized)):
        for fn in ("native_parse_letor", "native_letor_stat",
                   "native_parse_letor_csr"):
            with pytest.raises(R.NativeParseError):
                getattr(R, fn)(path)
            with pytest.raises(P.NativeParseError):
                getattr(P, fn)(path)
    assert P.native_parse_letor(gz) is None         # gzip: Python parser
    assert P.native_letor_stat(str(tmp_path / "missing.txt")) is None
