"""The port's copy of the FeatureManager tool (``python -m
ranklib_tpu_torch.features_tool``) against the reference's
(ranklib_tpu.features_tool): byte-equal output files under the same seed
for k-fold partitions, ``-tvs`` carve-outs, ``-shuffle`` and
shuffle-then-partition, the same exit codes on errors, and the ``python
-m`` entry point."""

import os
import subprocess
import sys

import pytest

from ranklib_tpu.features_tool import main as ref_main
from ranklib_tpu_torch.features_tool import main as port_main
from ranklib_tpu_torch.features_tool import read_query_groups
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset, write_letor_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def letor_file(tmp_path_factory):
    ds = synth_dataset(n_queries=11, n_features=5, min_docs=2, max_docs=6,
                       seed=7, w_seed=3)
    p = tmp_path_factory.mktemp("ftool") / "data.txt"
    write_letor_text(ds, p)
    with open(p, "a") as f:
        f.write("\n# a comment line\n")
    return str(p)


def _tree(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("args", [
    ["-k", "3"], ["-k", "4", "-tvs", "0.7"], ["-shuffle", "-seed", "5"],
    ["-shuffle", "-seed", "1", "-k", "2"],
    ["-shuffle", "-seed", "2", "-k", "3", "-tvs", "0.5"],
], ids=["kfold", "kfold-tvs", "shuffle", "shuffle-kfold",
        "shuffle-kfold-tvs"])
def test_files_byte_equal_to_reference(letor_file, tmp_path, args):
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-input", letor_file, "-output",
                     str(tmp_path / name), *args]) == 0
    want = _tree(tmp_path / "ref")
    assert want and _tree(tmp_path / "port") == want


def test_errors_and_entry_point(letor_file, tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 nofid:3 1:0.5\n")
    with pytest.raises(RankLibError):
        read_query_groups(str(bad))
    for main in (ref_main, port_main):
        assert main(["-input", letor_file, "-output", str(tmp_path / "e"),
                     "-k", "99"]) == 1
        with pytest.raises(SystemExit):
            main(["-input", letor_file, "-output", str(tmp_path / "e2")])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None; import runpy; "
         "sys.argv = ['features_tool', '-input', sys.argv[1], '-output', "
         "sys.argv[2], '-k', '2']; "
         "runpy.run_module('ranklib_tpu_torch.features_tool', "
         "run_name='__main__')", letor_file, str(tmp_path / "cli")],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path / "cli")) == [
        "f1.test.data.txt", "f1.train.data.txt", "f2.test.data.txt",
        "f2.train.data.txt"]
