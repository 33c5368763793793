"""More ``-dp`` flows of the tree rankers with a rank that holds no query
(tests/test_torch_dp_empty_shards.py, whose fixtures these share), against
the reference's ``make_mesh(n)`` fits on the CPU: Random-Forests bags
smaller than the mesh, a warm start, and ``-kcv`` through the CLI.
"""

import pytest

from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import gbdt as PG
from ranklib_tpu_torch.models.gbdt import MART, LambdaMART
from ranklib_tpu_torch.models.rf import RFRanker
from ranklib_tpu_torch.parallel import dist
from tests.test_torch_dp_empty_shards import (  # noqa: F401 (fixtures)
    CPU, _as_read, _dataset, _every_rank_equal, _file, _port_defaults,
    _ref_dataset, _same_forest, rank_models,
)


@pytest.mark.parametrize("rtype", [0, 6])
def test_rf_bags_smaller_than_the_mesh(rank_models, rtype):
    """Random Forests at -srate 0.4 on 5 queries (int(srate · Q) = 2 a bag)
    under -dp 4: each bag is dealt again and leaves two ranks empty; the
    bags are the reference's make_mesh(4) bags."""
    from ranklib_tpu.metrics.base import create_scorer as ref_scorer
    from ranklib_tpu.models.rf import RFRanker as RefRF
    from ranklib_tpu.parallel.dist import make_mesh as ref_mesh

    hp = dict(n_bags=3, n_trees=2, n_leaves=3, ranker_type=rtype,
              sub_sampling_rate=0.4, feature_sampling_rate=0.5)
    ref = RefRF(**hp)
    ref.fit(_ref_dataset(5), ref_scorer("NDCG@10"), mesh=ref_mesh(4))
    port = RFRanker(**hp)
    port.fit(_dataset(5), create_scorer("NDCG@10"), device=CPU,
             mesh=dist.make_mesh(4, CPU))
    _same_forest(_as_read(port.ensembles), _as_read(ref.ensembles))
    _every_rank_equal(rank_models, 3, 4)
    # no kernel on the CPU; the same collectives on every rank, the
    # empty one included
    kernels = [{k: v for k, v in c.items() if not k.startswith("all_reduce")}
               for c in port.rank_launches + [PG.launch_counts()]]
    assert kernels[:4] == kernels[4:] * 4
    assert len({(c["all_reduce"], c["all_reduce_bytes"])
                for c in port.rank_launches}) == 1
    assert port.rank_launches[0]["all_reduce"] > 0


@pytest.mark.parametrize("cls", ["LambdaMART", "MART"])
def test_warm_start_with_an_empty_rank(rank_models, cls):
    """A 2-tree single-device fit resumed to 4 trees under -dp 4 on 3
    queries, with a 1-query validation set (``scatter_doc_values`` of
    both on the empty ranks): the reference's make_mesh(4) resume, cut
    back at the same best validation round, the prior trees verbatim."""
    from ranklib_tpu.metrics.base import create_scorer as ref_scorer
    from ranklib_tpu.models import gbdt as RG
    from ranklib_tpu.parallel.dist import make_mesh as ref_mesh

    train, val = _dataset(3), _dataset(1, seed=10)
    hp = dict(n_leaves=4, learning_rate=0.2, early_stop=0)
    port_cls, ref_cls = {"LambdaMART": (LambdaMART, RG.LambdaMART),
                         "MART": (MART, RG.MART)}[cls]
    part = port_cls(n_trees=2, **hp)
    part.fit(train, create_scorer("NDCG@10"), device=CPU)
    port = port_cls(n_trees=4, **hp)
    port.ensemble = part.ensemble
    port.fit(train, create_scorer("NDCG@10"), val, device=CPU,
             mesh=dist.make_mesh(4, CPU))
    rtrain, rval = _ref_dataset(3), _ref_dataset(1, seed=10)
    rpart = ref_cls(n_trees=2, **hp)
    rpart.fit(rtrain, ref_scorer("NDCG@10"))
    ref = ref_cls(n_trees=4, **hp)
    ref.ensemble = rpart.ensemble
    ref.fit(rtrain, ref_scorer("NDCG@10"), rval, mesh=ref_mesh(4))
    assert len(port.ensemble) >= 3          # the cut keeps a new tree
    _same_forest(_as_read([port.ensemble]), _as_read([ref.ensemble]))
    assert (port.ensemble.to_text().split("</tree>")[:2]
            == part.ensemble.to_text().split("</tree>")[:2])
    _every_rank_equal(rank_models, 1, 4)


def test_kcv_dp4_on_five_queries(tmp_path, capsys):
    """-kcv 3 -dp 4 on a 5-query file through the CLI: every fold trains
    on fewer queries than ranks, and the printed Summary table is the
    reference's line for line."""
    from ranklib_tpu.cli import main as ref_main

    path = _file(tmp_path, 5)
    tables = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-train", path, "-ranker", "6", "-tree", "3", "-leaf",
                     "3", "-kcv", "3", "-metric2t", "NDCG@10", "-dp",
                     "4"]) == 0
        out = capsys.readouterr().out.splitlines()
        tables[name] = out[out.index("Summary:"):]
    assert tables["port"] == tables["ref"] and len(tables["port"]) == 6
