"""The yardstick's arithmetic against hand counts, at small shapes."""

import numpy as np
import pytest

from portbench import bounds
from portbench import graph as G


def test_segsum_bound_counts_each_byte_once():
    # 10 rows of 4 float32 in, their 10 int32 ids, 3 float32 rows out
    nbytes = 10 * 4 * 4 + 10 * 4 + 3 * 4 * 4
    assert bounds.segsum_bound_s(10, 4, 4, 3) == pytest.approx(
        nbytes / bounds.HBM_BYTES_PER_S)


def test_negscore_bytes_and_operations():
    # z (5, 8) float32, 12 slots, 2 relations; forward
    fwd = 5 * 8 * 4 + 3 * 4 * 12 + 2 * 8 * 4 + 4 * 12
    assert bounds.neg_bytes("distmult", 5, 8, 4, 12, 2, False) == fwd
    bwd = fwd + 5 * 8 * 4 + 2 * 8 * 4
    assert bounds.neg_bytes("distmult", 5, 8, 4, 12, 2, True) == bwd
    # huge m: the operations bound (8 a unit backward) dominates
    m = 10**9
    t = bounds.negscore_bound_s("distmult", 5, 8, 4, m, 2, True)
    assert t == pytest.approx(max(bounds.neg_bytes("distmult", 5, 8, 4, m,
                                                   2, True)
                                  / bounds.HBM_BYTES_PER_S,
                                  8 * m * 8 / bounds.FP32_FLOP_PER_S))


@pytest.mark.parametrize("backward,products,exps", [(False, 1.5, 1.5),
                                                    (True, 3.0, 2.0)])
def test_flash_bound_counts_real_row_pairs(backward, products, exps):
    n, d = 20000, 256
    t = bounds.flash_bound_s(n, d, 4, backward)
    assert t == pytest.approx(max(products * 2 * n * n * d
                                  / bounds.FP32_FLOP_PER_S,
                                  exps * n * n / bounds.SFU_OP_PER_S))
    # pads never count: the bound depends on the real rows alone
    assert bounds.flash_bound_s(n // 2, d, 4, backward) < t / 3.9


def test_rgcn_step_flops_by_hand():
    # one conv 4 -> 2, 3 nodes, 5 edges, 2 pairs, K = 1, d_out 2
    conv = 2.0 * (2 + 3) * 4 * 2
    expected = conv * 2.0 + 5 * 2 + 11.0 * 2 * 5 * 2
    assert bounds.rgcn_step_flops(3, 5, 2, [(4, 2)], 1, 2) == expected


def test_grace_step_flops_by_hand():
    n, e = 3, 4
    conv = 2 * (2.0 * n * 4 * 2 * 2.0 + e * 2)
    proj = 2 * (2.0 * n * 2 * 2 + 2.0 * n * 2 * 2) * 3.0
    pair = 2.0 * n * n * 2
    assert bounds.gcn_grace_step_flops(n, e, [(4, 2)], 2, 2) == \
        pytest.approx(conv + proj + 6.0 * pair)


def test_percentile_and_rate_over_all_values():
    steps = [10.0] * 90 + [100.0] * 10
    # rank (100 - 1) x 0.9 = 89.1: a tenth of the way from 10 to 100
    assert bounds.percentile(steps, 90) == pytest.approx(10.0 + 0.1 * 90)
    assert bounds.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert bounds.rate(1000.0, 4.0) == 250.0
    with pytest.raises(ValueError):
        bounds.rate(1.0, 0.0)
    assert bounds.share(1.0, 0.0) is None
    assert bounds.share(1.0, 4.0) == 25.0


def test_graph_is_fixed_and_in_the_programs_id_order():
    sizes = {"gene/protein": 300, "drug": 100, "disease": 200}
    a = G.primekg_edges(sizes, 5000, 42, list(sizes))
    b = G.primekg_edges(sizes, 5000, 42, list(sizes))
    assert np.array_equal(a.src, b.src) and np.array_equal(a.rel, b.rel)
    assert a.type_names == sorted(sizes)
    keys = G.edge_keys(a.src, a.dst, a.rel, a.num_nodes, a.num_relations)
    assert len(np.unique(keys)) == len(keys)
    # rows come grouped by relation, ids in first-appearance order
    assert np.all(np.diff(a.rel) >= 0)
    gene = G.primekg_edges(sizes, 5000, 42, ["gene/protein"])
    assert gene.relation_names == ["protein_protein"]


def test_program_builds_the_same_graph():
    from biomedkg_tpu_torch.data.triplet import TripletGraph

    from portbench.cells.common import graph_mismatch
    sizes = {"gene/protein": 300, "drug": 100, "disease": 200}
    g = G.primekg_edges(sizes, 5000, 42, list(sizes))
    tg = TripletGraph(columns=G.triplet_columns(g))
    assert graph_mismatch(tg.graph, g) == 0
    assert [tg.edge_map_index[i] for i in range(g.num_relations)] == \
        g.relation_names


def test_seed_of_takes_large_seeds():
    s = G.seed_of(2**40 + 7, "draws", 3)
    assert 0 <= s < 2**63
    assert s != G.seed_of(2**40 + 7, "draws", 4)
    assert s == G.seed_of(2**40 + 7, "draws", 3)
