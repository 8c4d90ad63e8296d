"""The traffic files build their inputs from the seed alone, and the
generator's frozen draws equal the originals they were copied from."""

import os

import numpy as np
import pytest

from portbench import generate

TRAFFIC = sorted(f[:-5] for f in os.listdir(os.path.join(
    generate.HERE, "traffic")) if f.endswith(".json"))


@pytest.mark.parametrize("name", TRAFFIC)
def test_same_seed_same_inputs(name):
    t = generate.load_traffic(name)
    a = generate.build(t, 2**31 + 5)
    assert a == generate.build(t, 2**31 + 5)
    b = generate.build(t, 2**31 + 6)
    if t.get("order") == "seeded_permutation":
        # another seed: the same rows in another order, the same work
        assert a != b and sorted(a) == sorted(b)


def test_replace_equals_j_to_l():
    import chip_smoke

    t = generate.load_traffic("h3n2_all")
    got = generate.build({**t, "order": None}, 0)
    want, rows = chip_smoke.j_to_l(generate.dataset("h3n2sample",
                                                    "sequence"))
    assert got == want and len(rows) == 2 and len(got) == 8103


def test_warm_rows_keep_the_padded_width():
    t = generate.load_traffic("h3n2_all")
    seqs = generate.build(t, 3)
    warm = generate.warm_rows(t, seqs)
    assert len(warm) == t["warm"]["longest"]
    assert max(map(len, warm)) == max(map(len, seqs))
    lens = np.array([len(s) for s in seqs])
    assert sorted(map(len, warm)) == sorted(lens)[-len(warm):]


def test_pool_takes_every_pair_of_a_small_set_and_the_longest_pair():
    from portbench import matrix

    seqs = ["A" * n for n in (3, 9, 1, 7)]
    assert len(matrix.pool(seqs, 10, 0)) == 10
    big = matrix.pool(seqs, 9, 0)
    assert big.shape == (9, 2) and (big[:, 0] <= big[:, 1]).all()
    assert tuple(big[0]) == (1, 3)
    assert np.array_equal(matrix.pool(seqs, 9, 0), matrix.pool(seqs, 9, 0))
