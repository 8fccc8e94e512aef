"""The training cell's stratified lengths: each (K, T, F) once per cycle, in an order drawn from the seed."""

import itertools

from portbench.bench import load_cell
from portbench.entries.train import cycles, triples


def _traffic():
    return load_cell("tai_gray.train_sampled_b32").traffic


def test_eighty_triples_each_once_per_cycle():
    tr = _traffic()
    every = triples(tr)
    assert len(every) == 80 and len(set(every)) == 80
    assert set(every) == set(itertools.product(range(2, 6), range(1, 6), range(2, 6)))
    gen = cycles(tr, 2**31 + 11)
    for _ in range(3):
        assert sorted(next(gen)) == sorted(every)


def test_order_follows_the_seed():
    tr = _traffic()
    a, b = cycles(tr, 7), cycles(tr, 7)
    first_a, first_b = next(a), next(b)
    assert first_a == first_b and next(a) == next(b)
    assert next(cycles(tr, 8)) != first_a
    assert next(a) != first_a  # each cycle draws its own order
