"""Percentiles and the roofline counts on hand-worked cases."""
import pytest

from portbench import stats
from portbench.roofline import counts


def test_percentile_interpolates_between_order_statistics():
    xs = [10, 1, 4, 7, 2, 3, 5, 6, 8, 9]          # 1..10
    assert stats.percentile(xs, 0) == 1
    assert stats.percentile(xs, 100) == 10
    assert stats.percentile(xs, 50) == 5.5
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.beyond(xs, 90) == 1
    assert stats.percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_search_block_and_steps():
    assert counts.search_block(1024) == 128
    assert counts.search_block(96) == 32
    assert counts.search_block(7) == 1
    assert counts.search_steps(1) == 1
    assert counts.search_steps(7) == 3
    assert counts.search_steps(8) == 4


def test_sweep_counts_by_hand():
    # 10 tokens of 2 words and 3 docs, K = 8, int16 topics and ELL;
    # docs' live topics sum to 5, over the 4 (word, doc) pairs to 7;
    # 6 sparse draws with 9 compares in all, 4 dense
    nbytes, ops = counts.sweep(tokens=10, words=2, pairs_live=7,
                               docs_live=5, sparse_steps=9, dense_tokens=4,
                               num_topics=8, z_bytes=2, ell_bytes=2,
                               block=8)
    assert nbytes == 10 * (4 + 4) + 2 * (4 + 32) + 32 + 5 * 4
    # 4 K a word; 2 a live entry of a pair; 2 a token; compares: dense
    # tokens search 1 block sum (1 step) then 8 in-block sums (4 steps)
    assert ops == 4 * 8 * 2 + 2 * 7 + 2 * 10 + 9 + 4 * (1 + 4)


def test_advance_and_iteration_count_shared_reads_once():
    adv = counts.advance(tokens=10, words=2, changed_entries=6, z_bytes=2)
    assert adv == (10 * 4 + 8 + 24, 20)
    sweep = (1000, 500)
    assert counts.iteration(sweep, adv, tokens=10, words=2, z_bytes=2) == \
        (1000 + 72 - 40 - 8, 520)


def test_least_time_is_the_larger_bound():
    assert counts.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert counts.least_ms(0, 67e9) == pytest.approx(1.0)
    assert counts.least_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)
