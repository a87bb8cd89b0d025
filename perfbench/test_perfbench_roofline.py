"""The frozen work count (``perfbench/roofline.py``) against a hand count at
two small shapes, and the least times of the four cells."""

import pytest

from perfbench import roofline


def _hand(n, m, k, seeds):
    kp = seeds * k
    ax = xb = 2 * n * m * kp  # AᵀX and X·Bᵀ at the packed width
    a_gb = 2 * n * kp * k  # A·gb, each seed's own block
    ga_b = 2 * kp * k * m  # ga·B
    grams = seeds * (n * k * (k + 1) + m * k * (k + 1))  # AᵀA and BBᵀ, upper triangles
    return ax + xb + a_gb + ga_b + grams


@pytest.mark.parametrize("n,m,k,seeds,want", [(10, 6, 3, 1, 1200), (5, 4, 2, 2, 572)])
def test_matrix_flops_match_a_hand_count(n, m, k, seeds, want):
    assert _hand(n, m, k, seeds) == want
    assert roofline.matrix_flops(n, m, k, seeds) == want


def test_terms_of_the_two_configurations():
    assert roofline.num_terms(4, 3) == 47
    assert roofline.num_terms(4, 2) == 27


@pytest.mark.parametrize("n,m,r,p,seeds,micros", [
    (3961, 1001, 4, 3, 1, 1.573),
    (3961, 1001, 4, 3, 2, 3.146),
    (27000, 1000, 4, 2, 1, 6.016),
    (27000, 1000, 4, 2, 4, 24.06),
])
def test_least_epoch_times_of_the_cells(n, m, r, p, seeds, micros):
    k = roofline.num_terms(r, p)
    assert roofline.least_epoch_s(n, m, k, r, seeds) * 1e6 == pytest.approx(micros, rel=1e-3)
    assert roofline.bound(n, m, k, r, seeds) == "operations"


def test_bytes_bound_a_launch_of_one_epoch():
    """Spread over one epoch, reading X takes longer than cylinder's products."""
    k = roofline.num_terms(4, 3)
    assert roofline.bound(3961, 1001, k, 4, epochs=1) == "bytes"
    assert roofline.least_epoch_s(3961, 1001, k, 4, epochs=1) >= 3961 * 1001 * 4 / roofline.PEAK_BYTES
