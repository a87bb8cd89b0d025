"""The frozen work count (``perfbench/roofline.py``) against a hand count at
two small shapes, and the least times of the four cells; the AE form's
against a hand count and ``chip_smoke.ae_flops``."""

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


def _ae_hand(n, m, k):
    """The AE epoch's products, layer by layer: each layer's forward, its
    input's gradient and its weight's gradient, 2·rows·in·out each, save the
    first encoder layer's input gradient (X needs none), and the factored
    AE-MSE's Grams in place of the last decoder layer's three (D6ᵀD6 and
    V6V6ᵀ symmetric, D6·VV, S_dd·V6, X·V6ᵀ, D6ᵀX); then the dictionary's."""
    enc = (m, 256, 128, 64, 16, 8, 4, 2)
    dec = enc[::-1]
    mlp = 0
    for i, (a, b) in enumerate(zip(enc, enc[1:])):
        mlp += 2 * n * a * b * (2 if i == 0 else 3)
    for a, b in list(zip(dec, dec[1:]))[:-1]:
        mlp += 3 * 2 * n * a * b
    h = dec[-2]
    factored = n * h * (h + 1) + 2 * n * h * h + m * h * (h + 1) + 2 * h * h * m + 2 * n * m * h + 2 * n * h * m
    dictionary = 2 * n * m * k + 2 * n * m * k + 2 * n * k * k + n * k * (k + 1) + m * k * (k + 1)
    return mlp + factored + dictionary


@pytest.mark.parametrize("n,m,k", [(5, 7, 3), (3961, 1001, 12)])
def test_ae_flops_match_a_hand_count(n, m, k):
    assert roofline.ae_flops(n, m, k) == _ae_hand(n, m, k)


def test_ae_flops_are_chip_smokes_at_the_cell():
    import chip_smoke

    assert roofline.ae_flops(3961, 1001, 12) == chip_smoke.ae_flops(3961, 1001, 12)
    assert roofline.ae_flops(3961, 1001, 12) / 1e9 == pytest.approx(11.29, abs=0.005)
    assert roofline.ae_least_epoch_s(3961, 1001, 12) * 1e6 == pytest.approx(22.81, abs=0.005)


def test_ae_mlp_size_is_the_kernels_layout():
    from desmo_tpu_torch.kernels import ae_chunk

    for m in (80, 1001):
        assert roofline.ae_mlp_size(m) == ae_chunk.mlp_size(m)


def test_each_variant_takes_its_own_count():
    rc = dict(n=3961, m=1001, r=2, poly_order=2, n_fourier=0, variant="ae")
    assert roofline.config_least_epoch_s(rc, 1, 2000) == roofline.ae_least_epoch_s(3961, 1001, 12)
    rc.update(variant="fourier", n_fourier=10)
    assert roofline.config_least_epoch_s(rc, 8, 2000) == roofline.least_epoch_s(3961, 1001, 12, 2, 8, 10)
