"""The benchmark's work arithmetic against hand counts."""
import pytest

from benchmark import work


def test_wavefront_hand_count():
    # two pairs: 10 x 12 bases (23 antidiagonals), 30 x 40 cut at Dmax 50
    w = work.wavefront([10, 30], [12, 40], Dmax=50, W=8, want_bp=True)
    diags = 23 + 50
    assert w["cells"] == diags * 8
    assert w["ops"] == diags * 8 * 14 + diags * 19
    moves = 4 * 8 * (2 + 4)                # ceil(23/16) + ceil(50/16) words
    assert w["bytes"] == (10 + 12 + 30 + 40) + 2 * (8 + 12) + moves
    assert w["least_s"] == pytest.approx(max(
        w["ops"] / work.INT32_PEAK, w["bytes"] / work.HBM_BYTES_PER_S))


def test_arrow_hand_count():
    w = work.arrow([4], [6], Lq=8, C=2)
    assert w["cells"] == 2 * 5 * 7
    assert w["ops"] == 70 * 66
    assert w["bytes"] == 10 + 8 + 8 + 40 + 4 * 2 * 9 * 9 + 4
    assert w["least_s"] == pytest.approx(max(w["ops"] / 67e12,
                                             w["bytes"] / 3.35e12))


def test_int32_peak_is_derived():
    assert work.INT32_PEAK == pytest.approx(132 * 64 * 1.98e9)
