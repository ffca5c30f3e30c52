"""The operation counts against counts made by hand."""

import numpy as np

from benchmark import flops as fl
from benchmark.adapters import plate_netbc, wave_confined

UV = [3] + [70] * 8 + [5]
SMALL = [3] + [20] * 4 + [5]
W1 = [3] + [140] * 6 + [7]


def test_weights_by_hand():
    assert sum(fl.weights(UV)) == 3 * 70 + 7 * 70 * 70 + 70 * 5 == 34860
    assert sum(fl.weights(SMALL)) == 60 + 3 * 400 + 100 == 1360
    assert sum(fl.weights(W1)) == 420 + 5 * 140 * 140 + 980 == 99400


def test_plate_counts_by_hand():
    cfg = {"nets": {"uv": UV, "dist": SMALL, "part": SMALL}}
    banks = {"collocation": {"xyt": np.zeros((1000, 3))},
             "hole": {"xyt": np.zeros((100, 3))}}
    got = plate_netbc.train_flops(cfg, banks)
    # collocation: uv forward + backward at 5 streams less the first
    # layer's input cotangent, dist and part forward; hole: 1 stream.
    col = (6 * 5 * 34860 - 2 * 5 * 210) + 2 * (2 * 5 * 1360)
    hole = (6 * 34860 - 2 * 210) + 2 * (2 * 1360)
    assert col == 1070900 and hole == 214180
    assert got["step"] == 1000 * col + 100 * hole
    # B5 as the loss needs it: uv's backward (6 per hidden weight, 4 per
    # head weight, per stream) and dist's jet.
    assert got["bwd"] == 1000 * (30 * (210 + 34300) + 20 * 350 + 10 * 1360)
    serve = plate_netbc.serve_flops_per_point(cfg)
    assert serve["fwd"] == 8 * 34860 + 2 * 8 * 1360 == 300640


def test_wave_counts_by_hand():
    cfg = {"nets": {"net": W1}}
    banks = {"collocation": {"xyt": np.zeros((1000, 3))},
             "src": {"xyt": np.zeros((50, 3))},
             "ic": {"xyt": np.zeros((20, 3))},
             "fixed": {"xyt": np.zeros((30, 3))}}
    got = wave_confined.train_flops(cfg, banks)
    col = 6 * 4 * 99400 - 2 * 4 * 420
    other = 6 * 99400 - 2 * 420
    assert col == 2382240 and other == 595560
    assert got["step"] == 1000 * col + 100 * other
    assert got["bwd"] == 1000 * (24 * (420 + 98000) + 16 * 980)


def test_roofline_takes_the_larger_bound():
    assert fl.roofline(67e12, 0.0, 2.0) == 0.5
    assert fl.roofline(0.0, 3.35e12, 4.0) == 0.25
