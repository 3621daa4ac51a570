"""The frozen work counts behind the rooflines and ``mfu``, against the
cells' shapes worked out by hand."""

import pytest

from bench_h100.counts import u1
from bench_h100.lib import common

TF32, F32 = 495e12, 67e12


def work(config_name, kernel, chains, n, k):
    return common.load_module("counts", config_name).call_work(
        common.load_json("configs", config_name),
        {"kernel": kernel, "chains": chains, "transitions_per_call": n,
         "num_leapfrog": k})


def test_champion_conditioner_flops():
    # ten MLP calls per transition (K+1 kicks, 2K half-updates), each of
    # (1536 + 2) x 64 + 64 x 64 + 64 x 1536 multiply-adds, 2048 chains
    by_hand = 2 * 2048 * 10 * ((6 * 256 + 2) * 64 + 64 * 64 + 64 * 6 * 256)
    assert by_hand == 8_226_078_720
    w = work("u1_16x16_champion", "l2hmc_chain", 2048, 1, 3)
    assert w.matrix_flops == by_hand
    assert w.matrix_flops / TF32 * 1e6 == pytest.approx(16.62, abs=0.01)
    # the rest of the transition: 214 K + 47 operations per site
    assert w.other_ops == 2048 * 256 * (214 * 3 + 47)


def test_local64_conditioner_flops():
    # 13 stencil calls per transition: per site 5 x 6 x 4 + 4 x 6, plus the
    # two time rows of 4 channels per chain, 512 chains of 64 x 64
    per_call = 4096 * (5 * 6 * 4 + 4 * 6) + 2 * 4
    by_hand = 2 * 512 * 13 * per_call
    w = work("u1_64x64_local", "l2hmc_local_chain", 512, 1, 4)
    assert w.matrix_flops == by_hand
    assert by_hand == pytest.approx(7.85e9, rel=1e-3)
    # operations bound it: 903 per site at K = 4, 28.3 us at 67 TFLOP/s
    assert w.other_ops == 512 * 4096 * 903
    assert w.other_ops / F32 * 1e6 == pytest.approx(28.26, abs=0.01)


@pytest.mark.parametrize("chains,lattice,k,us", [
    (2048, 16, 5, 1.0955),
    (4096, 32, 4, 7.199),
])
def test_hmc_operations(chains, lattice, k, us):
    # per site 25 per leapfrog step and 15 per transition
    w = u1.call_work({"lattice": [lattice, lattice]},
                     {"kernel": "hmc_chain", "chains": chains,
                      "transitions_per_call": 1, "num_leapfrog": k})
    assert w.matrix_flops == 0
    assert w.other_ops == chains * lattice * lattice * (25 * k + 15)
    assert w.other_ops / F32 * 1e6 == pytest.approx(us, rel=1e-3)
    if lattice == 16:
        assert work("u1_16x16_champion", "hmc_chain", chains, 1, k) == w


def test_bytes_read_once_per_call():
    # links in and out and three traces, whatever the transitions
    b, d, n = 2048, 256, 1000
    assert u1.io_bytes(b, d, n) == 4 * (2 * b * 2 * d + 3 * n * b)
    one = work("u1_16x16_champion", "hmc_chain", b, 1, 5)
    many = work("u1_16x16_champion", "hmc_chain", b, n, 5)
    assert many.other_ops == n * one.other_ops
    assert many.bytes < n * one.bytes


def test_mfu_numerator_is_the_matrix_work():
    cfg = common.load_json("configs", "u1_16x16_champion")
    per = u1.conditioner_flops_per_transition(cfg["sampler"], 256)
    w = work("u1_16x16_champion", "l2hmc_chain", 2048, 1, 3)
    assert per * 2048 == w.matrix_flops
