"""PyTorch port: the conv L2HMC sampler's eval path (``train/gauge.py
make_eval_chunk`` with the periodic-CNN conditioner and the split
integrator) against the benchmark's plain reference
(``bench_h100/reference/conv_chain.py``) on the same draws, and the
benchmark's frozen conditioner count against PyTorch's FLOP counter.

The reference imports nothing of the port; both sides compute from the
leaves and masks the benchmark's driver draws from the seed, and the
reference redraws the call's momenta, directions and uniforms from a
generator set to the state the port's had when the call began.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.drivers import eval_chunk as drv
from bench_h100.lib import common
from bench_h100.reference import conv_chain, lattice
from l2hmc_tpu_torch.train.gauge import (build_networks, init_params,
                                         make_eval_chunk)

SEED = 2 ** 41 + 19


def generator_at(state):
    gen = torch.Generator()
    gen.set_state(state)
    return gen


def conv_setup(lt, chains):
    """The cell's configuration at ``lt x lt`` (trunk 2 x_dim): its nets and
    masks drawn from the seed at the cell's widths and loaded into the
    program's, links near equilibrium at beta 4.  Returns the program's
    ``GaugeConfig`` and ``params``, the reference's nets and masks, and
    the links."""
    cfg = common.load_json("configs", "u1_16x16_conv")
    cfg = {**cfg, "lattice": [lt, lt],
           "sampler": {**cfg["sampler"], "num_hidden": 4 * lt * lt}}
    gen = torch.Generator().manual_seed(SEED)
    gcfg = drv.gauge_config(cfg, chains)
    assert gcfg.hidden == 2 * gcfg.x_dim
    nets, masks = drv.seeded_conv_weights(gen, lt, lt, cfg["sampler"],
                                          cfg["init_std"])
    params = init_params(gcfg, torch.Generator().manual_seed(3), "cpu")
    drv.check_spec(params, cfg["sampler"])
    drv.load_weights(params, nets, masks)
    links = lattice.near_equilibrium(
        gen, chains, lt, lt, lattice.sigma_at(common.plaquette_at(4.0)))
    return (gcfg, params, drv.reference_nets(nets, lt, lt, True), masks,
            links)


def test_torch_conv_eval_chunk_matches_plain_reference():
    """8x8, 8 chains, K=3, the cell's init widths, 3 transitions.  Both
    sides compute in float32 in other orders (the reference's convs are
    sums of rolled taps, its energy change a sum of per-site
    differences), so they agree to rounding grown over three chaotic
    transitions: accept probabilities within 2e-5 (an energy change of
    ~1e3 terms in float32 carries ~1e-5), links out within 2e-5 mod 2 pi,
    plaquettes within 1e-6 (a mean of 64 cosines)."""
    gcfg, params, (xnet, vnet), masks, links = conv_setup(8, 8)
    b, n = 8, 3
    gen = torch.Generator().manual_seed(SEED + 1)
    state = gen.get_state()
    x_out, m = make_eval_chunk(gcfg, n)(params, links.reshape(b, -1), 4.0,
                                        gen)
    ref_gen = generator_at(state)
    ref = conv_chain.conv_call(links, xnet, vnet, masks, ref_gen, 0.1, 4.0,
                               n, block=3)
    assert float((m["accept_prob"] - ref[3]).abs().max()) < 2e-5
    assert float(lattice.wrap(x_out.reshape(b, 8, 8, 2) - ref[0]).abs()
                 .max()) < 2e-5
    assert float((m["plaqs"] - ref[1]).abs().max()) < 1e-6
    assert torch.equal(m["charges"], ref[2])
    # the draws are the call's own: the generators ended in one state
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    # the conditioner moves the proposal: zero heads part from it
    zero = [conv_chain.ConvNet({**net.w, "head_w": 0 * net.w["head_w"]},
                               8, 8, True) for net in (xnet, vnet)]
    flat = conv_chain.conv_call(links, zero[0], zero[1], masks,
                                generator_at(state), 0.1,
                                4.0, n)
    assert float((flat[3] - ref[3]).abs().max()) > 1e-3


@pytest.mark.parametrize("net", ["xnet", "vnet"])
def test_torch_conv_conditioner_flops_match_the_counter(net):
    """One conditioner call at the published widths (16x16, filters 8 and
    16, kernels 3 and 2 at stride 2, trunk 1024): the frozen count
    (``bench_h100/counts/u1_16x16_conv.py``) is PyTorch's count of its
    convolutions and products."""
    cfg = common.load_json("configs", "u1_16x16_conv")
    counts = common.load_module("counts", "u1_16x16_conv")
    gcfg = drv.gauge_config(cfg, 2)
    xnet, vnet = build_networks(gcfg, torch.Generator().manual_seed(0),
                                "cpu")
    module = {"xnet": xnet, "vnet": vnet}[net]
    b, d = 2, gcfg.x_dim
    v_in, x_in = ((torch.randn(b, d), torch.randn(b, 2 * d)) if net == "xnet"
                  else (torch.randn(b, 2 * d), torch.randn(b, d)))
    with FlopCounterMode(display=False) as fc:
        module(v_in, x_in, torch.randn(b, 2))
    assert fc.get_total_flops() == 2 * b * counts.conv_macs(256,
                                                          cfg["sampler"])
    assert counts.conditioner_flops_per_transition(cfg["sampler"], 256) == (
        12 * fc.get_total_flops() / b)
