"""The plain references against the port's CPU path at tiny sizes, on the
same injected draws (the kernels' stream replayed by ``philox.py``).  Only
this test calls the port's plain versions; the references import nothing
of the port."""

import numpy as np
import pytest
import torch

from bench_h100.lib import common
from bench_h100.reference import chains, lattice, philox

SEED = 2 ** 41 + 12345


def close_links(a, b):
    return float(lattice.wrap(a - b).abs().max())


@pytest.mark.parametrize("ctr,key,out", [
    ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     0x299F31D0A4093822, (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, out):
    words = philox.philox4x32(*[torch.tensor([c]) for c in ctr], key)
    assert tuple(int(w) for w in words) == out


def test_philox_uniform_and_normal_ranges():
    v0, v1 = philox.momenta(SEED, 64, 256, 3, 10, "cpu")
    assert abs(float(v0.mean())) < 0.02 and abs(float(v1.std()) - 1) < 0.02
    u = philox.scalars(SEED, 4096, 256, 0, 1, "cpu")
    assert all(float(w.min()) > 0 and float(w.max()) <= 1 for w in u)


def links(b, lt, lx, sigma=0.3):
    gen = torch.Generator().manual_seed(7)
    return lattice.near_equilibrium(gen, b, lt, lx, sigma)


def agree(ref, port):
    assert close_links(ref[0], port[0]) < 1e-5
    assert float((ref[1] - port[1]).abs().max()) < 1e-5
    assert torch.equal(ref[2], port[2])
    assert float((ref[3] - port[3]).abs().max()) < 1e-4


def test_hmc_against_port():
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    x, n = links(8, 8, 8), 6
    rand = philox.hmc_draws(SEED, 8, 64, n, "cpu")
    port = hmc_chain(x, None, 0.08, 4.0, 5, n, rand_arrays=rand)
    agree(chains.hmc_call(x, SEED, 0.08, 4.0, 5, n), port)


def champion():
    from bench_h100.drivers.sample import MLP_LEAVES

    path = common.BENCH / "configs" / "u1_16x16_champion.npz"
    with np.load(path) as z:
        leaves = [torch.tensor(z[f"arr_{i}"]) for i in range(18)]
    nets = [chains.MLPNet(dict(zip(MLP_LEAVES, leaves[i:i + 8])), True)
            for i in (0, 8)]
    return path, nets, leaves[-1]


def test_champion_mlp_against_port():
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_chain
    from l2hmc_tpu_torch.train.checkpoint import load_champion

    path, (xnet, vnet), masks = champion()
    _, params = load_champion(path, "cpu")
    x, n = links(6, 16, 16), 4
    rand = philox.l2hmc_draws(SEED, 6, 256, n, "cpu")
    port = l2hmc_chain(x, params, None, 0.125, 4.0, 3, n, rand_arrays=rand)
    agree(chains.l2hmc_call(x, xnet, vnet, masks, SEED, 0.125, 4.0, n), port)


def local_cell(lt=8):
    from bench_h100.drivers import sample as drv
    from types import SimpleNamespace

    cfg = {**common.load_json("configs", "u1_64x64_local"),
           "lattice": [lt, lt]}
    tr = {**common.load_json("traffic", "local_b512_n250"), "chains": 4,
          "transitions_per_call": 3}
    ctx = SimpleNamespace(seed=SEED, device=torch.device("cpu"),
                          config=cfg, traffic=tr)
    cell = drv.Cell(ctx)
    cell.setup()
    return cell


def test_local_stencil_against_port():
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_local_chain

    cell = local_cell()
    x = cell.start
    rand = philox.l2hmc_draws(SEED, 4, 64, 3, "cpu")
    port = l2hmc_local_chain(x, cell.params, None, cell.eps, 4.0, 4, 3, 1,
                             rand_arrays=rand)
    ref = chains.l2hmc_call(x, cell.nets[0], cell.nets[1], cell.masks, SEED,
                            cell.eps, 4.0, 3)
    agree(ref, port)
    # the conditioner moves the proposal: the same call as plain HMC-like
    # nets (zero heads) parts from it
    zero = [chains.StencilNet({**net.w, "head.w": 0 * net.w["head.w"],
                               "head.b": 0 * net.w["head.b"],
                               "stencil_0.b": 0 * net.w["stencil_0.b"]},
                              1, 8, 8, True) for net in cell.nets]
    flat = chains.l2hmc_call(x, zero[0], zero[1], cell.masks, SEED,
                             cell.eps, 4.0, 3)
    assert float((flat[3] - ref[3]).abs().max()) > 1e-3
