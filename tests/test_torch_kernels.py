"""PyTorch port: the CUDA kernels against their plain versions.

Every test but the last needs a CUDA device (marker ``cuda``) and skips
without one: the kernels are CUDA C++ for sm_90a and have no CPU mode.  This
file imports no JAX, so it also runs on the machine with the card::

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)

Tolerance on the card: 1e-4 on link angles (compared modulo 2 pi) and on
traces.  Kernel and plain version differ only in float32 summation order
and in CUDA's libm against torch's kernels; the energy change is summed per
site on both sides, so accept probabilities agree to ~1e-5 at 16x16 and
~4e-5 at 64x64 (8192 links per chain).  The Wilson kernels: S and dg to
1e-5 of the sum of their terms' magnitudes, sin P to 1e-6, the force from
the same sin P exactly, the fused force and dlinks to 1e-5 of their largest
entry.  The issue-rate
probes to 1e-5, the ablated kernels to their zero-net runs to 1e-6, the
bf16 kernel as its test states.
"""

import copy
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops import issue_rates as tir
from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
from l2hmc_tpu_torch.ops import leapfrog as tlf
from l2hmc_tpu_torch.ops import wilson as tw
from l2hmc_tpu_torch.train import gauge as tgauge

ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain kernels are CUDA C++ "
                    "for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(seed, n, b, d, hop, directions, device):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d))]
    if directions:
        out.append(rng.choice([-1.0, 1.0], (n, b)))
    out.append(rng.uniform(size=(n, b)))
    if hop:
        out += [rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in out]


def _params(lt, lx, K, hidden, device):
    """MLP/u1/merge_v params with every array perturbed (0.02 normal) so
    the conditioners matter."""
    cfg = tgauge.GaugeConfig(time_size=lt, space_size=lx, num_steps=K,
                             network_arch="mlp", num_hidden=hidden,
                             merge_v_halves=True, group="u1",
                             bounded_q=True, eps_init=0.12)
    g = torch.Generator().manual_seed(lt * 100 + lx)
    params = tgauge.init_params(cfg, g, device="cpu")
    with torch.no_grad():
        for net in (params.xnet, params.vnet):
            for p in net.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    return params.to(device)


def _local_params(lt, lx, K, channels, layers, device, seed=0):
    """local_flat/u1/merge_v params with every net leaf perturbed by a
    seeded N(0, 0.05^2), so that S, T and Q are not near zero."""
    cfg = tgauge.GaugeConfig(time_size=lt, space_size=lx, num_steps=K,
                             network_arch="local_flat", num_filters=channels,
                             local_layers=layers, merge_v_halves=True,
                             group="u1", bounded_q=True, eps_init=0.03)
    g = torch.Generator().manual_seed(seed)
    params = tgauge.init_params(cfg, g, device="cpu")
    with torch.no_grad():
        for net in (params.xnet, params.vnet):
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return params.to(device)


def _assert_matches(got, want, atol=ATOL):
    d = torch.remainder(got[0] - want[0] + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) <= atol
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("lt,lx", [(4, 6), (16, 16), (8, 24), (24, 24),
                                   (64, 64), (96, 64), (96, 96),
                                   (128, 128), (160, 160)])
def test_torch_hmc_chain_kernel_matches_plain(cuda_device, lt, lx, hop):
    """Every route of ops/leapfrog.py hmc_chain_plan: warp (4x6 to 8x24),
    block with 8 (24x24, 64x64) and 16 sites per thread (96x64), global
    with the neighbour-read fields in shared memory (96x96, 128x128) and in
    device memory (160x160); 9 chains, so the warp route's last block runs
    one chain."""
    b, n, eps = 9, 4, 0.1
    links = torch.tensor(typical_links(np.random.default_rng(1), b, lt, lx),
                         device=cuda_device)
    rand = _rand(2, n, b, lt * lx, hop, False, cuda_device)
    before = tlf.hmc_chain.launches
    got = tlf.hmc_chain(links, None, eps, 3.0, 4, n, hop=hop,
                        rand_arrays=rand)
    assert tlf.hmc_chain.launches == before + 1
    want = tlf.hmc_chain_reference(links, *rand[:3], eps, 3.0, 4,
                                   hop_arrays=rand[3:] if hop else None)
    torch.cuda.synchronize()
    _assert_matches(got, want)
    assert 0.05 < float(want[3].mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("lt,lx,hidden", [(4, 6, 32), (8, 8, 64)])
def test_torch_l2hmc_chain_kernel_matches_plain(cuda_device, lt, lx, hidden,
                                                hop):
    b, n, K = 7, 3, 3        # 7 chains: a ragged last block of 2 chains
    params = _params(lt, lx, K, hidden, cuda_device)
    links = torch.tensor(typical_links(np.random.default_rng(3), b, lt, lx),
                         device=cuda_device)
    rand = _rand(4, n, b, lt * lx, hop, True, cuda_device)
    want = tl2.l2hmc_chain_reference(links, params, *rand[:4], 0.12, 3.0, K,
                                     hop_arrays=rand[4:] if hop else None)
    before = tl2.l2hmc_chain.launches
    got = tl2.l2hmc_chain(links, params, None, 0.12, 3.0, K, n, hop=hop,
                          rand_arrays=rand)
    assert tl2.l2hmc_chain.launches == before + 1
    torch.cuda.synchronize()
    _assert_matches(got, want)
    assert 0.05 < float(want[3].mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("lt,lx,b", [(4, 6, 5), (8, 8, 5), (64, 64, 4)])
def test_torch_local_chain_kernel_matches_plain(cuda_device, lt, lx, b,
                                                layers, hop):
    n, K, eps, beta = 3, 4, 0.01, 4.0
    params = _local_params(lt, lx, K, 4, layers, cuda_device)
    links = torch.tensor(typical_links(np.random.default_rng(7), b, lt, lx,
                                       sigma=0.27), device=cuda_device)
    rand = _rand(8, n, b, lt * lx, hop, True, cuda_device)
    want = tl2.l2hmc_chain_reference(links, params, *rand[:4], eps, beta, K,
                                     hop_arrays=rand[4:] if hop else None,
                                     local_layers=layers)
    before = tl2.l2hmc_local_chain.launches
    got = tl2.l2hmc_local_chain(links, params, None, eps, beta, K, n, layers,
                                hop=hop, rand_arrays=rand)
    assert tl2.l2hmc_local_chain.launches == before + 1
    torch.cuda.synchronize()
    _assert_matches(got, want)
    assert 0.02 < float(want[3].mean()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("ablate", [False, True])
@pytest.mark.parametrize("lt,lx,b,layers", [(8, 8, 5, 1), (8, 8, 5, 2),
                                            (64, 64, 4, 1), (64, 64, 4, 2),
                                            (8, 8, 5, 4)])
def test_torch_local_chain_kernel_c8_matches_plain(cuda_device, lt, lx, b,
                                                   layers, ablate):
    """c=8, the most channels the kernel takes (local64's c8L1 among them),
    full and ablated, against the plain version on the same draws; c8L2 at
    64x64 and L=4 run the deep route (hidden outputs in device memory).
    Ablated
    at 64x64 the circle map is the identity computed in float32, an ulp per
    link and half-update, and the plain version alone lies 2.5e-4 from its
    float64 run there: 3e-4, as chip_smoke.py holds it."""
    n, K, eps, beta = 3, 4, 0.01, 4.0
    params = _local_params(lt, lx, K, 8, layers, cuda_device, seed=8)
    links = torch.tensor(typical_links(np.random.default_rng(17), b, lt, lx,
                                       sigma=0.27), device=cuda_device)
    rand = _rand(18, n, b, lt * lx, False, True, cuda_device)
    want = tl2.l2hmc_chain_reference(links, params, *rand, eps, beta, K,
                                     local_layers=layers, ablate_nets=ablate)
    before = tl2.l2hmc_local_chain.launches
    got = tl2.l2hmc_local_chain(links, params, None, eps, beta, K, n, layers,
                                rand_arrays=rand, ablate_nets=ablate)
    assert tl2.l2hmc_local_chain.launches == before + 1
    torch.cuda.synchronize()
    _assert_matches(got, want, 3e-4 if ablate and lt == 64 else ATOL)
    assert 0.02 < float(want[3].mean()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("hop", [False, True])
def test_torch_l2hmc_chain_kernel_at_hidden_256(cuda_device, hop, precision):
    """h=256 (two tile rows per product warp) at the champion's 16x16, 8
    chains per block, a ragged batch of 13: float32 against the plain
    version at ATOL, bf16 as test_torch_bf16_kernel_matches_plain holds
    it."""
    b, n, K, lt, lx = 13, 2, 3, 16, 16
    assert tl2.mma_geometry(lt * lx, 256, precision).rpw == 2
    params = _params(lt, lx, K, 256, cuda_device)
    links = torch.tensor(typical_links(np.random.default_rng(23), b, lt, lx,
                                       sigma=0.3), device=cuda_device)
    rand = _rand(24, n, b, lt * lx, hop, True, cuda_device)
    # eps 0.02: these nets accept 0.05 at eps 0.05
    want = tl2.l2hmc_chain_reference(links, params, *rand[:4], 0.02, 3.0, K,
                                     hop_arrays=rand[4:] if hop else None,
                                     precision=precision)
    before = tl2.l2hmc_chain.launches
    got = tl2.l2hmc_chain(links, params, None, 0.02, 3.0, K, n, hop=hop,
                          rand_arrays=rand, precision=precision)
    assert tl2.l2hmc_chain.launches == before + 1
    torch.cuda.synchronize()
    assert 0.05 < float(want[3].mean()) <= 1.0
    if precision == "f32":
        _assert_matches(got, want)
        return
    us = rand[3]
    keep = ~((us < got[3]) != (us < want[3])).any(dim=0)
    assert int((~keep).sum()) <= 1
    dprob = (got[3][:, keep] - want[3][:, keep]).abs()
    assert float(dprob.median()) <= ATOL
    assert float(dprob.max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("lt,lx,chains", [(16, 16, 8), (24, 24, 4),
                                          (32, 32, 2)])
def test_torch_l2hmc_chain_kernel_at_each_chains_per_block(cuda_device, lt,
                                                           lx, chains, hop):
    """The champion's width (h=64) at the lattices where the wrapper picks
    8, 4 and 2 chains per block, on a ragged batch of 13 chains."""
    b, n, K = 13, 2, 3
    assert tl2.chains_per_block(lt, lx, 64)[0] == chains
    params = _params(lt, lx, K, 64, cuda_device)
    links = torch.tensor(typical_links(np.random.default_rng(21), b, lt, lx,
                                       sigma=0.3), device=cuda_device)
    rand = _rand(22, n, b, lt * lx, hop, True, cuda_device)
    # eps 0.02: at 32x32 these nets accept 0.05 at eps 0.05, 0.28 at 0.02
    want = tl2.l2hmc_chain_reference(links, params, *rand[:4], 0.02, 3.0, K,
                                     hop_arrays=rand[4:] if hop else None)
    before = tl2.l2hmc_chain.launches
    got = tl2.l2hmc_chain(links, params, None, 0.02, 3.0, K, n, hop=hop,
                          rand_arrays=rand)
    assert tl2.l2hmc_chain.launches == before + 1
    torch.cuda.synchronize()
    _assert_matches(got, want)
    assert 0.05 < float(want[3].mean()) <= 1.0


@pytest.mark.cuda
def test_torch_chain_kernel_layouts_agree_with_the_library(cuda_device):
    """The wrappers' shared-memory formulas are the kernels', and the
    committed build runs up to 8 chains per block."""
    lib = _cuda.library()
    assert lib.l2hmc_chain_max_chains() == tl2.CHAINS_PER_BLOCK[0]
    for lt, lx, h, prec in ((16, 16, 64, "f32"), (24, 24, 64, "f32"),
                            (32, 32, 64, "bf16"), (4, 6, 32, "f32"),
                            (16, 16, 256, "f32"), (16, 16, 256, "bf16")):
        d = lt * lx
        c, stages = tl2.chains_per_block(lt, lx, h, prec)
        geo = tl2.mma_geometry(d, h, prec)
        assert lib.l2hmc_chain_smem_bytes(c, d, geo.bs, geo.hs, stages,
                                          geo.mt) == \
            tl2.chain_smem_bytes(c, d, geo, stages)
    assert lib.smem_optin_bytes(0) == tl2.H100_SMEM_OPTIN
    for lt, lx in ((16, 16), (8, 24), (64, 64), (64, 96), (128, 128),
                   (160, 160)):
        plan = tlf.hmc_chain_plan(lt, lx)
        assert lib.hmc_chain_smem_bytes(
            tlf.HMC_ROUTES.index(plan.route), lt, lx, plan.chains,
            int(plan.nb_dev)) == plan.smem
    for lt, lx, c, layers in ((64, 64, 4, 1), (64, 64, 8, 2), (64, 64, 4, 3),
                              (8, 8, 8, 2)):
        deep, smem = tl2.local_chain_route(lt, lx, c, layers)
        assert lib.l2hmc_local_chain_smem_bytes(lt, lx, c, layers,
                                                int(deep)) == smem


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("channels", [1, 3, 4, 5, 8])
def test_torch_local_chain_kernel_pads_channels(cuda_device, channels,
                                                layers):
    """Nets of 1-8 channels run at the kernel's 4 or 8 (padded with zero
    weights): each against the plain version of the unpadded net."""
    b, n, K, lt, lx = 5, 3, 4, 8, 8
    params = _local_params(lt, lx, K, channels, layers, cuda_device,
                           seed=30 + channels)
    links = torch.tensor(typical_links(np.random.default_rng(31), b, lt, lx,
                                       sigma=0.27), device=cuda_device)
    rand = _rand(32, n, b, lt * lx, False, True, cuda_device)
    want = tl2.l2hmc_chain_reference(links, params, *rand, 0.01, 4.0, K,
                                     local_layers=layers)
    got = tl2.l2hmc_local_chain(links, params, None, 0.01, 4.0, K, n, layers,
                                rand_arrays=rand)
    torch.cuda.synchronize()
    _assert_matches(got, want)
    assert 0.02 < float(want[3].mean()) <= 1.0


@pytest.mark.cuda
def test_torch_local_chain_kernel_rejects_what_it_cannot_run(cuda_device):
    """A lattice whose ten fields per chain do not fit one block (96x96:
    360 KB) and a net wider than 8 channels raise; c8L2 at 64x64 and deeper
    nets run (the deep route)."""
    gen = torch.Generator().manual_seed(0)
    big = _local_params(96, 96, 2, 4, 1, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tl2.l2hmc_local_chain(torch.zeros((1, 96, 96, 2), device=cuda_device),
                              big, gen, 0.1, 2.0, 2, 1, 1)
    links = torch.zeros((1, 8, 8, 2), device=cuda_device)
    wide = _local_params(8, 8, 2, 9, 1, cuda_device)
    with pytest.raises(ValueError, match="channels"):
        tl2.l2hmc_local_chain(links, wide, gen, 0.1, 2.0, 2, 1, 1)
    deep = _local_params(8, 8, 2, 4, 3, cuda_device)
    out = tl2.l2hmc_local_chain(links, deep, gen, 0.1, 2.0, 2, 1, 3)
    assert bool(torch.isfinite(out[3]).all())


@pytest.mark.cuda
def test_torch_kernels_in_kernel_randomness(cuda_device):
    """Philox mode: a generator seed fixes the chain, another seed moves it."""
    b, n, lt, lx = 8, 5, 8, 8
    links = torch.tensor(typical_links(np.random.default_rng(5), b, lt, lx),
                         device=cuda_device)
    params = _params(lt, lx, 3, 32, cuda_device)
    local = _local_params(lt, lx, 3, 4, 2, cuda_device)
    runs = {
        "hmc": lambda s: tlf.hmc_chain(
            links, torch.Generator().manual_seed(s), 0.1, 3.0, 4, n,
            hop=True),
        "l2hmc": lambda s: tl2.l2hmc_chain(
            links, params, torch.Generator().manual_seed(s), 0.12, 3.0, 3, n,
            hop=True),
        "local": lambda s: tl2.l2hmc_local_chain(
            links, local, torch.Generator().manual_seed(s), 0.03, 3.0, 3, n,
            2, hop=True),
    }
    for name, run in runs.items():
        a, b_, c = run(1), run(1), run(2)
        for x, y in zip(a, b_):
            assert torch.equal(x, y), name
        assert not torch.equal(a[0], c[0]), name
        for t in a:
            assert bool(torch.isfinite(t).all()), name
        assert 0.05 < float(a[3].mean()) <= 1.0, name


@pytest.mark.cuda
def test_torch_kernel_wrappers_reject_bad_input(cuda_device):
    b, n, lt, lx = 4, 2, 4, 4
    links = torch.zeros((b, lt, lx, 2), device=cuda_device)
    rand = _rand(6, n, b, lt * lx, False, False, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tlf.hmc_chain(links.double(), None, 0.1, 2.0, 2, n, rand_arrays=rand)
    with pytest.raises(ValueError, match="shape"):
        tlf.hmc_chain(links, None, 0.1, 2.0, 2, n + 1, rand_arrays=rand)
    with pytest.raises(ValueError, match="CUDA"):
        tlf.hmc_chain(links, None, 0.1, 2.0, 2, n,
                      rand_arrays=[r.cpu() for r in rand])
    bad = [rand[0].transpose(0, 1).contiguous().transpose(0, 1)] + rand[1:]
    with pytest.raises(ValueError, match="contiguous"):
        tlf.hmc_chain(links, None, 0.1, 2.0, 2, n, rand_arrays=bad)
    with pytest.raises(ValueError, match="num_leapfrog"):
        tlf.hmc_chain(links, None, 0.1, 2.0, 0, n, rand_arrays=rand)
    params = _params(lt, lx, 3, 16, cuda_device)
    with pytest.raises(ValueError, match="num_leapfrog"):
        tl2.l2hmc_chain(links, params, torch.Generator().manual_seed(0),
                        0.1, 2.0, 2, n)
    # the JAX kernel's estimate refuses 8 chains of 256x256 (35.7 MB)
    with pytest.raises(ValueError, match="on-chip memory"):
        tlf.hmc_chain(torch.zeros((8, 256, 256, 2), device=cuda_device),
                      torch.Generator().manual_seed(0), 0.1, 2.0, 2, 1)
    # two 48x48 chains need 261 KB per block (6 fields and the features of
    # each, two weight chunks)
    big = _params(48, 48, 3, 16, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tl2.l2hmc_chain(torch.zeros((1, 48, 48, 2), device=cuda_device), big,
                        torch.Generator().manual_seed(0), 0.1, 2.0, 3, 1)


def _wilson_inputs(seed, b, lt, lx, device):
    rng = np.random.default_rng(seed)

    def arr(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return (arr(rng.uniform(-np.pi, np.pi, (b, lt, lx, 2))),
            arr(rng.uniform(1.0, 5.0, b)),
            arr(rng.standard_normal((b, lt, lx, 2))))


def _wilson_kernels_match_plain(links, g, w):
    """Every Wilson kernel against its plain version on the same inputs:
    S (both forward variants) and dg to 1e-5 of the sum of their terms'
    magnitudes, sin P to 1e-6, the backward from the same sin P exactly,
    the fused force and dlinks to 1e-5 of their largest entry.  Each wrapper
    counts one launch."""
    kernels = (tw.wilson_forward, tw.wilson_action_only, tw.wilson_backward,
               tw.wilson_force, tw.wilson_double_backward)
    before = [k.launches for k in kernels]
    s_k, sinp_k = tw.wilson_forward(links)
    s_only = tw.wilson_action_only(links)
    s_p, sinp_p = tw.wilson_forward_reference(links)
    f_k = tw.wilson_backward(sinp_p, g)
    force_k = tw.wilson_force(links, g)
    dl_k, dg_k = tw.wilson_double_backward(links, g, w)
    dl_p, dg_p = tw.wilson_double_backward_reference(links, g, w)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [n + 1 for n in before]
    p = tw._plaq_sums(links[..., 0], links[..., 1])
    r = (w[..., 0] - torch.roll(w[..., 0], -1, -1) - w[..., 1]
         + torch.roll(w[..., 1], -1, -2))
    s_scale = torch.sum(1.0 - torch.cos(p), dim=(1, 2))
    dg_scale = torch.sum(torch.abs(r * torch.sin(p)), dim=(1, 2))
    assert bool(((s_k - s_p).abs() <= 1e-5 * s_scale).all())
    assert bool(((s_only - s_p).abs() <= 1e-5 * s_scale).all())
    assert float((sinp_k - sinp_p).abs().max()) <= 1e-6
    assert torch.equal(f_k, tw.wilson_backward_reference(sinp_p, g))
    force_p = tw.wilson_force_reference(links, g)
    assert float((force_k - force_p).abs().max()) <= 1e-5 * float(
        force_p.abs().max())
    assert float((dl_k - dl_p).abs().max()) <= 1e-5 * float(
        dl_p.abs().max())
    assert bool(((dg_k - dg_p).abs() <= 1e-5 * dg_scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,lt,lx", [(3, 2, 2), (5, 4, 6), (7, 16, 16),
                                     (3, 32, 32), (2, 64, 64),
                                     (2, 128, 128), (1, 160, 160),
                                     (1, 3, 37)])
def test_torch_wilson_kernels_match_plain(cuda_device, b, lt, lx):
    _wilson_kernels_match_plain(*_wilson_inputs(b * lt + lx, b, lt, lx,
                                                cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lt,lx,route", [
    (3, 2, 2, "block"), (3, 2, 2, "global"), (1, 3, 37, "block"),
    (1, 3, 37, "global"), (5, 16, 16, "block"), (5, 16, 16, "global"),
    (128, 16, 16, "global"), (2, 64, 64, "global"), (3, 33, 35, "block"),
    (3, 33, 35, "global")])
def test_torch_wilson_kernels_on_each_route(cuda_device, b, lt, lx, route):
    """Each route held against the plain versions where the plan would not
    pick it (odd sizes: the block route's float2 and float load fallback),
    and the plan's shared memory against the launcher's."""
    from l2hmc_tpu_torch.benchmarks.wilson_routes import on_route

    plan = tw.wilson_plan(b, lt, lx, route)
    lib = _cuda.library()
    for code, kind in enumerate(tw.WILSON_KINDS):
        assert lib.wilson_smem_bytes(code, tw.WILSON_ROUTES.index(route),
                                     lt, lx) == plan.smem[kind]
    with on_route(route):
        _wilson_kernels_match_plain(*_wilson_inputs(b + lt * lx, b, lt, lx,
                                                    cuda_device))
        # a misaligned view takes an aligned copy, and agrees
        links, g, w = _wilson_inputs(b + lt, b, lt, lx, cuda_device)
        flat = torch.cat([torch.zeros(1, device=cuda_device),
                          links.reshape(-1)])[1:].view(links.shape)
        assert flat.data_ptr() % 16 != 0
        torch.testing.assert_close(tw.wilson_force(flat, g),
                                   tw.wilson_force(links, g), rtol=0, atol=0)


@pytest.mark.cuda
def test_torch_wilson_kernel_autograd_matches_plain(cuda_device):
    """Second order through the kernels (force recorded, then its
    backward) against the plain Function, on the card."""
    links, beta, c = _wilson_inputs(11, 4, 8, 8, cuda_device)
    out = []
    for action in (tw.wilson_action_kernel, tw.wilson_action):
        x = links.clone().requires_grad_(True)
        b = beta.clone().requires_grad_(True)
        (f,) = torch.autograd.grad(torch.sum(b * action(x)), x,
                                   create_graph=True)
        out.append((f.detach(),) + torch.autograd.grad(torch.sum(c * f),
                                                       (x, b)))
    for k, p in zip(*out):
        torch.testing.assert_close(k, p, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_torch_wilson_force_fn_autograd_matches_plain(cuda_device):
    """The fused force's autograd Function (backward: the double-backward
    kernel) and the kernel potential's ``force`` against autograd of the
    plain force on the card, for the link and the per-chain ``g``
    cotangents."""
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape

    links, beta, c = _wilson_inputs(12, 4, 16, 16, cuda_device)
    pot = tw.make_potential_fn(LatticeShape(16, 16))
    runs = {"WilsonForceFn": tw.WilsonForceFn.apply,
            "potential force": lambda x, b: pot.force(
                x.reshape(4, -1), b).reshape(x.shape),
            "plain": tw.wilson_force_reference}
    out = {}
    for name, fn in runs.items():
        x = links.clone().requires_grad_(True)
        b = beta.clone().requires_grad_(True)
        f = fn(x, b)
        out[name] = (f.detach(),) + torch.autograd.grad(torch.sum(c * f),
                                                        (x, b))
    for name in ("WilsonForceFn", "potential force"):
        for k, p in zip(out[name], out["plain"]):
            torch.testing.assert_close(k, p, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_torch_train_step_kernel_matches_plain(cuda_device):
    """One train step through the Wilson kernels against the plain
    potential on the card: same state and draws (8x8, h16, K=2, hops)."""
    cfg = tgauge.GaugeConfig(time_size=8, space_size=8, num_chains=16,
                             num_steps=2, network_arch="mlp", num_hidden=16,
                             merge_v_halves=True, eps_init=0.1,
                             train_hops=True, charge_reward=True,
                             lr_warmup_steps=0, beta_init=2.0)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    state = tgauge.init_train_state(cfg, gen, cuda_device)
    draws = tgauge.draw_train_randomness(gen, 16, cfg.x_dim, True,
                                         cuda_device)
    out = []
    for pot in (None, tw.make_plain_potential_fn(cfg.shape)):
        st = state._replace(params=copy.deepcopy(state.params))
        out.append(tgauge.make_train_step(cfg, pot)[1](st, draws))
    (sk, mk), (sp, mp) = out
    assert abs(float(mk["loss"]) - float(mp["loss"])) <= 1e-4 * abs(
        float(mp["loss"]))
    for key in ("accept_prob", "plaqs", "eps"):
        assert abs(float(mk[key]) - float(mp[key])) <= ATOL, key
    d = torch.remainder(sk.x - sp.x + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) <= ATOL


@pytest.mark.cuda
def test_torch_wilson_wrappers_reject_bad_input(cuda_device):
    links, g, w = _wilson_inputs(3, 2, 4, 4, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tw.wilson_forward(links.double())
    with pytest.raises(ValueError, match="contiguous"):
        tw.wilson_double_backward(links, g, w.transpose(1, 2).contiguous()
                                  .transpose(1, 2))
    _, sinp = tw.wilson_forward(links)
    with pytest.raises(ValueError, match="CUDA"):
        tw.wilson_backward(sinp, g.cpu())
    with pytest.raises(ValueError, match="shape"):
        tw.wilson_backward(sinp, g[:1])
    with pytest.raises(ValueError, match="float32"):
        tw.wilson_force(links, g.double())
    with pytest.raises(ValueError, match="CUDA"):
        tw.wilson_force(links, g.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [p.name for p in tir.PROBES])
def test_torch_issue_rate_probe_matches_plain(cuda_device, probe):
    """Each probe of csrc/issue_rates.cu against its plain chain, 64 steps:
    the same libdevice routines, but one FFMA where torch rounds twice and a
    division where torch multiplies by a reciprocal; the maps contract, so
    1e-5 absolute."""
    x = torch.tensor(np.random.default_rng(9).uniform(0.0, 1.0, (300, 7)),
                     dtype=torch.float32, device=cuda_device)
    before = tir.probe_chain.launches
    got = tir.probe_chain(x, probe, 64)
    assert tir.probe_chain.launches == before + 1
    want = tir.probe_chain_reference(x, probe, 64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not torch.equal(got, x)


@pytest.mark.cuda
def test_torch_cheap_probe_rate_is_physical(cuda_device):
    """The cheap chain (one FFMA, counted as 2 ops) cannot read faster than
    the card's float32 peak: more would mean the chain was folded."""
    from l2hmc_tpu_torch.benchmarks.vpu_roofline import measure_rates_kernel

    rates, _ = measure_rates_kernel(2048, 256, device=cuda_device)
    assert rates["cheap"] <= 1.05 * 67e12
    assert max(rates.values()) == rates["cheap"]


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [0, 1, 2, 3])
def test_torch_ablated_kernels_equal_zero_nets(cuda_device, layers):
    """ablate_nets=True against the same kernel on zeroed nets (bit for
    bit, the JAX package's gate 1e-6) and against the ablated plain version
    (ATOL); layers 0 is the MLP kernel, 1 to 3 the local kernel (3: the
    deep route)."""
    b, n, K, lt, lx = 5, 3, 3, 8, 8
    if layers:
        params = _local_params(lt, lx, K, 4, layers, cuda_device)
        run = lambda p, **kw: tl2.l2hmc_local_chain(  # noqa: E731
            links, p, None, 0.05, 3.0, K, n, layers, rand_arrays=rand, **kw)
    else:
        params = _params(lt, lx, K, 32, cuda_device)
        run = lambda p, **kw: tl2.l2hmc_chain(  # noqa: E731
            links, p, None, 0.12, 3.0, K, n, rand_arrays=rand, **kw)
    links = torch.tensor(typical_links(np.random.default_rng(10), b, lt, lx),
                         device=cuda_device)
    rand = _rand(11, n, b, lt * lx, False, True, cuda_device)
    zero = copy.deepcopy(params)
    with torch.no_grad():
        for net in (zero.xnet, zero.vnet):
            for p in net.parameters():
                p.zero_()
    counter = tl2.l2hmc_local_chain if layers else tl2.l2hmc_chain
    before = counter.ablate_launches
    got = run(params, ablate_nets=True)
    assert counter.ablate_launches == before + 1
    ref = run(zero)
    eps = 0.05 if layers else 0.12
    want = tl2.l2hmc_chain_reference(links, params, *rand, eps, 3.0, K,
                                     local_layers=layers, ablate_nets=True)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)
    _assert_matches(got, want)


@pytest.mark.cuda
def test_torch_bf16_kernel_matches_plain(cuda_device):
    """precision='bf16' against its plain version.  Both round the same
    float32 activations to bf16 but sum before the rounding in another
    order, so a value on a rounding boundary lands one bf16 step apart:
    the median accept probability agrees as in float32 (ATOL), the largest
    difference within 2e-2 (chip_smoke.py's gate), links within 2e-2."""
    b, n, K, lt, lx = 64, 2, 3, 8, 8
    params = _params(lt, lx, K, 64, cuda_device)
    links = torch.tensor(typical_links(np.random.default_rng(12), b, lt, lx),
                         device=cuda_device)
    rand = _rand(13, n, b, lt * lx, False, True, cuda_device)
    before = tl2.l2hmc_chain.bf16_launches
    got = tl2.l2hmc_chain(links, params, None, 0.12, 3.0, K, n,
                          rand_arrays=rand, precision="bf16")
    assert tl2.l2hmc_chain.bf16_launches == before + 1
    want = tl2.l2hmc_chain_reference(links, params, *rand, 0.12, 3.0, K,
                                     precision="bf16")
    torch.cuda.synchronize()
    us = rand[3]
    keep = ~((us < got[3]) != (us < want[3])).any(dim=0)
    assert int((~keep).sum()) <= 1
    dprob = (got[3][:, keep] - want[3][:, keep]).abs()
    assert float(dprob.median()) <= ATOL
    assert float(dprob.max()) <= 2e-2
    d = torch.remainder(got[0][keep] - want[0][keep] + np.pi,
                        2 * np.pi) - np.pi
    assert float(d.abs().max()) <= 2e-2
    assert torch.equal(got[2][:, keep], want[2][:, keep])


@pytest.mark.cuda
def test_torch_l2hmc_chain_modes_at_8_chains_per_block(cuda_device):
    """bf16 and ablated at 16x16 (8 chains per block), ragged batch of 13:
    bf16 against its plain version as test_torch_bf16_kernel_matches_plain
    holds it; ablated equal to the kernel on zeroed nets bit for bit and
    to its plain version at ATOL."""
    b, n, K, lt, lx = 13, 2, 3, 16, 16
    params = _params(lt, lx, K, 64, cuda_device)
    links = torch.tensor(typical_links(np.random.default_rng(41), b, lt, lx),
                         device=cuda_device)
    rand = _rand(42, n, b, lt * lx, False, True, cuda_device)
    got = tl2.l2hmc_chain(links, params, None, 0.12, 3.0, K, n,
                          rand_arrays=rand, precision="bf16")
    want = tl2.l2hmc_chain_reference(links, params, *rand, 0.12, 3.0, K,
                                     precision="bf16")
    torch.cuda.synchronize()
    us = rand[3]
    keep = ~((us < got[3]) != (us < want[3])).any(dim=0)
    assert int((~keep).sum()) <= 1
    dprob = (got[3][:, keep] - want[3][:, keep]).abs()
    assert float(dprob.median()) <= ATOL
    assert float(dprob.max()) <= 2e-2
    zero = copy.deepcopy(params)
    with torch.no_grad():
        for net in (zero.xnet, zero.vnet):
            for p in net.parameters():
                p.zero_()
    abl = tl2.l2hmc_chain(links, params, None, 0.12, 3.0, K, n,
                          rand_arrays=rand, ablate_nets=True)
    ref = tl2.l2hmc_chain(links, zero, None, 0.12, 3.0, K, n,
                          rand_arrays=rand)
    plain = tl2.l2hmc_chain_reference(links, params, *rand, 0.12, 3.0, K,
                                      ablate_nets=True)
    torch.cuda.synchronize()
    for g, r in zip(abl, ref):
        assert torch.equal(g, r)
    _assert_matches(abl, plain)


def test_torch_kernel_build_needs_nvcc():
    """Without a CUDA toolkit the build raises with the reason; it never
    substitutes another implementation.  The build output goes under the
    repository's ignored build/ directory."""
    assert _cuda.BUILD_ROOT.relative_to(
        Path(__file__).resolve().parents[1]) == Path("build/kernels")
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is present; the build runs on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()
