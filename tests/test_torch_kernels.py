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
the same sin P exactly, dlinks to 1e-5 of its largest entry.
"""

import copy
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.ops import _cuda
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


def _assert_matches(got, want):
    d = torch.remainder(got[0] - want[0] + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) <= ATOL
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("lt,lx", [(4, 6), (16, 16), (64, 64)])
def test_torch_hmc_chain_kernel_matches_plain(cuda_device, lt, lx, hop):
    b, n = 16, 4
    links = torch.tensor(typical_links(np.random.default_rng(1), b, lt, lx),
                         device=cuda_device)
    rand = _rand(2, n, b, lt * lx, hop, False, cuda_device)
    before = tlf.hmc_chain.launches
    got = tlf.hmc_chain(links, None, 0.1, 3.0, 4, n, hop=hop,
                        rand_arrays=rand)
    assert tlf.hmc_chain.launches == before + 1
    want = tlf.hmc_chain_reference(links, *rand[:3], 0.1, 3.0, 4,
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
@pytest.mark.parametrize("layers", [1, 2])
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
def test_torch_local_chain_kernel_rejects_what_it_cannot_run(cuda_device):
    links = torch.zeros((1, 64, 64, 2), device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    # c=8, L=2 at 64x64: 18 fields of 16 KB per chain
    big = _local_params(64, 64, 2, 8, 2, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tl2.l2hmc_local_chain(links, big, gen, 0.1, 2.0, 2, 1, 2)
    wide = _local_params(8, 8, 2, 9, 1, cuda_device)
    with pytest.raises(ValueError, match="channels"):
        tl2.l2hmc_local_chain(links[:, :8, :8].contiguous(), wide, gen, 0.1,
                              2.0, 2, 1, 1)
    deep = _local_params(8, 8, 2, 4, 3, cuda_device)
    with pytest.raises(ValueError, match="num_layers"):
        tl2.l2hmc_local_chain(links[:, :8, :8].contiguous(), deep, gen, 0.1,
                              2.0, 2, 1, 3)


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
    with pytest.raises(ValueError, match="shared memory"):
        tlf.hmc_chain(torch.zeros((1, 128, 128, 2), device=cuda_device),
                      torch.Generator().manual_seed(0), 0.1, 2.0, 2, 1)
    # two 48x48 chains need 16 * 2 * 2304 floats (295 KB) per block
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,lt,lx", [(3, 2, 2), (5, 4, 6), (7, 16, 16),
                                     (2, 64, 64), (1, 3, 37)])
def test_torch_wilson_kernels_match_plain(cuda_device, b, lt, lx):
    links, g, w = _wilson_inputs(b * lt + lx, b, lt, lx, cuda_device)
    before = (tw.wilson_forward.launches, tw.wilson_backward.launches,
              tw.wilson_double_backward.launches)
    s_k, sinp_k = tw.wilson_forward(links)
    s_p, sinp_p = tw.wilson_forward_reference(links)
    f_k = tw.wilson_backward(sinp_p, g)
    dl_k, dg_k = tw.wilson_double_backward(links, g, w)
    dl_p, dg_p = tw.wilson_double_backward_reference(links, g, w)
    torch.cuda.synchronize()
    assert (tw.wilson_forward.launches, tw.wilson_backward.launches,
            tw.wilson_double_backward.launches) == tuple(
                n + 1 for n in before)
    p = tw._plaq_sums(links[..., 0], links[..., 1])
    r = (w[..., 0] - torch.roll(w[..., 0], -1, -1) - w[..., 1]
         + torch.roll(w[..., 1], -1, -2))
    s_scale = torch.sum(1.0 - torch.cos(p), dim=(1, 2))
    dg_scale = torch.sum(torch.abs(r * torch.sin(p)), dim=(1, 2))
    assert bool(((s_k - s_p).abs() <= 1e-5 * s_scale).all())
    assert float((sinp_k - sinp_p).abs().max()) <= 1e-6
    assert torch.equal(f_k, tw.wilson_backward_reference(sinp_p, g))
    assert float((dl_k - dl_p).abs().max()) <= 1e-5 * float(
        dl_p.abs().max())
    assert bool(((dg_k - dg_p).abs() <= 1e-5 * dg_scale).all())


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
