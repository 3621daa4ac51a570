"""PyTorch port: the HMC chain kernel's plan and plain version at every
lattice the JAX kernel admits, on the CPU.

``csrc/hmc_chain.cu`` runs a lattice on the route ``hmc_chain_plan`` picks
(one chain per pair of warps up to 256 sites, one per block up to 8192, every
owned field in device memory beyond), and its wrapper refuses only what the
JAX kernel's own on-chip estimate refuses.  Here, without a card:

- the plain version against JAX's ``hmc_chain_reference`` at 128x128 (2
  chains, 2 transitions, K=2, hop off and on), atol 2e-4 as in
  tests/test_torch_ops.py;
- the plan of 16x16, 64x64, 96x96, 128x128 and 8x24: admitted, its shared
  memory within the H100's 232448 bytes per block, the expected route, as
  many threads and sites per thread as the lattice needs; at 64x64 two
  chains' blocks fit one SM;
- ``reference_vmem_bytes`` is the JAX kernel's estimate: the calls JAX
  refuses are the ones it puts over 14 MB;
- the wrapper runs its plain version on CPU tensors at 128x128.

The kernel against its plain version on the card: tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.ops import leapfrog as jlf
from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(1)

ATOL = 2e-4
SMEM_PER_SM = 233472      # bytes of shared memory of one H100 SM


def _rand(seed, n, b, d, hop):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d)),
           rng.uniform(size=(n, b))]
    if hop:
        out += [rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    return [a.astype(np.float32) for a in out]


@pytest.mark.parametrize("hop", [False, True])
def test_torch_hmc_chain_reference_matches_jax_at_128(hop):
    b, n, side, K = 2, 2, 128, 2
    links = typical_links(np.random.default_rng(12), b, side, side, sigma=0.27)
    rand = _rand(13, n, b, side * side, hop)
    eps, beta = 0.05, 4.0
    want = jlf.hmc_chain_reference(
        jnp.asarray(links), *rand[:3], eps, beta, K,
        hop_arrays=tuple(rand[3:]) if hop else None)
    t = [torch.from_numpy(a) for a in rand]
    got = tlf.hmc_chain_reference(torch.from_numpy(links), *t[:3], eps, beta,
                                  K, hop_arrays=tuple(t[3:]) if hop else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert 0.05 < float(got[3].mean()) <= 1.0


@pytest.mark.parametrize("lt,lx,route,threads,spt", [
    (16, 16, "warp", 256, 4),
    (8, 24, "warp", 256, 4),
    (64, 64, "block", 512, 8),
    (96, 96, "global", 512, 18),
    (128, 128, "global", 512, 32),
])
def test_torch_hmc_chain_plan(lt, lx, route, threads, spt):
    d = lt * lx
    plan = tlf.hmc_chain_plan(lt, lx)
    assert (plan.route, plan.threads, plan.spt) == (route, threads, spt)
    assert plan.cluster == 1
    assert plan.smem <= tlf.H100_SMEM_OPTIN
    if route == "warp":
        # two warps per chain, every lane's 4 sites cover the lattice; the
        # chains' fields and reduction slots
        assert plan.chains == plan.threads // 64 and 64 * plan.spt >= d
        assert plan.smem == plan.chains * (12 * d + 64)
        assert plan.scratch_fields == 0
    else:
        assert plan.chains == 1 and plan.threads * plan.spt >= d
        assert plan.threads % 32 == 0
    if route == "block":
        # the accepted state's sin/cos P in device memory; two chains fit
        # one SM's shared memory
        assert plan.scratch_fields == 2
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    if route == "global":
        # Y0, Y1 and SP1 (192 KB at 128x128) still in shared memory
        assert not plan.nb_dev and plan.scratch_fields == 6
        assert plan.smem == tlf.HMC_RED_BYTES + 12 * d


def test_torch_hmc_chain_plan_edges():
    """The routes' edges, and the neighbour-read fields going to device
    memory once they no longer fit a block (160x160: 300 KB)."""
    assert tlf.hmc_chain_plan(16, 16).route == "warp"
    assert tlf.hmc_chain_plan(16, 17).route == "block"
    assert tlf.hmc_chain_plan(16, 17).threads == 64
    assert tlf.hmc_chain_plan(64, 64).spt == 8
    assert tlf.hmc_chain_plan(64, 65).spt == 16
    assert tlf.hmc_chain_plan(64, 128).route == "block"
    assert tlf.hmc_chain_plan(64, 129).route == "global"
    big = tlf.hmc_chain_plan(160, 160)
    assert big.route == "global" and big.nb_dev
    assert big.scratch_fields == 9 and big.smem == tlf.HMC_RED_BYTES
    with pytest.raises(ValueError, match="indexing"):
        tlf.hmc_chain_plan(4, 1)


@pytest.mark.parametrize("b,lt,lx,n,hop", [
    (2048, 16, 16, 250, False), (512, 64, 64, 250, True),
    (8, 128, 128, 8, True), (1, 256, 256, 2, False),
    (8, 256, 256, 2, False), (16, 192, 192, 4, True)])
def test_torch_hmc_chain_refuses_what_jax_refuses(b, lt, lx, n, hop):
    """The port's estimate of the JAX kernel's on-chip bytes is JAX's:
    where it exceeds 14 MB the JAX wrapper raises before building its
    kernel, and the port's wrapper raises too (on the card)."""
    est = tlf.reference_vmem_bytes(b, lt * lx, n, hop)
    rows = 20 if hop else 17
    per_row = 4 * (rows * lt * lx + (8 if hop else 6) * n)
    assert est % per_row == 0 and est // per_row >= 1
    refuses = est > tlf.REFERENCE_VMEM_LIMIT
    assert refuses == ((b, lt) in ((8, 256), (16, 192)))
    if refuses:
        with pytest.raises(ValueError, match="VMEM"):
            jlf.hmc_chain_pallas(jnp.zeros((b, lt, lx, 2)), None, 0.1, 4.0, 2,
                                 n, interpret=True,
                                 rand_arrays=(None,) * (5 if hop else 3),
                                 hop=hop)


def test_torch_hmc_chain_wrapper_cpu_at_128():
    """CPU tensors run the plain version, at a lattice the former kernel
    refused (its ten fields per chain did not fit shared memory)."""
    b, n, side = 2, 2, 128
    links = torch.from_numpy(typical_links(np.random.default_rng(14), b, side,
                                           side, sigma=0.27))
    rand = [torch.from_numpy(a) for a in _rand(15, n, b, side * side, True)]
    got = tlf.hmc_chain(links, None, 0.05, 4.0, 2, n, hop=True,
                        rand_arrays=rand)
    want = tlf.hmc_chain_reference(links, *rand[:3], 0.05, 4.0, 2,
                                   hop_arrays=tuple(rand[3:]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
