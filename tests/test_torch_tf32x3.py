"""PyTorch port: the chain kernels' arithmetic and layouts, on the CPU.

``csrc/l2hmc_chain.cu`` runs the MLP conditioner's products on tensor cores
as 3xTF32 (``tf32x3_matmul`` is its plain form), reads its weights in the
fragment order of ``mma_pack``, and runs as many chains per block as
``chains_per_block`` picks; ``csrc/l2hmc_local_chain.cu`` runs a local net
padded to 4 or 8 channels (``pad_local_params``).  None of that needs the
card to check:

- ``tf32_round`` is ``cvt.rna.tf32.f32`` (nearest, ties away from zero);
- on the shipped champion's weights and features of near-equilibrium
  links, at full width (6d = 1536, h = 64), the 3xTF32 products lie as close
  to float64 as plain float32 (RMS within 2x), a single TF32 pass at least
  10x further;
- an emulation of the kernel's chunk walk over ``mma_pack``'s output gives
  W^T f to float64 rounding;
- the choice of chains per block: 8 at 16x16, 4 at 24x24, 2 at 32x32, a
  ValueError naming shared memory at 48x48;
- padding a local net is exact: the plain chain on the padded net equals
  the unpadded one (atol 1e-6; bit for bit at these widths), and still
  matches the JAX reference (atol 2e-4, as tests/test_torch_local.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics.l2hmc import DynamicsConfig as JDynamicsConfig
from l2hmc_tpu.dynamics.l2hmc import init_dynamics_params
from l2hmc_tpu.networks.nets import LocalNetSpec as JLocalNetSpec
from l2hmc_tpu.networks.nets import make_local_flat_net as j_make_local
from l2hmc_tpu.ops import l2hmc_kernel as jl2
from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
from l2hmc_tpu_torch.ops.leapfrog import _grad_flat, _potential_fields
from l2hmc_tpu_torch.train import checkpoint as tck
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

ATOL = 2e-4          # chain states and probabilities against JAX
PAD_ATOL = 1e-6      # padded against unpadded plain chain


def _bits(x):
    return torch.tensor([x], dtype=torch.float32)


def test_torch_tf32_round_is_cvt_rna():
    one = 1.0
    cases = [
        (one, one),
        (one + 2.0 ** -11, one + 2.0 ** -10),              # tie: away
        (-(one + 2.0 ** -11), -(one + 2.0 ** -10)),
        (one + 2.0 ** -11 - 2.0 ** -23, one),              # below the tie
        (one + 3 * 2.0 ** -11, one + 2 * 2.0 ** -10),      # tie: away
        (float("inf"), float("inf")),
        (float(np.finfo(np.float32).max), float("inf")),
        (0.0, 0.0),
    ]
    for x, want in cases:
        assert float(tl2.tf32_round(_bits(x))) == want, x
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096) * 10.0,
                     dtype=torch.float32)
    r = tl2.tf32_round(x)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(tl2.tf32_round(r), r)
    assert bool(((x - r).abs() <= 2.0 ** -11 * x.abs()).all())
    hi, lo = tl2.tf32_split(x)
    assert torch.equal(tl2.tf32_round(lo), lo)
    assert bool(((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all())


def _champion_products():
    """{(net, product): (a, b)}: the champion's three products per net on
    the features of 64 near-equilibrium 16x16 chains (VNet: cos, sin,
    force; XNet: momenta and held cos/sin)."""
    _, params = tck.load_champion(device="cpu")
    d = 256
    w = dict(zip(tl2.WEIGHT_NAMES, tl2.pack_weights(params, 2 * d)))
    rng = np.random.default_rng(0)
    links = torch.tensor(typical_links(rng, 64, 16, 16, sigma=0.3))
    y0, y1 = links[..., 0].reshape(64, d), links[..., 1].reshape(64, d)
    _, sinp, _, _ = _potential_fields(y0, y1, 16)
    g0, g1 = _grad_flat(sinp, 16)
    m0, m1 = w["mask0"][0][None], w["mask1"][0][None]
    mom = torch.tensor(rng.standard_normal((2, 64, d)), dtype=torch.float32)
    feats = {
        "v": torch.cat([torch.cos(y0), torch.cos(y1), torch.sin(y0),
                        torch.sin(y1), 4.0 * g0, 4.0 * g1], 1),
        "x": torch.cat([mom[0], mom[1], m0 * torch.cos(y0),
                        m1 * torch.cos(y1), m0 * torch.sin(y0),
                        m1 * torch.sin(y1)], 1),
    }
    out = {}
    for net, f in feats.items():
        h1 = torch.relu(f @ w[net + "in"] + w[net + "b"])
        h2 = torch.relu(h1 @ w[net + "h_w"] + w[net + "h_b"])
        out[(net, "in")] = (f, w[net + "in"])
        out[(net, "trunk")] = (h1, w[net + "h_w"])
        out[(net, "head")] = (h2, w[net + "head"])
    return out


_PRODUCTS = None


def _rms_err(fn, a, b):
    ref = a.double() @ b.double()
    return float((fn(a, b).double() - ref).pow(2).mean().sqrt())


@pytest.mark.parametrize("net", ["x", "v"])
@pytest.mark.parametrize("product", ["in", "trunk", "head"])
def test_torch_tf32x3_products_match_float32_on_champion(net, product):
    global _PRODUCTS
    if _PRODUCTS is None:
        _PRODUCTS = _champion_products()
    a, b = _PRODUCTS[(net, product)]
    assert tuple(a.shape) == (64, 1536 if product == "in" else 64)
    f32 = _rms_err(torch.matmul, a, b)
    x3 = _rms_err(tl2.tf32x3_matmul, a, b)
    x1 = _rms_err(tl2.tf32_matmul, a, b)
    if not bool((a @ b).any()):
        # the champion's VNet trunk is dead on equilibrium links: its head
        # input is exactly zero, and every form gives exact zeros
        assert (net, product) == ("v", "head")
        assert f32 == x3 == x1 == 0.0
        return
    assert x3 <= 2.0 * f32, (x3, f32)
    assert x1 >= 10.0 * x3, (x1, x3)


def _emulate_chunks(mm, geo, feats, c):
    """The kernel's walk over one net's chunks (float64): warp w's tile q of
    a narrow chunk j at tile row w % mt + 8 (q // kpc) and k-step (j * wp +
    w // mt) * kpc + q % kpc, with wp = 8/mt k-groups and kpc = 4 k-steps up
    to mt = 8 (hp <= 128), wp = 1 and kpc = 2 at mt = 16 (hp = 256: two tile
    rows per warp); head chunk (group, kq) at tile row group * 8 + w, k-step
    kq * 4 + q.  Returns (in-projection, trunk of it, head of that), (c, .)
    each."""
    ks = geo.ks
    e = 4 if ks == 8 else 8
    tiles = mm.double().numpy().reshape(-1, 8, 4, 32, e)
    rows, cols = (t.numpy() for t in tl2._frag_index(ks))

    def a_tile(j, w, q):
        a = np.zeros((16, ks))
        a[rows, cols] = tiles[j, w, q]
        return a

    def narrow(j0, nch, bmat):
        out = np.zeros((geo.hp, c))
        wp = max(1, 8 // geo.mt)
        kpc = 4 if geo.mt <= 8 else 2
        for j in range(nch):
            for w in range(8):
                for q in range(4):
                    m0 = 16 * (w % geo.mt + 8 * (q // kpc))
                    k0 = ((j * wp + w // geo.mt) * kpc + q % kpc) * ks
                    out[m0:m0 + 16] += a_tile(j0 + j, w, q) @ bmat[k0:k0 + ks]
        return out

    b_in = np.zeros((geo.kp_in, c))
    b_in[:feats.shape[1]] = feats.T
    pre = narrow(0, geo.n_in, b_in)
    b_tr = np.zeros((geo.kp_tr, c))
    b_tr[:geo.hp] = pre
    pre2 = narrow(geo.n_in, geo.n_tr, b_tr)
    head = np.zeros((geo.mp_hd, c))
    j0 = geo.n_in + geo.n_tr
    for j in range(geo.n_hd):
        grp, kq = divmod(j, geo.kq)
        for w in range(8):
            m0 = (grp * 8 + w) * 16
            for q in range(4):
                k0 = (kq * 4 + q) * ks
                head[m0:m0 + 16] += a_tile(j0 + j, w, q) @ pre2[k0:k0 + ks]
    return pre.T, pre2.T, head[:feats.shape[1]].T


@pytest.mark.parametrize("d,h,precision", [(24, 32, "f32"), (64, 64, "f32"),
                                           (64, 16, "f32"),
                                           (64, 64, "bf16"),
                                           (24, 48, "bf16"),
                                           (24, 256, "f32"),
                                           (16, 200, "f32"),
                                           (24, 256, "bf16"),
                                           (16, 150, "bf16")])
def test_torch_mma_pack_layout_gives_the_products(d, h, precision):
    """Each net's three operands packed in chunk order: the kernel's walk
    over them (emulated) is W^T f, and each chunk is 16 KB."""
    g = torch.Generator().manual_seed(d + h)
    xin, hw, head = (torch.randn(s, generator=g)
                     for s in ((6 * d, h), (h, h), (h, 6 * d)))
    if precision == "bf16":
        xin, hw, head = (t.bfloat16().float() for t in (xin, hw, head))
    geo = tl2.mma_geometry(d, h, precision)
    mm = tl2.mma_pack(xin, hw, head, d, precision)
    assert mm.dtype == (torch.bfloat16 if precision == "bf16"
                        else torch.float32)
    assert mm.numel() * mm.element_size() == (
        geo.n_in + geo.n_tr + geo.n_hd) * tl2.CHUNK_BYTES
    assert geo.bs % 32 == 4 and geo.hs % 32 == 4
    c = 3
    f = torch.randn((c, 6 * d), generator=g).double()
    pre, pre2, out = _emulate_chunks(mm.float(), geo, f.numpy(), c)
    want = f @ xin.double()
    np.testing.assert_allclose(pre[:, :h], want.numpy(), atol=1e-10)
    assert not pre[:, h:].any()                  # padded units are zero
    want = want @ hw.double()
    np.testing.assert_allclose(pre2[:, :h], want.numpy(), atol=1e-9)
    np.testing.assert_allclose(out, (want @ head.double()).numpy(),
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("h", [129, 200, 256])
def test_torch_mma_geometry_at_hidden_256(h, precision):
    """Hidden widths above 128 pad to hp = 256: 16 tile rows, two per
    product warp (one k-group), and the champion's 16x16 lattice still runs
    8 chains per block with a ring of at least 2 chunks, its products'
    partials (16 slots of 128 floats) counted in the shared memory."""
    geo = tl2.mma_geometry(256, h, precision)
    ks = 16 if precision == "bf16" else 8
    assert (geo.hp, geo.mt, geo.rpw, geo.wp) == (256, 16, 2, 1)
    assert geo.kq == 256 // (4 * ks)
    assert geo.kp_tr == 256 and geo.hs == 260
    assert geo.n_tr == 256 // (2 * ks)
    c, stages = tl2.chains_per_block(16, 16, h, precision)
    assert c == 8 and 2 <= stages <= tl2.MAX_STAGES
    assert tl2.chain_smem_bytes(c, 256, geo, stages) <= tl2.H100_SMEM_OPTIN
    assert tl2.chain_smem_bytes(c, 256, geo, stages + 1) > \
        tl2.H100_SMEM_OPTIN or stages == tl2.MAX_STAGES
    narrow = tl2.mma_geometry(256, 128, precision)
    assert tl2.chain_smem_bytes(c, 256, geo, stages) - tl2.chain_smem_bytes(
        c, 256, narrow, stages) == 4 * (8 * 128 + 2 * c * (260 - 132))


def test_torch_chains_per_block_from_the_lattice():
    """The most chains per block (8, 4, 2) whose fields, operands and a ring
    of 2 weight chunks fit the H100's 227 KB; more ring stages where room
    is left; 48x48 does not fit 2 chains and raises."""
    assert tl2.chains_per_block(16, 16, 64) == (8, 7)
    assert tl2.chains_per_block(24, 24, 64)[0] == 4
    assert tl2.chains_per_block(32, 32, 64)[0] == 2
    assert tl2.chains_per_block(16, 16, 64, max_chains=4)[0] == 4
    assert tl2.chains_per_block(16, 16, 64, "bf16")[0] == 8
    for lt, lx in ((16, 16), (24, 24), (32, 32), (8, 8), (4, 6)):
        c, stages = tl2.chains_per_block(lt, lx, 64)
        geo = tl2.mma_geometry(lt * lx, 64)
        assert 2 <= stages <= tl2.MAX_STAGES
        assert tl2.chain_smem_bytes(c, lt * lx, geo, stages) <= \
            tl2.H100_SMEM_OPTIN
        if c < 8:   # twice the chains would not fit 2 stages
            assert tl2.chain_smem_bytes(2 * c, lt * lx, geo, 2) > \
                tl2.H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="shared memory"):
        tl2.chains_per_block(48, 48, 16)
    with pytest.raises(ValueError, match="hidden"):
        tl2.chains_per_block(16, 16, 300)


# --- the local kernel's channel padding --------------------------------------

LT, LX, K, B, N = 8, 8, 3, 4, 2


def _local_port_params(channels, layers, seed):
    cfg = tgauge.GaugeConfig(time_size=LT, space_size=LX, num_steps=K,
                             network_arch="local_flat", num_filters=channels,
                             local_layers=layers, merge_v_halves=True,
                             group="u1", bounded_q=True, eps_init=0.05)
    g = torch.Generator().manual_seed(seed)
    params = tgauge.init_params(cfg, g, device="cpu")
    with torch.no_grad():
        for net in (params.xnet, params.vnet):
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return params


def _rand(seed, n=N, b=B, d=LT * LX):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d)),
           rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    return [torch.tensor(a, dtype=torch.float32) for a in out]


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("channels", [2, 3, 5])
def test_torch_local_padding_is_exact(channels, layers):
    """(A 1-channel net is padded too, but the plain version's einsum over a
    single channel takes another path and rounds S, T, Q an ulp apart, which
    the chain carries to ~1e-6 on an accept probability.)"""
    params = _local_port_params(channels, layers, 20 + channels)
    kc = tl2.local_kernel_channels(channels)
    assert kc == (4 if channels <= 4 else 8)
    padded = tl2.pad_local_params(params, kc)
    for net in (padded.xnet, padded.vnet):
        st = net.stencils()
        assert st[0].w.shape[2] == kc and net.head.w.shape[0] == kc
        assert not bool(st[0].w[..., channels:].any())
        assert not bool(net.head.w[channels:].any())
    links = torch.tensor(typical_links(np.random.default_rng(3), B, LT, LX,
                                       sigma=0.27))
    rand = _rand(4)
    want = tl2.l2hmc_chain_reference(links, params, *rand, 0.05, 4.0, K,
                                     local_layers=layers)
    got = tl2.l2hmc_chain_reference(links, padded, *rand, 0.05, 4.0, K,
                                    local_layers=layers)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=PAD_ATOL, rtol=0)
    assert 0.05 < float(want[3].mean()) <= 1.0
    flat = tl2.local_kernel_weights(
        tl2.pack_local_weights(padded, 2 * LT * LX, layers), layers)
    per_net = flat.numel() // 2
    assert per_net % 4 == 0
    hw = padded.xnet.head.w.detach()
    at = 5 * 6 * kc + 3 * kc + (layers - 1) * (5 * kc * kc + kc)
    assert torch.equal(flat[at:at + 6 * kc], hw.t().reshape(-1))
    assert per_net == tl2.local_net_stride(kc, layers)


@pytest.mark.parametrize("lt,lx,c,layers,deep", [
    (64, 64, 4, 1, False), (64, 64, 4, 2, False), (64, 64, 8, 1, False),
    (64, 64, 8, 2, True), (64, 64, 4, 3, True), (64, 64, 8, 5, True),
    (8, 8, 8, 2, False), (8, 8, 4, 3, True)])
def test_torch_local_chain_route(lt, lx, c, layers, deep):
    """One or two layers keep every field in shared memory where the block
    fits the H100's 227 KB (not c8L2 at 64x64: 288 KB); deeper nets and
    c8L2 at 64x64 run the deep route, whose hidden outputs live in device
    memory and whose block holds the ten fields and the weights."""
    got_deep, smem = tl2.local_chain_route(lt, lx, c, layers)
    assert got_deep == deep
    assert smem == tl2.local_chain_smem_bytes(lt, lx, c, layers, deep)
    assert smem <= tl2.H100_SMEM_OPTIN
    if deep and layers == 2:
        assert tl2.local_chain_smem_bytes(lt, lx, c, 2, False) > \
            tl2.H100_SMEM_OPTIN
    d = lt * lx
    assert smem >= 4 * (10 * d + 2 * tl2.local_net_stride(c, layers))
    with pytest.raises(ValueError, match="shared memory"):
        tl2.local_chain_route(96, 96, c, layers)


@pytest.mark.parametrize("layers", [1, 2])
def test_torch_local_padded_chain_matches_jax(layers):
    """A 3-channel JAX local net against the port's plain chain on the same
    net padded to the kernel's 4 channels (8x8, K=3, hop off)."""
    c = 3
    kw = dict(channels=c, num_layers=layers, bounded_q=True)
    (xi, _), (vi, _) = (
        j_make_local(JLocalNetSpec(LT, LX, factor=2.0, x_channels=4, **kw)),
        j_make_local(JLocalNetSpec(LT, LX, factor=1.0, v_channels=4, **kw)))
    cfg = JDynamicsConfig(x_dim=2 * LT * LX, num_steps=K, group="u1",
                          merge_v_halves=True)
    jparams = init_dynamics_params(jax.random.PRNGKey(11), cfg, xi, vi, 0.05)
    rng = np.random.default_rng(200 + layers)

    def bump(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.05 * rng.standard_normal(a.shape),
            jnp.float32), tree)

    jparams = jparams._replace(xnet=bump(jparams.xnet),
                               vnet=bump(jparams.vnet))
    gcfg = tgauge.GaugeConfig(time_size=LT, space_size=LX, num_steps=K,
                              network_arch="local_flat", num_filters=c,
                              local_layers=layers, merge_v_halves=True,
                              group="u1", bounded_q=True, eps_init=0.05)
    params = tck.params_from_numpy(jparams, gcfg, device="cpu")
    padded = tl2.pad_local_params(params, tl2.local_kernel_channels(c))
    links = typical_links(np.random.default_rng(6), B, LT, LX, sigma=0.27)
    rand = _rand(7)
    with jax.disable_jit():
        want = jl2.l2hmc_chain_reference(
            jnp.asarray(links), jparams, *[r.numpy() for r in rand], 0.05,
            4.0, K, local_layers=layers)
    got = tl2.l2hmc_chain_reference(torch.from_numpy(links), padded, *rand,
                                    0.05, 4.0, K, local_layers=layers)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=ATOL)
    assert 0.05 < float(got[3].mean()) <= 1.0
