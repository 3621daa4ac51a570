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
- the route plan: the cluster route (each chain's rows over 4 or 2 CTAs,
  ``csrc/l2hmc_chain_cluster.cu``) up to hidden 128 where its slabs fit and
  add no wave, the block route otherwise; the slab packing's walk, its
  partial sums added in rank order, gives the same products;
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


class _ChunkWalk:
    """The kernel's walk over one net's chunks (float64): warp w's tile q of
    a narrow chunk j at tile row w % mt + 8 (q // kpc) and k-step (j * wp +
    w // mt) * kpc + q % kpc, with wp = 8/mt k-groups and kpc = 4 k-steps up
    to mt = 8 (hp <= 128), wp = 1 and kpc = 2 at mt = 16 (hp = 256: two tile
    rows per warp); head chunk (group, kq) at tile row group * 8 + w, k-step
    kq * 4 + q.  ``mm`` is one net's chunks of one slab (or of the whole
    lattice)."""

    def __init__(self, mm, geo):
        self.geo, self.ks = geo, geo.ks
        e = 4 if geo.ks == 8 else 8
        self.tiles = mm.double().numpy().reshape(-1, 8, 4, 32, e)
        self.rows, self.cols = (t.numpy() for t in tl2._frag_index(geo.ks))

    def a_tile(self, j, w, q):
        a = np.zeros((16, self.ks))
        a[self.rows, self.cols] = self.tiles[j, w, q]
        return a

    def narrow(self, j0, nch, bmat):
        """(hp, c) partial sums of chunks j0 .. j0 + nch - 1 on bmat (kp, c),
        added in the kernel's chunk order."""
        geo, ks = self.geo, self.ks
        out = np.zeros((geo.hp, bmat.shape[1]))
        wp = max(1, 8 // geo.mt)
        kpc = 4 if geo.mt <= 8 else 2
        for j in range(nch):
            for w in range(8):
                for q in range(4):
                    m0 = 16 * (w % geo.mt + 8 * (q // kpc))
                    k0 = ((j * wp + w // geo.mt) * kpc + q % kpc) * ks
                    out[m0:m0 + 16] += (self.a_tile(j0 + j, w, q)
                                        @ bmat[k0:k0 + ks])
        return out

    def heads(self, pre2):
        geo, ks = self.geo, self.ks
        head = np.zeros((geo.mp_hd, pre2.shape[1]))
        j0 = geo.n_in + geo.n_tr
        for j in range(geo.n_hd):
            grp, kq = divmod(j, geo.kq)
            for w in range(8):
                m0 = (grp * 8 + w) * 16
                for q in range(4):
                    k0 = (kq * 4 + q) * ks
                    head[m0:m0 + 16] += (self.a_tile(j0 + j, w, q)
                                         @ pre2[k0:k0 + ks])
        return head


def _emulate_chunks(mm, geo, feats, c, slabs=1):
    """The kernel's products over ``mma_pack``'s chunks, on a (c, 6d)
    feature batch; ``slabs > 1`` walks the cluster route's CTAs: slab r's
    chunks on its six feature blocks' columns, the in-projection partials
    added over the slabs in rank order, the trunk (each slab's copy) on
    their sum, each slab's heads on the trunk's output.  Returns
    (in-projection, trunk of it, heads of that), (c, .) each."""
    d = feats.shape[1] // 6
    dl = d // slabs
    per = mm.numel() // slabs
    walks = [_ChunkWalk(mm[r * per:(r + 1) * per], geo) for r in range(slabs)]
    pre = np.zeros((geo.hp, c))
    for r, walk in enumerate(walks):
        cols = (np.arange(6)[:, None] * d + r * dl
                + np.arange(dl)[None, :]).reshape(-1)
        b_in = np.zeros((geo.kp_in, c))
        b_in[:6 * dl] = feats[:, cols].T
        pre += walk.narrow(0, geo.n_in, b_in)
    b_tr = np.zeros((geo.kp_tr, c))
    b_tr[:geo.hp] = pre
    pre2s = [walk.narrow(geo.n_in, geo.n_tr, b_tr) for walk in walks]
    for p2 in pre2s[1:]:
        np.testing.assert_array_equal(p2, pre2s[0])
    head = np.zeros((6, slabs, dl, c))
    for r, walk in enumerate(walks):
        head[:, r] = walk.heads(pre2s[0])[:6 * dl].reshape(6, dl, c)
    return pre.T, pre2s[0].T, head.reshape(6 * d, c).T


_LAYOUTS = [(24, 32, "f32"), (64, 64, "f32"), (64, 16, "f32"),
            (64, 64, "bf16"), (24, 48, "bf16"), (24, 256, "f32"),
            (16, 200, "f32"), (24, 256, "bf16"), (16, 150, "bf16")]


@pytest.mark.parametrize("slabs", [1, 2, 4])
@pytest.mark.parametrize("d,h,precision", _LAYOUTS)
def test_torch_mma_pack_layout_gives_the_products(d, h, precision, slabs):
    """Each net's three operands packed in chunk order: the kernel's walk
    over them (emulated) is W^T f, and each chunk is 16 KB.  With ``slabs``
    (the cluster route's CTAs) each slab holds its share of the
    in-projection's columns and the heads' rows and a copy of the trunk, and
    the slabs' partial sums, added in rank order, give the same products."""
    g = torch.Generator().manual_seed(d + h)
    xin, hw, head = (torch.randn(s, generator=g)
                     for s in ((6 * d, h), (h, h), (h, 6 * d)))
    if precision == "bf16":
        xin, hw, head = (t.bfloat16().float() for t in (xin, hw, head))
    geo = tl2.mma_geometry(d // slabs, h, precision)
    mm = tl2.mma_pack(xin, hw, head, d, precision, slabs)
    assert mm.dtype == (torch.bfloat16 if precision == "bf16"
                        else torch.float32)
    assert mm.numel() * mm.element_size() == slabs * (
        geo.n_in + geo.n_tr + geo.n_hd) * tl2.CHUNK_BYTES
    assert geo.bs % 32 == 4 and geo.hs % 32 == 4
    c = 3
    f = torch.randn((c, 6 * d), generator=g).double()
    pre, pre2, out = _emulate_chunks(mm.float(), geo, f.numpy(), c, slabs)
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


# --- the route plan: the block route or the cluster route ---------------------

H100_CLUSTERS = tl2.H100_ACTIVE_CLUSTERS      # {4: 30, 2: 66}


def _plan(lt, lx, b, active=H100_CLUSTERS, h=64, precision="f32", **kw):
    return tl2.chain_route_plan(lt, lx, h, precision, b,
                                active_clusters=lambda cl, cc, smem: active[cl],
                                **kw)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("h", [64, 256])
@pytest.mark.parametrize("lt,lx,b,cl,chains", [
    (16, 16, 960, 4, 32), (16, 16, 2048, 2, 16), (8, 8, 960, 4, 32),
    (8, 8, 2048, 2, 32), (24, 24, 960, 4, 16), (24, 24, 2048, 2, 8),
    (32, 32, 960, 4, 8), (32, 32, 2048, 1, 2), (12, 16, 960, 4, 32),
    (12, 16, 2048, 2, 16)])
def test_torch_chain_route_plan(lt, lx, b, cl, chains, h, precision):
    """On an H100 (132 SMs; 30 clusters of 4 and 66 of 2 at once), up to
    hidden 128: the cluster route with 4 CTAs per cluster and the most
    chains per CTA (32, 16, 8) whose slab fits 227 KB with a ring of at
    least 2 chunks, where that takes no more waves than the block route;
    else 2 CTAs per cluster (2048 chains: 64 clusters of 4 would take three
    waves); else the block route (32x32).  Hidden 256 and the ablated mode
    (cluster=False) keep the block route, which is chains_per_block's."""
    d = lt * lx
    plan = _plan(lt, lx, b, h=h, precision=precision)
    block = _plan(lt, lx, b, h=h, precision=precision, cluster=False)
    assert (block.route, block.cl) == ("block", 1)
    assert (block.chains, block.stages) == tl2.chains_per_block(
        lt, lx, h, precision)
    assert block.geo == tl2.mma_geometry(d, h, precision)
    assert block.waves == -(-(-(-b // block.chains)) // tl2.H100_SMS)
    if h > 128 or cl == 1:
        assert plan == block
        return
    assert (plan.route, plan.cl, plan.chains) == ("cluster", cl, chains)
    geo = tl2.mma_geometry(d // cl, h, precision)
    assert plan.geo == geo and geo.mt <= tl2.CLUSTER_MAX_MT
    assert plan.smem == tl2.cluster_smem_bytes(chains, d // cl, geo,
                                               plan.stages)
    assert plan.smem <= tl2.H100_SMEM_OPTIN
    assert 2 <= plan.stages <= tl2.MAX_STAGES
    assert plan.stages == tl2.MAX_STAGES or tl2.cluster_smem_bytes(
        chains, d // cl, geo, plan.stages + 1) > tl2.H100_SMEM_OPTIN
    if chains < tl2.CLUSTER_CHAINS[0]:   # twice the chains do not fit
        assert tl2.cluster_smem_bytes(2 * chains, d // cl, geo, 2) > \
            tl2.H100_SMEM_OPTIN
    assert plan.waves == -(-(-(-b // chains)) // H100_CLUSTERS[cl])
    assert plan.waves <= block.waves
    assert plan == tl2.chain_route_plan(lt, lx, h, precision, b)  # defaults


@pytest.mark.parametrize("lt,lx,active,want", [
    (6, 8, H100_CLUSTERS, ("cluster", 2, 32)),     # lt % 4 != 0: pairs
    (14, 16, H100_CLUSTERS, ("cluster", 2, 16)),
    (9, 9, H100_CLUSTERS, ("block", 1, 8)),        # rows do not split
    (5, 8, H100_CLUSTERS, ("block", 1, 8)),
    (16, 16, {4: 32, 2: 66}, ("cluster", 4, 32)),  # 64 clusters, two waves
    (16, 16, {4: 30, 2: 66}, ("cluster", 2, 16)),  # 4s would add a wave
    (16, 16, {4: 30, 2: 60}, ("block", 1, 8)),
    (16, 16, {4: 0, 2: 0}, ("block", 1, 8)),       # no cluster fits the card
])
def test_torch_chain_route_plan_falls_back(lt, lx, active, want):
    """2048 chains: clusters of 2 where the rows split in two but not four;
    the block route where they split in neither, or where every cluster
    shape would take more waves than the block route's 2 (256 blocks on 132
    SMs)."""
    plan = _plan(lt, lx, 2048, active)
    assert (plan.route, plan.cl, plan.chains) == want
    if plan.route == "cluster":
        assert lt % plan.cl == 0


def test_torch_chain_route_plan_adds_no_wave():
    """Over lattices, batches and co-resident cluster counts the chosen
    route never takes more waves than the block route; a lattice that fits
    neither route raises naming the shared memory."""
    for lt, lx in ((16, 16), (8, 8), (24, 24), (32, 32), (12, 16), (6, 8),
                   (4, 6), (9, 9)):
        for b in (1, 13, 100, 300, 2048, 4096, 8192):
            for active in (H100_CLUSTERS, {4: 32, 2: 66}, {4: 30, 2: 60},
                           {4: 8, 2: 16}):
                plan = _plan(lt, lx, b, active)
                block = _plan(lt, lx, b, active, cluster=False)
                assert plan.waves <= block.waves, (lt, lx, b, active)
                units = -(-b // plan.chains)
                at_once = active[plan.cl] if plan.cl > 1 else tl2.H100_SMS
                assert plan.waves == -(-units // at_once)
    assert (_plan(16, 16, 13).cl, _plan(16, 16, 13).waves) == (4, 1)
    with pytest.raises(ValueError, match="shared memory"):
        _plan(48, 48, 1)


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
