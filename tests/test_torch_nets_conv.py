"""PyTorch port, networks/nets.py: the periodic CNN and the local image net
against the JAX package's ``make_conv_net`` / ``make_local_net``.

Parameters come from the JAX ``init`` (seeded), perturbed by a seeded
N(0, 0.05^2) so that every head has non-trivial outputs, and are carried
across by ``from_reference_leaf`` (HWIO -> OIHW conv weights; the conv
net's dense rows from the NHWC flatten order to NCHW's).  Inputs are
numpy-seeded.  Tolerance: rtol 1e-5 (atol 1e-6 for outputs near 0), float32
on both sides with different convolution summation orders.
``periodic_pad_2d`` is compared exactly, ``local_response_norm`` to one
float32 ulp (rtol 2.4e-7): the shifted sums run in the reference's order,
and only the final ``pow`` comes from another libm (XLA's and torch's
float32 ``pow`` differ in the last bit on ~1% of inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.networks import nets as jnets
from l2hmc_tpu_torch.networks import nets as tnets

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B = 4


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _bumped(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape), jnp.float32),
        params)


def _flat(net):
    out = {}
    for k, v in net.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _load(module, jparams):
    module.load_state_dict({
        k: torch.from_numpy(np.array(module.from_reference_leaf(
            k, np.asarray(v)), np.float32))
        for k, v in _flat(jparams).items()}, strict=True)


def _inputs(seed, lt, lx, v_ch, x_ch):
    rng = np.random.default_rng(seed)
    d = 2 * lt * lx
    v = rng.standard_normal((B, d * v_ch // 2)).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, (B, d * x_ch // 2)).astype(np.float32)
    t = rng.standard_normal((B, 2)).astype(np.float32)
    return v, x, t


def _compare(jout, tout):
    for name, w, g in zip("STQ", jout, tout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kernel", [1, 2, 3, 4])
@pytest.mark.parametrize("lt,lx", [(4, 4), (5, 3)])
def test_torch_periodic_pad_2d_matches_jax(kernel, lt, lx):
    a = np.random.default_rng(kernel).standard_normal(
        (2, lt, lx, 3)).astype(np.float32)
    want = np.asarray(jnets.periodic_pad_2d(jnp.asarray(a), kernel))
    got = tnets.periodic_pad_2d(_nhwc_to_nchw(a), kernel)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("channels", [3, 8, 16])
def test_torch_local_response_norm_matches_jax(channels):
    a = np.random.default_rng(channels).standard_normal(
        (2, 3, 5, channels)).astype(np.float32) * 30
    want = np.asarray(jnets.local_response_norm(jnp.asarray(a)))
    got = tnets.local_response_norm(_nhwc_to_nchw(a))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("use_lrn", [False, True])
@pytest.mark.parametrize("lt,lx,v_ch,x_ch", [(4, 4, 2, 4), (5, 3, 4, 2),
                                             (6, 6, 2, 2)])
def test_torch_conv_net_matches_jax(use_lrn, lt, lx, v_ch, x_ch):
    spec = dict(num_filters=4, num_hidden=24, factor=2.0, bounded_q=True,
                use_lrn=use_lrn, v_channels=v_ch, x_channels=x_ch)
    init, apply = jnets.make_conv_net(jnets.ConvNetSpec(lt, lx, **spec))
    jp = _bumped(jax.jit(init)(jax.random.PRNGKey(lt * 10 + lx)), lt + lx)
    net = tnets.make_conv_net(tnets.ConvNetSpec(lt, lx, **spec),
                              torch.Generator().manual_seed(0))
    _load(net, jp)
    v, x, t = _inputs(lt * lx, lt, lx, v_ch, x_ch)
    want = jax.jit(apply)(jp, *map(jnp.asarray, (v, x, t)))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (v, x, t)))
    _compare(want, got)
    assert net.x_layer.w.shape == ((lt + 1) // 2 * ((lx + 1) // 2) * 8, 24)


def test_torch_conv_net_bf16_matches_jax():
    spec = dict(num_filters=4, num_hidden=16, bounded_q=True, use_bf16=True,
                x_channels=4)
    init, apply = jnets.make_conv_net(jnets.ConvNetSpec(4, 4, **spec))
    jp = _bumped(jax.jit(init)(jax.random.PRNGKey(3)), 3)
    net = tnets.make_conv_net(tnets.ConvNetSpec(4, 4, **spec))
    _load(net, jp)
    v, x, t = _inputs(9, 4, 4, 2, 4)
    want = jax.jit(apply)(jp, *map(jnp.asarray, (v, x, t)))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (v, x, t)))
    # bf16 operands, float32 sums in another order: an activation within an
    # ulp of a bf16 rounding boundary may land one bf16 step (2^-8) apart
    for name, w, g in zip("STQ", want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-2,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize("lt,lx,layers,x_ch", [(4, 4, 2, 4), (5, 3, 1, 2),
                                               (6, 4, 3, 4)])
def test_torch_local_net_matches_jax(lt, lx, layers, x_ch):
    spec = dict(channels=6, kernel_size=3, num_layers=layers, factor=2.0,
                bounded_q=True, x_channels=x_ch)
    init, apply = jnets.make_local_net(jnets.LocalNetSpec(lt, lx, **spec))
    jp = _bumped(jax.jit(init)(jax.random.PRNGKey(layers)), 10 + layers)
    net = tnets.make_local_net(tnets.LocalNetSpec(lt, lx, **spec),
                               torch.Generator().manual_seed(0))
    _load(net, jp)
    v, x, t = _inputs(layers, lt, lx, 2, x_ch)
    want = jax.jit(apply)(jp, *map(jnp.asarray, (v, x, t)))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (v, x, t)))
    _compare(want, got)


def test_torch_image_net_init_statistics():
    """Init draws cannot match JAX's; their layout and scale do: He-normal
    convs, the x-slot channels of the local net's first conv scaled by
    sqrt(factor), a truncated-normal local head at the 0.001 factor, zero
    biases and coefficients, and the reference's parameter names."""
    g = torch.Generator().manual_seed(1)
    conv = tnets.make_conv_net(tnets.ConvNetSpec(8, 8, num_filters=8,
                                                 num_hidden=256, factor=2.0,
                                                 x_channels=4), g)
    init, _ = jnets.make_conv_net(jnets.ConvNetSpec(
        8, 8, num_filters=8, num_hidden=256, factor=2.0, x_channels=4))
    ref = _flat(jax.eval_shape(init, jax.random.PRNGKey(0)))
    assert set(conv.state_dict()) == set(ref)
    for k, v in ref.items():
        assert tuple(conv.state_dict()[k].shape) == conv.from_reference_leaf(
            k, np.zeros(v.shape, np.float32)).shape, k
    w = conv.conv_x1.w.detach()
    assert abs(float(w.std()) / np.sqrt(2.0 / (9 * 4)) - 1.0) < 0.1
    local = tnets.make_local_net(tnets.LocalNetSpec(
        16, 16, channels=8, factor=4.0, x_channels=4), g)
    linit, _ = jnets.make_local_net(jnets.LocalNetSpec(
        16, 16, channels=8, factor=4.0, x_channels=4))
    assert set(local.state_dict()) == set(_flat(jax.eval_shape(
        linit, jax.random.PRNGKey(0))))
    w0 = local.conv_0.w.detach()
    ratio = float(w0[:, 2:6].std() / torch.cat([w0[:, :2], w0[:, 6:]],
                                               dim=1).std())
    assert abs(ratio - 2.0) < 0.3
    hw = local.head.w.detach()
    std = np.sqrt(1.3 * 2.0 * 0.001 / 8)
    assert float(hw.abs().max()) <= 2 * std + 1e-7
    assert float(local.coeff_scale.detach().abs().max()) == 0.0
