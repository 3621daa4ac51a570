"""Scale/translation/transformation (S, T, Q) conditioners.

Port of ``l2hmc_tpu/networks/nets.py``:

- ``MLPNetSpec``/``make_mlp_net``: the three input embeddings (v, x, t) are
  one matmul over the concatenated input, hidden dense, ReLU, and one fused
  head matmul split into ``scale = tanh(.) * exp(coeff_scale)``,
  ``translation``, ``transformation = [tanh](.) * exp(coeff_transformation)``.
  Parameters keep the reference's names and ``(in, out)`` layouts, so a JAX
  pytree loads with a copy: ``in_w`` rows ``[v | x-features | t | aux]``
  (``aux`` with ``aux_dim > 0``: the VAE's conditioning on its data),
  ``head_w`` columns ``[S | T | Q]``, ``h_layer.w``/``h_layer.b``.
  ``use_bf16`` rounds each matmul's two operands to bfloat16 and takes the
  product in float32 (the reference's bf16 operands with float32
  accumulation).
- ``make_zero_net``: S = T = Q = 0 (``network_arch='zero'``), with which the
  augmented leapfrog is plain leapfrog.
- ``ConvNetSpec``/``make_conv_net``: the periodic CNN (two periodic conv
  stacks, 3x3 then 2x2 at stride 2, optional local response norm, dense
  embeddings and the fused head), and ``make_local_net``: the weight-shared
  image conditioner (``num_layers`` periodic kxk convs and a 1x1 head to
  per-link S/T/Q).  Both run NCHW with OIHW conv weights; the reference is
  NHWC with HWIO weights.  Where :func:`conv_kernel_route` holds (float32
  CUDA inputs, no gradient to record), the CNN's two stacks run in one launch
  of ``ops/conv_stack.py`` (``csrc/conv_stack.cu``).  :meth:`ConvNet.from_reference_leaf` and
  :meth:`LocalNet.from_reference_leaf` convert a reference leaf (conv
  weights HWIO -> OIHW; the conv net's ``x_layer``/``v_layer`` rows from
  the reference's NHWC flatten order to NCHW's).
- ``LocalNetSpec``/``make_local_flat_net``: the weight-shared local
  conditioner on the flat link layout — ``num_layers`` periodic 5-point
  stencil layers over per-direction channels, a 1x1 head to per-link S/T/Q.
  Parameters ``stencil_{i}.{w,wt,b}``, ``head.{w,b}``, ``coeff_scale``,
  ``coeff_transformation`` as in the reference.

Every module has ``from_reference_leaf(name, array)``: the reference leaf
at the dotted ``name`` in the module's own layout (the identity but for the
image nets).

Every module also has ``forward_sharded(v, x, t, sharding)``: the same
function on one 'space' rank's slab of the lattice (``parallel/spatial.py``;
the inputs and S/T/Q are this rank's columns).  The dense nets row-split
their input matrix over the slab and add the partial products over 'space';
the layers after that sum are replicated, and the heads are column-split to
the slab.  The image nets take the rows around the slab by halo exchanges
before each periodic conv.  A parameter used on the slab goes through
``sharding.enter``, so its gradient comes out whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from l2hmc_tpu_torch.ops import conv_stack
from l2hmc_tpu_torch.ops.leapfrog import _nb
from l2hmc_tpu_torch.utils import trace

# a traced window's count of conditioner calls whose conv stacks ran on
# csrc/conv_stack.cu
CONV_KERNEL_COUNTER = "net.conv_kernel"


def _variance_scaling(generator: Optional[torch.Generator], shape,
                      factor: float, device=None) -> torch.Tensor:
    """Truncated-normal (at 2 sigma) variance scaling, fan-in mode:
    stddev = sqrt(1.3 * 2*factor / fan_in)."""
    fan_in = shape[0]
    stddev = float(np.sqrt(1.3 * 2.0 * factor / fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * stddev


def matmul(x, w, bf16: bool = False):
    """``x @ w``; with ``bf16`` both operands are rounded to bfloat16 and the
    product is taken in float32, where a product of two bfloat16 values is
    exact, so only the order of the sum can differ from the reference's
    bf16-input, float32-accumulating matmul."""
    if bf16:
        return x.bfloat16().float() @ w.bfloat16().float()
    return x @ w


def _split_heads(heads, coeff_scale, coeff_transformation, bounded_q):
    """``(scale, translation, transformation)`` of the fused head outputs
    ``[S | T | Q]``."""
    s_raw, translation, q_raw = torch.chunk(heads, 3, dim=-1)
    scale = torch.tanh(s_raw) * torch.exp(coeff_scale)
    if bounded_q:
        q_raw = torch.tanh(q_raw)
    return scale, translation, q_raw * torch.exp(coeff_transformation)


def _slab_heads(net, hh, sp, bf16):
    """The fused head of ``net`` on the slab's columns: ``hh`` (replicated)
    enters the slab, ``head_w``, ``head_b`` and the coefficients are
    column-split."""
    cols3 = sp.field_index(3, hh.device)
    cols = sp.field_index(1, hh.device)
    heads = (matmul(sp.enter(hh), sp.enter(net.head_w)[:, cols3], bf16)
             + sp.enter(net.head_b)[cols3])
    return _split_heads(heads, sp.enter(net.coeff_scale)[:, cols],
                        sp.enter(net.coeff_transformation)[:, cols],
                        net.spec.bounded_q)


class Dense(nn.Module):
    """``y = x @ w + b`` with ``w`` stored ``(in, out)``."""

    def __init__(self, in_dim: int, out_dim: int, factor: float,
                 generator=None, device=None):
        super().__init__()
        self.w = nn.Parameter(
            _variance_scaling(generator, (in_dim, out_dim), factor, device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x, bf16: bool = False):
        return matmul(x, self.w, bf16) + self.b


@dataclasses.dataclass(frozen=True)
class MLPNetSpec:
    """Static architecture spec (same fields as the reference)."""

    x_dim: int
    num_hidden: int
    factor: float = 1.0  # 2.0 for XNet, 1.0 for VNet
    use_bf16: bool = False
    bounded_q: bool = False
    aux_dim: int = 0
    # input dims when they differ from x_dim (periodic cos/sin position
    # features double the position slot); 0 -> x_dim
    v_in_dim: int = 0
    x_in_dim: int = 0


class MLPNet(nn.Module):
    """The fused GenericNet-parity MLP: ``forward(v, x, t, aux=None) ->
    (S, T, Q)``.  With ``spec.aux_dim > 0`` the conditioning input ``aux
    (B, aux_dim)`` (the VAE's data batch) is required; its rows are the
    trailing ``aux_dim`` rows of ``in_w``."""

    def __init__(self, spec: MLPNetSpec, generator=None, device=None):
        super().__init__()
        self.spec = spec
        d, h, da = spec.x_dim, spec.num_hidden, spec.aux_dim
        dv = spec.v_in_dim or d
        dx = spec.x_in_dim or d
        g = generator
        self.in_w = nn.Parameter(torch.cat([
            _variance_scaling(g, (dv, h), 1.0 / 3.0, device),
            _variance_scaling(g, (dx, h), spec.factor / 3.0, device),
            _variance_scaling(g, (2, h), 1.0 / 3.0, device),
        ] + ([_variance_scaling(g, (da, h), 1.0 / 3.0, device)] if da > 0
             else []), dim=0))
        self.in_b = nn.Parameter(torch.zeros(h, device=device))
        self.h_layer = Dense(h, h, 1.0, g, device)
        self.head_w = nn.Parameter(torch.cat([
            _variance_scaling(g, (h, d), 0.001, device) for _ in range(3)
        ], dim=1))
        self.head_b = nn.Parameter(torch.zeros(3 * d, device=device))
        self.coeff_scale = nn.Parameter(torch.zeros(1, d, device=device))
        self.coeff_transformation = nn.Parameter(
            torch.zeros(1, d, device=device))

    @staticmethod
    def from_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        return array

    @staticmethod
    def to_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        return array

    def forward(self, v, x, t, aux=None):
        bf16 = self.spec.use_bf16
        parts = [v, x, t]
        if self.spec.aux_dim > 0:
            if aux is None:
                raise ValueError(
                    f"this net has aux_dim={self.spec.aux_dim}: pass the "
                    "conditioning input aux (B, aux_dim)")
            parts.append(aux)
        inp = torch.cat(parts, dim=-1)
        hh = torch.relu(matmul(inp, self.in_w, bf16) + self.in_b)
        hh = torch.relu(self.h_layer(hh, bf16))
        heads = matmul(hh, self.head_w, bf16) + self.head_b
        return _split_heads(heads, self.coeff_scale,
                            self.coeff_transformation, self.spec.bounded_q)

    def forward_sharded(self, v, x, t, sharding, aux=None):
        """:meth:`forward` on one 'space' rank's slab: ``v`` and ``x`` hold
        the slab's columns of each input slot (a ``[cos | sin]`` slot: the
        slab's cosines, then its sines).  ``in_w``'s rows of those columns
        give a partial product, added over 'space'; the ``t`` (and
        ``aux``) rows and ``in_b`` are added once after the sum."""
        spec, sp, bf16 = self.spec, sharding, self.spec.use_bf16
        d = spec.x_dim
        dv, dx = spec.v_in_dim or d, spec.x_in_dim or d
        dev = v.device
        rows = torch.cat([sp.field_index(dv // d, dev),
                          dv + sp.field_index(dx // d, dev)])
        part = matmul(torch.cat([v, x], dim=-1),
                      sp.enter(self.in_w)[rows], bf16)
        rest, w_rest = [t], [self.in_w[dv + dx:dv + dx + 2]]
        if spec.aux_dim > 0:
            if aux is None:
                raise ValueError(
                    f"this net has aux_dim={spec.aux_dim}: pass the "
                    "conditioning input aux (B, aux_dim)")
            rest.append(aux)
            w_rest.append(self.in_w[dv + dx + 2:])
        pre = sp.space_sum(part) + matmul(torch.cat(rest, dim=-1),
                                          torch.cat(w_rest), bf16)
        hh = torch.relu(pre + self.in_b)
        hh = torch.relu(self.h_layer(hh, bf16))
        return _slab_heads(self, hh, sp, bf16)


def make_mlp_net(spec: MLPNetSpec, generator=None, device=None) -> MLPNet:
    """Build the MLP conditioner module (random init from ``generator``)."""
    return MLPNet(spec, generator, device)


class ZeroNet(nn.Module):
    """S = T = Q = 0 of shape ``(B, x_dim)``; no parameters."""

    def __init__(self, x_dim: int):
        super().__init__()
        self.x_dim = x_dim

    @staticmethod
    def from_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        return array

    @staticmethod
    def to_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        return array

    def forward(self, v, x, t):
        z = torch.zeros((v.shape[0], self.x_dim), dtype=v.dtype,
                        device=v.device)
        return z, z, z

    def forward_sharded(self, v, x, t, sharding):
        z = torch.zeros((v.shape[0], sharding.x_dim), dtype=v.dtype,
                        device=v.device)
        return z, z, z


def make_zero_net(x_dim: int) -> ZeroNet:
    """The HMC-degenerate conditioner: with S = T = Q = 0 the augmented
    leapfrog is plain leapfrog.  The outputs have ``x_dim`` columns whatever
    the width of the inputs (the u1 features double the position slot)."""
    return ZeroNet(x_dim)


# ---------------------------------------------------------------------------
# Periodic (toroidal) image conditioners: the CNN and the local net
# ---------------------------------------------------------------------------


def periodic_pad_2d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Wrap-pad the two spatial axes of an NCHW tensor for a
    ``kernel``-wide conv: (k-1)//2 before, k//2 after, so a conv without
    padding gives L outputs (stride 1) or ceil(L/s) (stride s)."""
    pl, pr = (kernel - 1) // 2, kernel // 2
    if pl == 0 and pr == 0:
        return x
    return F.pad(x, (pl, pr, pl, pr), mode="circular")


def conv2d_periodic(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int = 1, bf16: bool = False) -> torch.Tensor:
    """kxk conv of NCHW ``x`` with OIHW ``w`` on periodic padding; with
    ``bf16`` both operands rounded to bfloat16, the sums in float32."""
    x = periodic_pad_2d(x, w.shape[-1])
    if bf16:
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return F.conv2d(x, w, b, stride=stride)


def conv2d_slab(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                sharding, stride: int = 1, bf16: bool = False
                ) -> torch.Tensor:
    """:func:`conv2d_periodic` on one 'space' rank's rows of an NCHW field
    (H the time axis): the rows around the slab by a halo exchange
    (``(k-1)//2`` before, ``k//2`` after), the space axis wrapped."""
    k = w.shape[-1]
    pl, pr = (k - 1) // 2, k // 2
    if stride > 1:
        sharding.check_stride(stride)
    if pl or pr:
        x = sharding.halo(x, 2, pl, pr)
        x = F.pad(x, (pl, pr, 0, 0), mode="circular")
    if bf16:
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return F.conv2d(x, w, b, stride=stride)


def local_response_norm(x: torch.Tensor, n: int = 5, k: float = 2.0,
                        alpha: float = 1e-4, beta: float = 0.75
                        ) -> torch.Tensor:
    """The reference's local response normalization over the channels
    (dim 1) of NCHW ``x``: ``x / (k + alpha * sum_{|c'-c| <= n}
    x_{c'}^2)^beta``, the window ``n`` channels on each side and ``alpha``
    not divided by its size (``F.local_response_norm`` differs in both),
    as shifted sums in the reference's order."""
    sq = x * x
    c = x.shape[1]
    total = sq
    for off in range(1, n + 1):
        if off < c:
            total = total + F.pad(sq[:, off:], (0, 0, 0, 0, 0, off))
            total = total + F.pad(sq[:, :-off], (0, 0, 0, 0, off, 0))
    return x / torch.pow(k + alpha * total, beta)


def _he_conv(generator, cout: int, cin: int, k: int, device=None):
    """He-normal OIHW conv weights (the reference's ``_conv_init``)."""
    w = torch.randn((cout, cin, k, k), generator=generator,
                    dtype=torch.float32, device=device)
    return w * float(np.sqrt(2.0 / (k * k * cin)))


def _hwio_to_oihw(array: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(array, (3, 2, 0, 1)))


def _oihw_to_hwio(array: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(array, (2, 3, 1, 0)))


def to_image(flat: torch.Tensor, lt: int, lx: int) -> torch.Tensor:
    """NCHW view of a flat input: ``(B, d)`` links -> ``(B, 2, lt, lx)``;
    periodic features ``(B, 2d)`` [cos | sin] -> ``(B, 4, lt, lx)`` with
    channels cos0, cos1, sin0, sin1 (the reference's channel stacking)."""
    b = flat.shape[0]
    n = flat.shape[-1] // (lt * lx * 2)
    return flat.reshape(b, n, lt, lx, 2).permute(0, 1, 4, 2, 3).reshape(
        b, 2 * n, lt, lx)


def from_image(img: torch.Tensor) -> torch.Tensor:
    """``(B, 2, lt, lx)`` per-direction fields -> flat ``(B, 2 lt lx)``
    in the interleaved link order."""
    return img.permute(0, 2, 3, 1).reshape(img.shape[0], -1)


class _Conv(nn.Module):
    """OIHW weights ``w`` and bias ``b`` of one conv (the reference's
    ``{"w", "b"}`` dict, its ``w`` HWIO)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


@dataclasses.dataclass(frozen=True)
class ConvNetSpec:
    """Static spec of the periodic-CNN S/T/Q network (same fields as the
    reference)."""

    time_size: int
    space_size: int
    num_filters: int = 8
    filter_size1: int = 3
    filter_size2: int = 2
    num_hidden: int = 256
    factor: float = 1.0
    use_bf16: bool = False
    bounded_q: bool = False
    use_lrn: bool = False
    v_channels: int = 2          # 2 link dirs; 4 with cos/sin features
    x_channels: int = 2

    @property
    def x_dim(self) -> int:
        return self.time_size * self.space_size * 2


def conv_kernel_route(spec: ConvNetSpec, cuda: bool, float32: bool,
                      grad: bool) -> bool:
    """Whether :meth:`ConvNet.forward` runs both conv stacks in one launch
    of ``csrc/conv_stack.cu``: float32 inputs (``float32``) on CUDA
    (``cuda``), no gradient to record (``grad``: grad mode on and a
    parameter or input requiring one), neither LRN nor bf16 operands, and
    a shape the kernel takes (``ops/conv_stack.py takes``).  Everything
    else runs the eager stacks."""
    return (cuda and float32 and not grad and not spec.use_lrn
            and not spec.use_bf16
            and conv_stack.takes(spec.time_size, spec.space_size,
                                 spec.filter_size1, spec.filter_size2,
                                 spec.num_filters,
                                 (spec.x_channels, spec.v_channels)))


class ConvNet(nn.Module):
    """``forward(v, x, t) -> (S, T, Q)``: each of ``v`` and ``x`` through a
    periodic conv stack (conv k1 -> relu [-> LRN] -> conv k2 at stride 2
    -> relu [-> LRN]), flattened, then ``relu(v_layer + x_layer +
    t_layer)``, ``relu(h_layer)`` and the fused ``(h, 3d)`` head.

    The stacks' outputs are flattened in NCHW order, so ``x_layer.w`` and
    ``v_layer.w`` hold the reference's rows permuted
    (:meth:`from_reference_leaf`)."""

    def __init__(self, spec: ConvNetSpec, generator=None, device=None):
        super().__init__()
        self.spec = spec
        g, dev = generator, device
        f1, f2 = spec.num_filters, 2 * spec.num_filters
        k1, k2 = spec.filter_size1, spec.filter_size2
        self.lt2 = (spec.time_size + 1) // 2
        self.lx2 = (spec.space_size + 1) // 2
        conv_out = self.lt2 * self.lx2 * f2
        d, h = spec.x_dim, spec.num_hidden

        def conv(cin, cout, k):
            return _Conv(_he_conv(g, cout, cin, k, dev),
                         torch.zeros(cout, device=dev))

        self.conv_x1 = conv(spec.x_channels, f1, k1)
        self.conv_x2 = conv(f1, f2, k2)
        self.conv_v1 = conv(spec.v_channels, f1, k1)
        self.conv_v2 = conv(f1, f2, k2)
        self.x_layer = Dense(conv_out, h, spec.factor / 3.0, g, dev)
        self.v_layer = Dense(conv_out, h, 1.0 / 3.0, g, dev)
        self.t_layer = Dense(2, h, 1.0 / 3.0, g, dev)
        self.h_layer = Dense(h, h, 1.0, g, dev)
        self.head_w = nn.Parameter(torch.cat([
            _variance_scaling(g, (h, d), 0.001, dev) for _ in range(3)],
            dim=1))
        self.head_b = nn.Parameter(torch.zeros(3 * d, device=dev))
        self.coeff_scale = nn.Parameter(torch.zeros(1, d, device=dev))
        self.coeff_transformation = nn.Parameter(
            torch.zeros(1, d, device=dev))

    def from_reference_leaf(self, name: str, array: np.ndarray) -> np.ndarray:
        array = np.asarray(array)
        if name.startswith("conv_") and name.endswith(".w"):
            return _hwio_to_oihw(array)
        if name in ("x_layer.w", "v_layer.w"):
            f2 = 2 * self.spec.num_filters
            h = array.shape[1]
            return np.ascontiguousarray(
                array.reshape(self.lt2, self.lx2, f2, h)
                .transpose(2, 0, 1, 3).reshape(-1, h))
        return array

    def to_reference_leaf(self, name: str, array: np.ndarray) -> np.ndarray:
        """The inverse of :meth:`from_reference_leaf`."""
        array = np.asarray(array)
        if name.startswith("conv_") and name.endswith(".w"):
            return _oihw_to_hwio(array)
        if name in ("x_layer.w", "v_layer.w"):
            f2 = 2 * self.spec.num_filters
            h = array.shape[1]
            return np.ascontiguousarray(
                array.reshape(f2, self.lt2, self.lx2, h)
                .transpose(1, 2, 0, 3).reshape(-1, h))
        return array

    def _stack(self, c1: _Conv, c2: _Conv, flat):
        bf16 = self.spec.use_bf16
        y = to_image(flat, self.spec.time_size, self.spec.space_size)
        y = torch.relu(conv2d_periodic(y, c1.w, c1.b, bf16=bf16))
        if self.spec.use_lrn:
            y = local_response_norm(y)
        y = torch.relu(conv2d_periodic(y, c2.w, c2.b, stride=2, bf16=bf16))
        if self.spec.use_lrn:
            y = local_response_norm(y)
        return y.reshape(flat.shape[0], -1)

    def forward(self, v, x, t):
        """Spans (``utils/trace.py``): ``net.conv`` (both stacks) and
        ``net.trunk`` (the dense layers and the heads); the counter
        :data:`CONV_KERNEL_COUNTER` once per call whose stacks take
        :func:`conv_kernel_route`."""
        bf16 = self.spec.use_bf16
        with trace.span("net.conv"):
            grad = torch.is_grad_enabled() and (
                v.requires_grad or x.requires_grad
                or any(c.w.requires_grad or c.b.requires_grad
                       for c in (self.conv_x1, self.conv_x2, self.conv_v1,
                                 self.conv_v2)))
            f32 = all(t.dtype == torch.float32 for t in (v, x))
            if conv_kernel_route(self.spec, x.is_cuda, f32, grad):
                trace.count(CONV_KERNEL_COUNTER)
                xc, vc = conv_stack.conv_stack(
                    [(flat.contiguous(), c1.w, c1.b, c2.w, c2.b)
                     for flat, c1, c2 in ((x, self.conv_x1, self.conv_x2),
                                          (v, self.conv_v1, self.conv_v2))],
                    self.spec.time_size, self.spec.space_size)
            else:
                xc = self._stack(self.conv_x1, self.conv_x2, x)
                vc = self._stack(self.conv_v1, self.conv_v2, v)
        with trace.span("net.trunk"):
            hh = torch.relu(self.v_layer(vc, bf16) + self.x_layer(xc, bf16)
                            + self.t_layer(t, bf16))
            hh = torch.relu(self.h_layer(hh, bf16))
            heads = matmul(hh, self.head_w, bf16) + self.head_b
            return _split_heads(heads, self.coeff_scale,
                                self.coeff_transformation,
                                self.spec.bounded_q)

    def _stack_sharded(self, c1: _Conv, c2: _Conv, flat, sp):
        bf16 = self.spec.use_bf16
        y = to_image(flat, sp.lt_blk, self.spec.space_size)
        y = torch.relu(conv2d_slab(y, sp.enter(c1.w), sp.enter(c1.b), sp,
                                   bf16=bf16))
        if self.spec.use_lrn:
            y = local_response_norm(y)
        y = torch.relu(conv2d_slab(y, sp.enter(c2.w), sp.enter(c2.b), sp,
                                   stride=2, bf16=bf16))
        if self.spec.use_lrn:
            y = local_response_norm(y)
        return y.reshape(flat.shape[0], -1)

    def _slab_rows(self, layer: "Dense", sp):
        """The rows of ``x_layer.w`` / ``v_layer.w`` (NCHW flatten order)
        that multiply the slab's conv outputs: rows ``[t0/2, t0/2 +
        lt_blk/2)`` of each channel, strided."""
        f2, h = 2 * self.spec.num_filters, layer.w.shape[1]
        r0 = sp.t0 // 2
        w = sp.enter(layer.w).view(f2, self.lt2, self.lx2, h)
        return w[:, r0:r0 + sp.lt_blk // 2].reshape(-1, h)

    def forward_sharded(self, v, x, t, sharding):
        """:meth:`forward` on one 'space' rank's slab: both conv stacks on
        the slab's rows (halos of 1 row each side for the 3x3 conv, 1 after
        for the stride-2 2x2; the slab's rows must be even), the dense
        embeddings row-split and added over 'space', then the replicated
        layers and the column-split head."""
        sp, bf16 = sharding, self.spec.use_bf16
        xc = self._stack_sharded(self.conv_x1, self.conv_x2, x, sp)
        vc = self._stack_sharded(self.conv_v1, self.conv_v2, v, sp)
        part = (matmul(vc, self._slab_rows(self.v_layer, sp), bf16)
                + matmul(xc, self._slab_rows(self.x_layer, sp), bf16))
        hh = torch.relu(sp.space_sum(part) + self.v_layer.b + self.x_layer.b
                        + self.t_layer(t, bf16))
        hh = torch.relu(self.h_layer(hh, bf16))
        return _slab_heads(self, hh, sp, bf16)


def make_conv_net(spec: ConvNetSpec, generator=None, device=None) -> ConvNet:
    """Build the periodic-CNN conditioner (random init from ``generator``)."""
    return ConvNet(spec, generator, device)


# ---------------------------------------------------------------------------
# Local 5-point-stencil conditioner
# ---------------------------------------------------------------------------

# stencil offsets (dt, ds) in the reference's roll convention: the term of
# offset (dt, ds) reads the input at site (t - dt, s - ds)
STENCIL_OFF = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def stencil_layer(chans: Sequence[torch.Tensor], w: torch.Tensor,
                  bias: torch.Tensor, lx: int,
                  tau: Optional[torch.Tensor] = None,
                  wt: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """One periodic 5-point stencil layer with ReLU on flat ``(B, d)``
    channels: ``out_j = relu(b_j [+ tau @ wt_j] + sum_{o,c} w[o,c,j]
    in_c(site - off_o))``.  ``w (5, cin, cout)``; ``tau (B, 2)`` is the
    time encoding, entering as a per-chain bias (a convolution over
    constant channels)."""
    sh = torch.stack([torch.stack([_nb(a, lx, -dt, -ds)
                                   for dt, ds in STENCIL_OFF]) for a in chans])
    out = torch.einsum("cobd,ocj->jbd", sh, w) + bias[:, None, None]
    if tau is not None:
        out = out + (tau @ wt).t()[:, :, None]
    return list(torch.relu(out))


def stencil_layer_slab(chans: Sequence[torch.Tensor], w: torch.Tensor,
                       bias: torch.Tensor, lx: int, sharding,
                       tau: Optional[torch.Tensor] = None,
                       wt: Optional[torch.Tensor] = None
                       ) -> List[torch.Tensor]:
    """:func:`stencil_layer` on one 'space' rank's slab: the channels' rows
    around the slab by one halo exchange (1 row each side), the parameters
    entering the slab."""
    sp = sharding
    a = torch.stack(list(chans))
    c, b, d = a.shape
    ext = sp.halo(a.reshape(c, b, -1, lx), 2, 1, 1)
    n = ext.shape[2] - 2
    sh = torch.stack([
        torch.roll(ext[:, :, 1 - dt:1 - dt + n], shifts=ds,
                   dims=3).reshape(c, b, d)
        for dt, ds in STENCIL_OFF], dim=1)
    out = (torch.einsum("cobd,ocj->jbd", sh, sp.enter(w))
           + sp.enter(bias)[:, None, None])
    if tau is not None:
        out = out + sp.enter(tau @ wt).t()[:, :, None]
    return list(torch.relu(out))


def stencil_head(y: Sequence[torch.Tensor], hw: torch.Tensor,
                 hb: torch.Tensor, cs: torch.Tensor, ct: torch.Tensor,
                 bounded_q: bool):
    """1x1 head ``(c, 6)`` with outputs ``[S0 S1 T0 T1 Q0 Q1]`` -> per
    direction ``[(s0, t0, q0), (s1, t1, q1)]`` with the tanh/exp combines
    and the per-direction coefficients ``cs, ct (2,)``."""
    head = torch.einsum("cbd,ck->kbd", torch.stack(list(y)), hw) \
        + hb[:, None, None]
    out = []
    for r in (0, 1):
        s = torch.tanh(head[r]) * torch.exp(cs[r])
        q = head[4 + r]
        if bounded_q:
            q = torch.tanh(q)
        out.append((s, head[2 + r], q * torch.exp(ct[r])))
    return out


@dataclasses.dataclass(frozen=True)
class LocalNetSpec:
    """Static spec of the weight-shared local conditioner (same fields as
    the reference).  ``use_bf16`` is accepted and, as in the reference's
    flat stencil net, has no effect: the stencil computes in float32."""

    time_size: int
    space_size: int
    channels: int = 8
    kernel_size: int = 3
    num_layers: int = 2
    factor: float = 1.0          # x-slot input-channel init scaling
    use_bf16: bool = False
    bounded_q: bool = False
    v_channels: int = 2          # 2 link dirs; 4 with cos/sin features
    x_channels: int = 2

    @property
    def x_dim(self) -> int:
        return self.time_size * self.space_size * 2


class _Layer(nn.Module):
    """Weights ``w``, bias ``b`` and, for stencil layer 0, the time rows
    ``wt``: the reference's per-layer parameter dict."""

    def __init__(self, w, b, wt=None):
        super().__init__()
        self.w = nn.Parameter(w)
        if wt is not None:
            self.wt = nn.Parameter(wt)
        self.b = nn.Parameter(b)


class LocalFlatNet(nn.Module):
    """The flat-layout local conditioner: ``forward(v, x, t) -> (S, T, Q)``,
    each ``(B, x_dim)`` in the interleaved link order.

    Inputs are split into per-direction ``(B, d)`` channels: a 2-channel
    slot is the link pair, a 4-channel slot the ``[cos | sin]`` position
    features.  Layer 0 sees ``v`` channels then ``x`` channels.
    """

    def __init__(self, spec: LocalNetSpec, generator=None, device=None):
        super().__init__()
        if spec.kernel_size != 3:
            # the stencil support is the fixed 5-point cross (the k=3
            # conv's nearest-neighbour subset)
            raise ValueError(
                f"make_local_flat_net supports kernel_size=3 only (5-point "
                f"cross stencil); got {spec.kernel_size}")
        self.spec = spec
        c = spec.channels
        n_off = len(STENCIL_OFF)
        cin = spec.v_channels + spec.x_channels
        fan0 = n_off * cin + 2
        kw = dict(generator=generator, dtype=torch.float32, device=device)
        w0 = torch.randn((n_off, cin, c), **kw) * float(np.sqrt(2.0 / fan0))
        # factor-scaled init on the x-slot input channels
        lo, hi = spec.v_channels, spec.v_channels + spec.x_channels
        w0[:, lo:hi, :] *= float(np.sqrt(spec.factor))
        wt = torch.randn((2, c), **kw) * float(np.sqrt(2.0 / fan0))
        self.stencil_0 = _Layer(w0, torch.zeros(c, device=device), wt)
        for i in range(1, spec.num_layers):
            wi = torch.randn((n_off, c, c), **kw) * float(
                np.sqrt(2.0 / (n_off * c)))
            self.add_module(f"stencil_{i}",
                            _Layer(wi, torch.zeros(c, device=device)))
        # 1x1 head, 0.001 factor so the sampler starts near plain HMC
        std = float(np.sqrt(1.3 * 2.0 * 0.001 / c))
        hw = torch.empty((c, 6), dtype=torch.float32, device=device)
        nn.init.trunc_normal_(hw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        self.head = _Layer(hw * std, torch.zeros(6, device=device))
        self.coeff_scale = nn.Parameter(torch.zeros(2, device=device))
        self.coeff_transformation = nn.Parameter(torch.zeros(2, device=device))

    @staticmethod
    def from_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        return array

    @staticmethod
    def to_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        return array

    def stencils(self):
        return [getattr(self, f"stencil_{i}")
                for i in range(self.spec.num_layers)]

    def apply_channels(self, chans, tau):
        """Per-direction ``[(s0, t0, q0), (s1, t1, q1)]`` from the layer-0
        input channels (a list of ``(B, d)``) and ``tau (B, 2)``."""
        lx = self.spec.space_size
        st = self.stencils()
        y = stencil_layer(chans, st[0].w, st[0].b, lx, tau, st[0].wt)
        for s in st[1:]:
            y = stencil_layer(y, s.w, s.b, lx)
        return stencil_head(y, self.head.w, self.head.b, self.coeff_scale,
                            self.coeff_transformation, self.spec.bounded_q)

    def forward(self, v, x, t):
        return self._forward(v, x, t, None)

    def forward_sharded(self, v, x, t, sharding):
        """:meth:`forward` on one 'space' rank's slab: each stencil layer
        takes one halo row on each side of the slab."""
        return self._forward(v, x, t, sharding)

    def _forward(self, v, x, t, sp):
        b = v.shape[0]
        d = v.shape[1] // self.spec.v_channels   # the sites held

        def split_dir(flat, n_ch):
            if n_ch == 2:
                pair = flat.reshape(b, d, 2)
                return [pair[:, :, 0], pair[:, :, 1]]
            cos_p, sin_p = torch.chunk(flat, 2, dim=-1)
            return split_dir(cos_p, 2) + split_dir(sin_p, 2)

        chans = (split_dir(v, self.spec.v_channels)
                 + split_dir(x, self.spec.x_channels))
        if sp is None:
            (s0, t0, q0), (s1, t1, q1) = self.apply_channels(chans, t)
        else:
            lx = self.spec.space_size
            st = self.stencils()
            y = stencil_layer_slab(chans, st[0].w, st[0].b, lx, sp, t,
                                   st[0].wt)
            for s in st[1:]:
                y = stencil_layer_slab(y, s.w, s.b, lx, sp)
            (s0, t0, q0), (s1, t1, q1) = stencil_head(
                y, sp.enter(self.head.w), sp.enter(self.head.b),
                sp.enter(self.coeff_scale),
                sp.enter(self.coeff_transformation), self.spec.bounded_q)

        def join(c0, c1):
            return torch.stack([c0, c1], dim=-1).reshape(b, 2 * d)

        return join(s0, s1), join(t0, t1), join(q0, q1)


def make_local_flat_net(spec: LocalNetSpec, generator=None,
                        device=None) -> LocalFlatNet:
    """Build the flat local conditioner (random init from ``generator``)."""
    return LocalFlatNet(spec, generator, device)


class LocalNet(nn.Module):
    """The weight-shared image conditioner: ``forward(v, x, t) -> (S, T,
    Q)``.  Inputs stacked as channels ``[v | x | t broadcast]`` of one
    NCHW field, ``num_layers`` periodic kxk convs with ReLU, a 1x1 head to
    ``[S0 S1 T0 T1 Q0 Q1]`` with per-direction coefficients."""

    def __init__(self, spec: LocalNetSpec, generator=None, device=None):
        super().__init__()
        self.spec = spec
        g, dev = generator, device
        c, k = spec.channels, spec.kernel_size
        cin = spec.v_channels + spec.x_channels + 2
        w0 = _he_conv(g, c, cin, k, dev)
        # factor-scaled init on the x-slot input channels
        lo, hi = spec.v_channels, spec.v_channels + spec.x_channels
        w0[:, lo:hi] *= float(np.sqrt(spec.factor))
        self.conv_0 = _Conv(w0, torch.zeros(c, device=dev))
        for i in range(1, spec.num_layers):
            self.add_module(f"conv_{i}", _Conv(_he_conv(g, c, c, k, dev),
                                               torch.zeros(c, device=dev)))
        # 1x1 head, truncated normal at the 0.001 factor
        std = float(np.sqrt(1.3 * 2.0 * 0.001 / c))
        hw = torch.empty((6, c, 1, 1), dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(hw, 0.0, 1.0, -2.0, 2.0, generator=g)
        self.head = _Conv(hw * std, torch.zeros(6, device=dev))
        self.coeff_scale = nn.Parameter(torch.zeros(2, device=dev))
        self.coeff_transformation = nn.Parameter(torch.zeros(2, device=dev))

    @staticmethod
    def from_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        array = np.asarray(array)
        if name.endswith(".w"):
            return _hwio_to_oihw(array)
        return array

    @staticmethod
    def to_reference_leaf(name: str, array: np.ndarray) -> np.ndarray:
        array = np.asarray(array)
        if name.endswith(".w"):
            return _oihw_to_hwio(array)
        return array

    def forward(self, v, x, t):
        return self._forward(v, x, t, None)

    def forward_sharded(self, v, x, t, sharding):
        """:meth:`forward` on one 'space' rank's slab: each kxk conv takes
        the rows around the slab by a halo exchange."""
        return self._forward(v, x, t, sharding)

    def _forward(self, v, x, t, sp):
        spec = self.spec
        b, lx = v.shape[0], spec.space_size
        lt = spec.time_size if sp is None else sp.lt_blk
        bf16 = spec.use_bf16
        if sp is None:
            def conv(y, layer):
                return conv2d_periodic(y, layer.w, layer.b, bf16=bf16)

            def param(p):
                return p
        else:
            def conv(y, layer):
                return conv2d_slab(y, sp.enter(layer.w), sp.enter(layer.b),
                                   sp, bf16=bf16)

            param = sp.enter
        t_img = t[:, :, None, None].expand(b, 2, lt, lx)
        y = torch.cat([to_image(v, lt, lx), to_image(x, lt, lx), t_img],
                      dim=1)
        for i in range(spec.num_layers):
            y = torch.relu(conv(y, getattr(self, f"conv_{i}")))
        heads = conv(y, self.head)
        cs = torch.exp(param(self.coeff_scale))[None, :, None, None]
        ct = torch.exp(param(self.coeff_transformation))[None, :, None, None]
        q_raw = heads[:, 4:6]
        if spec.bounded_q:
            q_raw = torch.tanh(q_raw)
        return (from_image(torch.tanh(heads[:, 0:2]) * cs),
                from_image(heads[:, 2:4]), from_image(q_raw * ct))


def make_local_net(spec: LocalNetSpec, generator=None,
                   device=None) -> LocalNet:
    """Build the image local conditioner (random init from ``generator``)."""
    return LocalNet(spec, generator, device)
