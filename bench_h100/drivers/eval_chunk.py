"""Eval traffic: the program's sampling chunk (``train/gauge.py
make_eval_chunk``, the eval path of ``train_gauge``) served as calls of
``transitions_per_call`` transitions, enqueued back to back.

Traffic parameters (``traffic/<name>.json``): ``chains``,
``transitions_per_call`` and ``beta``.  The configuration gives the
lattice, the conditioner (``sampler``: ``network`` ``conv``, filters,
kernels, trunk width, steps, step size, integrator) and ``init_std``.

Every leaf of both nets and the hold masks are drawn from ``--seed`` here
in plain torch (:func:`seeded_conv_weights`), and the reference computes
from those tensors.  The program is built as the CLI builds it (a
``GaugeConfig``, its nets from ``init_params``, the chunk from
``make_eval_chunk``, whose ``build_dynamics`` takes the Wilson kernels on
CUDA states); the drawn leaves and masks then replace all of its own.
Every call draws from one generator on the card, seeded from ``--seed``,
whose state is kept before each call, so nothing waits for the card and
the reference can redraw a call's draws.  The window's first call starts
from near-equilibrium links made from the seed; every later call from the
links the one before left.  The check replays that first call and one
later call drawn from the seed in the plain reference
(``reference/conv_chain.py``).
"""

from __future__ import annotations

import math
import random

import torch

from bench_h100.lib import common
from bench_h100.lib.common import plaquette_at, sync
from bench_h100.reference import chains, conv_chain, judge, lattice

WARM_CALLS = 4


def gauge_config(cfg: dict, num_chains: int):
    """The program's ``GaugeConfig`` of the configuration ``cfg``."""
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    lt, lx = cfg["lattice"]
    net = cfg["sampler"]
    return GaugeConfig(
        time_size=lt, space_size=lx, num_chains=num_chains,
        num_steps=net["num_leapfrog"], eps_init=net["eps"],
        eps_trainable=False, network_arch=net["network"],
        num_hidden=net["num_hidden"], num_filters=net["num_filters"],
        merge_v_halves=net["merge_v_halves"], bounded_q=net["bounded_q"],
        group=net["group"])


def check_spec(params, net: dict) -> None:
    """The program's conv nets are the configuration's (the kernel sizes,
    stride and normalization are ``ConvNetSpec``'s; nothing sets them)."""
    for module in (params.xnet, params.vnet):
        spec = module.spec
        got = (spec.filter_size1, spec.filter_size2, spec.use_lrn,
               spec.num_hidden, spec.num_filters)
        want = (net["filter_size1"], net["filter_size2"], net["use_lrn"],
                net["num_hidden"], net["num_filters"])
        if got != want:
            raise ValueError(f"the program's conv net {got} is not the "
                             f"configuration's {want}")


def conv_leaves(lt: int, lx: int, net: dict, pos: str) -> list:
    """``(name, shape, width)`` of each leaf of one conditioner, in the
    program's names (``networks/nets.py ConvNet``'s state dict).  The slot
    ``pos`` (``x`` in the position net, ``v`` in the momentum net) takes
    the position's cos/sin features (4 channels), the other slot 2
    channels.  ``width`` is a weight's standard deviation, the variance of
    the program's initialiser for its fan-in (2 over it for the convs, He;
    2 x the dense layer's factor over it: the position net's ``x_layer``
    2/3, ``h_layer`` 1, the others 1/3), or the key of ``init_std`` for the
    heads, the biases and the coefficients."""
    f1, k1, k2 = net["num_filters"], net["filter_size1"], net["filter_size2"]
    f2, h, x_dim = 2 * f1, net["num_hidden"], 2 * lt * lx
    flat = ((lt + 1) // 2) * ((lx + 1) // 2) * f2
    x_gain = 4.0 / 3.0 if pos == "x" else 2.0 / 3.0

    def he(fan, gain=2.0):
        return math.sqrt(gain / fan)

    out = []
    for slot in ("x", "v"):
        cin = 4 if slot == pos else 2
        out += [(f"conv_{slot}1.w", (f1, cin, k1, k1), he(cin * k1 * k1)),
                (f"conv_{slot}1.b", (f1,), "bias"),
                (f"conv_{slot}2.w", (f2, f1, k2, k2), he(f1 * k2 * k2)),
                (f"conv_{slot}2.b", (f2,), "bias")]
    for name, fan, gain in (("x_layer", flat, x_gain),
                            ("v_layer", flat, 2.0 / 3.0),
                            ("t_layer", 2, 2.0 / 3.0), ("h_layer", h, 2.0)):
        out += [(f"{name}.w", (fan, h), he(fan, gain)),
                (f"{name}.b", (h,), "bias")]
    return out + [("head_w", (h, 3 * x_dim), "head"),
                  ("head_b", (3 * x_dim,), "bias"),
                  ("coeff_scale", (1, x_dim), "coeff"),
                  ("coeff_transformation", (1, x_dim), "coeff")]


def seeded_conv_weights(gen: torch.Generator, lt: int, lx: int, net: dict,
                        init_std: dict):
    """Both conditioners' leaves (:func:`conv_leaves`, each normal of its
    width) and the hold masks, drawn from ``gen`` on its device by plain
    torch, independent of the program's initialiser; each of the ``K``
    masks a random half of the ``2 d`` links.  Returns ``((xnet, vnet),
    masks)``, each net a dict of the program's state-dict names."""
    dev = gen.device
    nets = []
    for pos in ("x", "v"):
        leaves = {}
        for name, shape, width in conv_leaves(lt, lx, net, pos):
            std = init_std[width] if isinstance(width, str) else width
            leaves[name] = torch.randn(shape, generator=gen,
                                       device=dev) * std
        nets.append(leaves)
    x_dim = 2 * lt * lx
    order = torch.rand((net["num_leapfrog"], x_dim), generator=gen,
                       device=dev).argsort(dim=1)
    return tuple(nets), (order < x_dim // 2).to(torch.float32)


def load_weights(params, nets, masks) -> None:
    """The drawn leaves and masks put into the program's ``params`` (every
    leaf of both nets: ``load_state_dict`` is strict)."""
    with torch.no_grad():
        for module, leaves in zip((params.xnet, params.vnet), nets):
            module.load_state_dict(leaves, strict=True)
        params.masks.copy_(masks)


def reference_nets(nets, lt: int, lx: int, bounded_q: bool):
    """The reference's ``(xnet, vnet)`` from the drawn leaves."""
    return tuple(conv_chain.ConvNet(leaves, lt, lx, bounded_q)
                 for leaves in nets)


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.net = self.cfg["sampler"]
        self.lt, self.lx = self.cfg["lattice"]
        self.b = self.tr["chains"]
        self.n = self.tr["transitions_per_call"]
        self.beta = float(self.tr["beta"])
        self.k, self.eps = self.net["num_leapfrog"], self.net["eps"]
        self.rng = random.Random(common.derive_seed(ctx.seed, 7))
        self.calls = 0
        self.checked = {}

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from l2hmc_tpu_torch.train.gauge import init_params, make_eval_chunk

        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(
            common.derive_seed(self.ctx.seed, 0))
        sigma = lattice.sigma_at(plaquette_at(self.beta))
        self.start = lattice.near_equilibrium(gen, self.b, self.lt, self.lx,
                                              sigma)
        cfg = gauge_config(self.cfg, self.b)
        nets, self.masks = seeded_conv_weights(gen, self.lt, self.lx,
                                               self.net, self.cfg["init_std"])
        self.nets = reference_nets(nets, self.lt, self.lx,
                                   self.net["bounded_q"])
        # the program's modules as the CLI builds them, every leaf then
        # replaced by the drawn ones
        built = torch.Generator(device=dev).manual_seed(
            common.derive_seed(self.ctx.seed, 3))
        self.params = init_params(cfg, built, dev)
        check_spec(self.params, self.net)
        load_weights(self.params, nets, self.masks)
        sync(dev)
        common.mark("inputs and weights")
        self.chunk = make_eval_chunk(cfg, self.n)
        common.mark("program objects")
        # every operation the window runs, at the window's shapes, on a
        # generator of its own: WARM_CALLS chained calls held at once, as
        # the window holds its first call's, its drawn call's and the last
        # call's answers beside the running one, so that the allocator's
        # pool has grown before the window (a cudaMalloc there blocks the
        # host while the card drains its ~one transition of queued
        # launches; with one warm call, five cudaMalloc fell in each
        # window, with four none)
        warm = torch.Generator(device=dev).manual_seed(
            common.derive_seed(self.ctx.seed, 2))
        held, x = [], self._flat(self.start)
        for _ in range(WARM_CALLS):
            held.append(self.chunk(self.params, x, self.beta, warm))
            x = held[-1][0]
        sync(dev)
        del held, x
        common.mark("warm call")
        self.gen = torch.Generator(device=dev).manual_seed(
            common.derive_seed(self.ctx.seed, 1))
        self.gen_start = self.gen.get_state()
        self.links = self._flat(self.start)

    def _flat(self, links):
        return links.reshape(links.shape[0], -1)

    # -- the window ----------------------------------------------------------

    def step(self):
        k = self.calls
        inp, state = self.links, self.gen.get_state()
        out = self.chunk(self.params, inp, self.beta, self.gen)
        self.links = out[0]
        if k == 0:
            self.checked["first"] = (inp, out, state)
        elif self.rng.random() < 1.0 / k:
            self.checked["drawn"] = (inp, out, state)
        self.calls += 1

    def drain(self):
        sync(self.ctx.device)

    @property
    def attempted(self) -> int:
        return self.calls

    @property
    def transitions(self) -> int:
        """Chain transitions completed in the window."""
        return self.calls * self.b * self.n

    def work(self) -> dict:
        """What the per-layer readers count with."""
        return {"kernel": "eval_chunk", "chains": self.b,
                "transitions_per_call": self.n, "num_leapfrog": self.k,
                "transitions": self.transitions, "calls": self.calls}

    def release(self):
        """Frees the program's state that the check does not read."""
        self.links = self.chunk = None
        self.params = None

    # -- the check -----------------------------------------------------------

    def reference(self, links, state, prec=chains.F32):
        gen = torch.Generator(device=self.ctx.device)
        gen.set_state(state)
        return conv_chain.conv_call(
            links.reshape(-1, self.lt, self.lx, 2), self.nets[0],
            self.nets[1], self.masks, gen, self.eps, self.beta, self.n, prec)

    def _answers(self, out):
        """The program's ``(links, plaq, charge, prob)`` of one call."""
        x, m = out
        return (x.reshape(-1, self.lt, self.lx, 2), m["plaqs"], m["charges"],
                m["accept_prob"])

    def judge(self, limits):
        """The numbers of the window's first call and of the call drawn
        from the seed (the worst of each); ``self.summaries`` keeps their
        per-chain readings."""
        self.summaries, readings = [], []
        with torch.no_grad():
            for name in ("first", "drawn"):
                if name not in self.checked:
                    continue
                inp, out, state = self.checked[name]
                s = judge.chain_summary(self._answers(out),
                                        self.reference(inp, state))
                self.summaries.append((name, s))
                readings.append(judge.chain_numbers(s, limits))
        self.failed = sum(not judge.correct(judge.with_limits(r, limits))
                          for r in readings)
        return judge.with_limits(judge.worst(readings), limits)

    def control(self, limits, prec):
        """The control's numbers: the reference computed in ``prec`` put in
        the program's place for the window's first call, judged as the
        program is."""
        with torch.no_grad():
            low = self.reference(self.start, self.gen_start, prec)
            s = judge.chain_summary(low[:4], self.reference(
                self.start, self.gen_start))
        self.summaries = [("first", s)]
        return judge.chain_numbers(s, limits)
