"""Sampling traffic: a fused U(1) sampler of the program served as batch
calls, enqueued back to back.

Traffic parameters (``traffic/<name>.json``): ``sampler`` (``l2hmc_chain``,
``hmc_chain`` or ``l2hmc_local_chain``), ``chains``, ``transitions_per_call``
and ``beta``.  The configuration gives the lattice, the trained sampler's
net, steps and step size (``sampler``) and the HMC baseline's
(``hmc_baseline``).

Every call draws its kernel seed from a CPU generator of its own, seeded
from ``--seed`` and the call's index, so no call waits for the card and
the reference knows each call's random stream.  About ``AHEAD_S`` seconds
of calls are in flight (their number from a second warm call timed on the
card, at least two), so a host stall shorter than that leaves the card
busy; the window waits for all of them.  The window's first
call starts from the set-up's links (made here from the seed); every
later call from the one before.  The check replays that first call and one
later call drawn from the seed (the program's own state at that point) in
the plain reference.
"""

from __future__ import annotations

import math
import random
from collections import deque

import numpy as np
import torch

from bench_h100.lib import common
from bench_h100.lib.common import plaquette_at, sync
from bench_h100.reference import chains, judge, lattice, philox

AHEAD_S = 4.0      # seconds of calls dispatched ahead of the one waited for
MIN_IN_FLIGHT = 2
MLP_LEAVES = ("coeff_scale", "coeff_transformation", "h_layer.b",
              "h_layer.w", "head_b", "head_w", "in_b", "in_w")


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.sampler = self.tr["sampler"]
        self.lt, self.lx = self.cfg["lattice"]
        self.b = self.tr["chains"]
        self.n = self.tr["transitions_per_call"]
        self.beta = float(self.tr["beta"])
        hmc = self.sampler == "hmc_chain"
        sm = self.cfg["hmc_baseline"] if hmc else self.cfg["sampler"]
        self.k, self.eps = sm["num_leapfrog"], sm["eps"]
        self.rng = random.Random(common.derive_seed(ctx.seed, 7))
        self.calls = 0
        self.checked = {}
        self.inflight = deque()
        self.depth = MIN_IN_FLIGHT

    # -- set-up ------------------------------------------------------------

    def setup(self):
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(
            common.derive_seed(self.ctx.seed, 0))
        sigma = lattice.sigma_at(plaquette_at(self.beta))
        self.start = lattice.near_equilibrium(gen, self.b, self.lt, self.lx,
                                              sigma)
        if self.sampler != "hmc_chain":
            self._weights(gen)
        sync(dev)
        common.mark("inputs and weights")
        self._program()
        common.mark("program objects")
        # every kernel the window runs, at the window's shapes
        out = self._call(self.start, -1)
        sync(dev)
        del out
        common.mark("warm call")
        self.depth = self._depth()
        common.mark("timed warm call")
        self.links = self.start

    def _depth(self) -> int:
        """Calls kept in flight: ``AHEAD_S`` seconds of them by a second
        warm call timed on the card, at least ``MIN_IN_FLIGHT``."""
        if not self.start.is_cuda:
            return MIN_IN_FLIGHT
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        out = self._call(self.start, -1)
        end.record()
        end.synchronize()
        del out
        call_s = begin.elapsed_time(end) / 1e3
        return max(MIN_IN_FLIGHT, math.ceil(AHEAD_S / call_s))

    def _weights(self, gen):
        """Unpacked weights for the reference (``self.nets``) and the
        program's parameters (``self.params``), from the same arrays."""
        net = self.cfg["sampler"]
        dev = self.ctx.device
        if "weights_file" in net:
            path = common.BENCH / net["weights_file"]
            with np.load(path, allow_pickle=False) as z:
                leaves = [torch.tensor(z[f"arr_{i}"], device=dev)
                          for i in range(2 * len(MLP_LEAVES) + 2)]
            m = len(MLP_LEAVES)
            raw = (dict(zip(MLP_LEAVES, leaves[:m])),
                   dict(zip(MLP_LEAVES, leaves[m:2 * m])))
            self.masks = leaves[-1]
            self.nets = tuple(chains.MLPNet(w, net["bounded_q"]) for w in raw)
            self.weights_path = path
        else:
            raw, self.masks = seeded_local_weights(
                gen, net, self.lt * self.lx, self.k, self.cfg["init_std"])
            self.nets = tuple(chains.StencilNet(
                w, net["layers"], self.lt, self.lx, net["bounded_q"])
                for w in raw)
        self.raw = raw

    def _program(self):
        """The program's own objects, built from the benchmark's inputs."""
        net = self.cfg["sampler"]
        dev = self.ctx.device
        if self.sampler == "l2hmc_chain":
            from l2hmc_tpu_torch.train.checkpoint import load_champion

            _, self.params = load_champion(self.weights_path, dev)
        elif self.sampler == "l2hmc_local_chain":
            from l2hmc_tpu_torch.dynamics.l2hmc import DynamicsParams
            from l2hmc_tpu_torch.train.gauge import GaugeConfig, build_networks

            cfg = GaugeConfig(
                time_size=self.lt, space_size=self.lx, num_steps=self.k,
                network_arch="local_flat", num_filters=net["channels"],
                local_layers=net["layers"], merge_v_halves=True,
                bounded_q=net["bounded_q"], eps_init=self.eps,
                eps_trainable=False)
            xnet, vnet = build_networks(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            for module, w in zip((xnet, vnet), self.raw):
                module.load_state_dict(w)
            self.params = DynamicsParams(xnet, vnet, self.eps, self.masks)

    # -- the window ----------------------------------------------------------

    def _generator(self, k: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            common.derive_seed(self.ctx.seed, 1, k + 1))

    def _call(self, links, k):
        """Call ``k`` of the program's sampler (``k = -1``: the warm-up)."""
        gen = self._generator(k)
        rand = None
        if not links.is_cuda:
            # the plain version on the CPU takes the kernel's stream injected
            seed, d = philox.draw_seed(gen), self.lt * self.lx
            draws = (philox.hmc_draws if self.sampler == "hmc_chain"
                     else philox.l2hmc_draws)
            rand, gen = draws(seed, self.b, d, self.n, links.device), None
        if self.sampler == "hmc_chain":
            from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

            return hmc_chain(links, gen, self.eps, self.beta, self.k, self.n,
                             rand_arrays=rand)
        from l2hmc_tpu_torch.ops import l2hmc_kernel as lk

        net = self.cfg["sampler"]
        if self.sampler == "l2hmc_chain":
            return lk.l2hmc_chain(links, self.params, gen, self.eps,
                                  self.beta, self.k, self.n,
                                  bounded_q=net["bounded_q"],
                                  rand_arrays=rand)
        return lk.l2hmc_local_chain(links, self.params, gen, self.eps,
                                    self.beta, self.k, self.n, net["layers"],
                                    bounded_q=net["bounded_q"],
                                    rand_arrays=rand)

    def step(self):
        k = self.calls
        inp = self.links
        out = self._call(inp, k)
        self.links = out[0]
        if k == 0:
            self.checked["first"] = (inp, out, k)
        elif self.rng.random() < 1.0 / k:
            self.checked["drawn"] = (inp, out, k)
        self.calls += 1
        if self.links.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.inflight.append(ev)
            if len(self.inflight) > self.depth:
                self.inflight.popleft().synchronize()

    def drain(self):
        sync(self.ctx.device)
        self.inflight.clear()

    @property
    def attempted(self) -> int:
        return self.calls

    @property
    def transitions(self) -> int:
        """Chain transitions completed in the window."""
        return self.calls * self.b * self.n

    def work(self) -> dict:
        """What the per-layer readers count with: launches of the sampler
        per call, and its shapes."""
        return {"kernel": self.sampler, "chains": self.b,
                "transitions_per_call": self.n, "num_leapfrog": self.k,
                "transitions": self.transitions, "in_flight": self.depth}

    def release(self):
        """Frees the program's state that the check does not read."""
        self.links = self.start = None
        self.params = None

    # -- the check -----------------------------------------------------------

    def reference(self, links, k, prec=chains.F32):
        seed = philox.draw_seed(self._generator(k))
        if self.sampler == "hmc_chain":
            return chains.hmc_call(links, seed, self.eps, self.beta, self.k,
                                   self.n, prec)
        return chains.l2hmc_call(links, self.nets[0], self.nets[1],
                                 self.masks, seed, self.eps, self.beta,
                                 self.n, prec)

    def judge(self, limits):
        """The numbers of the window's first call and of the call drawn
        from the seed (the worst of each); ``self.summaries`` keeps their
        per-chain readings."""
        self.summaries, readings = [], []
        with torch.no_grad():
            for name in ("first", "drawn"):
                if name not in self.checked:
                    continue
                inp, out, k = self.checked[name]
                s = judge.chain_summary(out, self.reference(inp, k))
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
            low = self.reference(self.start, 0, prec)
            s = judge.chain_summary(low[:4], self.reference(self.start, 0))
        self.summaries = [("first", s)]
        return judge.chain_numbers(s, limits)


def seeded_local_weights(gen, net: dict, d: int, num_steps: int,
                         init_std: float):
    """The local conditioner's two nets and the hold masks, made on the
    generator's device from the seed in two calls: stencil weights at the
    He scale of their fan-in, the time rows likewise, the 1x1 heads and
    every bias normal of width ``init_std``, the coefficients zero;
    each mask a random half of the ``2 d`` links."""
    c, layers = net["channels"], net["layers"]
    dev = gen.device
    shapes = [("stencil_0.w", (5, 6, c)), ("stencil_0.wt", (2, c)),
              ("stencil_0.b", (c,))]
    for i in range(1, layers):
        shapes += [(f"stencil_{i}.w", (5, c, c)), (f"stencil_{i}.b", (c,))]
    shapes += [("head.w", (c, 6)), ("head.b", (6,))]
    sizes = [math.prod(s) for _, s in shapes]
    flat = torch.randn((2, sum(sizes)), generator=gen, device=dev)
    nets = []
    for row in flat:
        w, at = {}, 0
        for (name, shape), size in zip(shapes, sizes):
            t = row[at:at + size].reshape(shape)
            at += size
            if name.endswith(".w") and name.startswith("stencil"):
                fan = 5 * shape[1] + (2 if name == "stencil_0.w" else 0)
                t = t * math.sqrt(2.0 / fan)
            elif name == "stencil_0.wt":
                t = t * math.sqrt(2.0 / (5 * 6 + 2))
            else:
                t = t * init_std
            w[name] = t.contiguous()
        w["coeff_scale"] = torch.zeros(2, device=dev)
        w["coeff_transformation"] = torch.zeros(2, device=dev)
        nets.append(w)
    order = torch.rand((num_steps, 2 * d), generator=gen,
                       device=dev).argsort(dim=1)
    masks = (order < d).to(torch.float32)
    return tuple(nets), masks
