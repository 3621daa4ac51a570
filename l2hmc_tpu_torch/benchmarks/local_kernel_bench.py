"""The in-kernel 5-point-stencil conditioner at volume: cost decomposition.

Port of ``benchmarks/local_kernel_bench.py``.  On the card, for each
stencil variant ``cNL{1,2}`` (c channels, L layers) of
``csrc/l2hmc_local_chain.cu``:

- us/transition of the kernel with the conditioner, and of the same kernel
  with ``ablate_nets=True`` (``_abl``): full - ablated = the conditioner;
- the fused HMC chain at the trained K (``hmc_fused_kT``): ablated - hmc =
  the L2HMC machinery; and at HMC's own K (``hmc_fused``);
- with ``--hop``, the kernel with one instanton hop per transition;
- with ``--xla``, the eager PyTorch baselines of the JAX script's XLA ones:
  ``make_eval_chunk`` of ``local_flat`` c8L2 and of the zero-net HMC.

A variant whose chain does not fit the kernel's shared memory (c8L2 at
64x64) is recorded with the wrapper's ``ValueError``; any other failure
raises.  Weights are the port's seeded init: kernel time does not depend on
their values.  Times are the least of ``--reps`` calls of ``--nt``
transitions after a warm-up call, by CUDA events.

Usage (on the card)::

    python3 -m l2hmc_tpu_torch.benchmarks.local_kernel_bench --size 64 \\
        --chains 512 --k 4 --hmc_k 8 --hmc_eps 0.04552
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def _trace(msg):
    print(f"[lkb {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def local_cfg(size, chains, K, eps, beta, channels, layers):
    from l2hmc_tpu_torch.train.gauge import GaugeConfig

    return GaugeConfig(time_size=size, space_size=size, num_chains=chains,
                       num_steps=K, network_arch="local_flat",
                       num_filters=channels, local_layers=layers,
                       merge_v_halves=True, eps_init=eps, eps_trainable=False,
                       beta_final=beta)


def parse_variants(spec):
    """``'c4L1,c8L2'`` -> ``[('c4L1', 4, 1), ('c8L2', 8, 2)]``."""
    out = []
    for v in spec.split(","):
        c, nl = v.strip().split("L")
        out.append((v.strip(), int(c[1:]), int(nl)))
    return out


def time_local(links, generator, variants, K, eps, beta, nt, reps,
               hmc_ks=(), hmc_eps=None, modes=("", "_abl")):
    """``{name: us/transition or {'error': ...}}`` of each stencil variant
    ``(name, c, L)`` in each mode (``''`` full, ``'_abl'`` ablated,
    ``'_hop'`` with the hop), then ``hmc_chain`` at each ``(tag, K)`` of
    ``hmc_ks``, all from ``links``."""
    from l2hmc_tpu_torch.benchmarks import best_ms
    from l2hmc_tpu_torch.ops.l2hmc_kernel import l2hmc_local_chain
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain
    from l2hmc_tpu_torch.train.gauge import init_params

    b, size = links.shape[0], links.shape[1]
    res = {}
    for name, c, nl in variants:
        params = init_params(local_cfg(size, b, K, eps, beta, c, nl),
                             torch.Generator().manual_seed(5),
                             device=links.device)
        for sfx in modes:
            def run(params=params, nl=nl, sfx=sfx):
                return l2hmc_local_chain(
                    links, params, generator, eps, beta, K, nt, nl,
                    hop=sfx == "_hop", ablate_nets=sfx == "_abl")
            try:
                res[name + sfx] = best_ms(run, reps) * 1e3 / nt
            except ValueError as e:   # the chain does not fit the kernel
                res[name + sfx] = {"error": str(e)}
            _trace(f"{name}{sfx}: {res[name + sfx]}")
    for tag, k_h in hmc_ks:
        res[tag] = best_ms(lambda k_h=k_h: hmc_chain(
            links, generator, hmc_eps, beta, k_h, nt), reps) * 1e3 / nt
        _trace(f"{tag} (K={k_h}): {res[tag]:.1f} us/transition")
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--chains", type=int, default=512)
    p.add_argument("--k", type=int, default=4, help="trained leapfrog K")
    p.add_argument("--eps", type=float, default=0.10014)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--nt", type=int, default=100,
                   help="transitions per kernel call")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--hmc_k", type=int, default=8)
    p.add_argument("--hmc_eps", type=float, default=0.04552)
    p.add_argument("--variants", default="c4L1,c8L1,c8L2",
                   help="comma list of stencil variants cNL{1,2}")
    p.add_argument("--hop", action="store_true",
                   help="also time the hop-fused variants")
    p.add_argument("--xla", action="store_true",
                   help="also time the eager local_flat c8L2 eval chunk and "
                        "the eager zero-net HMC (the JAX script's XLA "
                        "baselines)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.benchmarks import best_ms, device_info
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_params,
                                             make_eval_chunk)

    device = resolve_device(None)
    shape = u1.LatticeShape(args.size, args.size)
    gen = torch.Generator(device=device).manual_seed(5)
    links = u1.to_links(u1.random_links(gen, args.chains, shape,
                                        device=device), shape).contiguous()
    modes = ("", "_abl") + (("_hop",) if args.hop else ())
    res = time_local(links, gen, parse_variants(args.variants), args.k,
                     args.eps, args.beta, args.nt, args.reps,
                     hmc_ks=(("hmc_fused", args.hmc_k),
                             ("hmc_fused_kT", args.k)),
                     hmc_eps=args.hmc_eps, modes=modes)
    res = {k: v if isinstance(v, dict) else {"us_per_transition": v}
           for k, v in res.items()}

    if args.xla:
        x = u1.to_flat(links)
        for tag, cfg_x in (
                ("xla_localflat_c8L2", local_cfg(
                    args.size, args.chains, args.k, args.eps, args.beta, 8,
                    2)),
                ("xla_hmc", GaugeConfig(
                    time_size=args.size, space_size=args.size,
                    num_chains=args.chains, num_steps=args.hmc_k, hmc=True,
                    network_arch="zero", merge_v_halves=True,
                    eps_init=args.hmc_eps, eps_trainable=False,
                    beta_final=args.beta))):
            params = init_params(cfg_x, torch.Generator().manual_seed(5),
                                 device=device)
            chunk = make_eval_chunk(cfg_x, args.nt)
            ms = best_ms(lambda: chunk(params, x, args.beta, gen),
                         args.reps)
            res[tag] = {"us_per_transition": ms * 1e3 / args.nt}
            _trace(f"{tag}: {res[tag]['us_per_transition']:.1f} us")

    result = {"benchmark": "local_kernel_bench",
              "device": device_info(),
              "config": {"size": args.size, "chains": args.chains,
                         "K": args.k, "nt": args.nt,
                         "hmc": f"K={args.hmc_k} eps={args.hmc_eps}"},
              "variants": res}
    out_s = json.dumps(result)
    print(out_s)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
