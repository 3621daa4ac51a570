"""Flow+HMC hybrid chain against pure HMC on topological mixing (port of
``benchmarks/flow_hybrid.py``).

Independence proposals from a trained flow draw a fresh topological
sector, so even a modest flow acceptance can beat local kernels on
tau_int(Q).  Measured cost-normalized:

  hybrid:  M HMC transitions + 1 flow independence proposal per round
           (``dynamics/flow.py flow_hmc_hybrid_chain``)
  control: the same rounds without the flow move

Both start from the same links, thermalized by the fused HMC chain
(``csrc/hmc_chain.cu`` on the card); the HMC transitions run on the Wilson
kernels' fused force.  Reads a run dir of the port's ``train_flow`` and
prints one JSON line with the JAX script's keys::

    python -m l2hmc_tpu_torch.benchmarks.flow_hybrid \\
        --checkpoint runs/flow16/run_1 --beta 4.0 --rounds 400
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def log(msg):
    print(f"[flow_hybrid {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="run dir of the port's train_flow (reads "
                        "checkpoints/)")
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--chains", type=int, default=128)
    p.add_argument("--rounds", type=int, default=400)
    p.add_argument("--chunk_rounds", type=int, default=50)
    p.add_argument("--hmc_per_round", type=int, default=10)
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--hmc_leapfrog", type=int, default=5)
    p.add_argument("--therm", type=int, default=500,
                   help="HMC thermalization")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from l2hmc_tpu_torch._device import resolve_device
    from l2hmc_tpu_torch.analysis import stats
    from l2hmc_tpu_torch.dynamics import flow as F
    from l2hmc_tpu_torch.dynamics.hmc import hmc_chain_u1_fused, hmc_transition
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn
    from l2hmc_tpu_torch.train import checkpoint as ckpt

    device = resolve_device(args.device)
    run_dir = Path(args.checkpoint)
    cfg_dict = ckpt.load_config_dict(run_dir / "checkpoints")
    if cfg_dict is None:
        raise FileNotFoundError(
            f"no config.json under {run_dir}/checkpoints — is this a "
            "train_flow run dir?")
    cfg = F.FlowConfig(**cfg_dict)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = F.init_flow(gen, cfg, device)
    params.load_state_dict(
        ckpt.load_tensors(run_dir / "checkpoints", device=device)["params"])
    lt, lx = cfg.time_size, cfg.space_size
    b = args.chains
    pot = make_potential_fn(u1.LatticeShape(lt, lx))
    log(f"{lt}x{lx} beta={args.beta} layers={cfg.num_layers} chains={b}")

    links = torch.zeros((b, lt, lx, 2), device=device)
    links, _, _, _ = hmc_chain_u1_fused(links, gen, args.hmc_eps, args.beta,
                                        args.hmc_leapfrog, args.therm)
    log("thermalized")

    def hybrid_chunk(links):
        out = F.flow_hmc_hybrid_chain(
            params, gen, links, args.beta, args.chunk_rounds,
            args.hmc_per_round, args.hmc_eps, args.hmc_leapfrog, cfg)
        return out[0], out[1], out[3], out[2]

    @torch.no_grad()
    def control_chunk(links):
        x = links.reshape(b, -1)
        qs, accs = [], []
        for _ in range(args.chunk_rounds):
            probs = []
            for _ in range(args.hmc_per_round):
                out = hmc_transition(pot, x, args.beta, args.hmc_eps,
                                     args.hmc_leapfrog, gen)
                x = u1.wrap(out.x_out)
                probs.append(out.accept_prob)
            qs.append(u1.topological_charge(x.reshape(b, lt, lx, 2)))
            accs.append(torch.mean(torch.stack(probs)))
        return x.reshape(b, lt, lx, 2), torch.stack(qs), torch.stack(accs), \
            None

    n_chunks = max(1, args.rounds // args.chunk_rounds)
    n_rounds = n_chunks * args.chunk_rounds

    def run_chain(chunk_fn, links):
        qs_all, acc_all, plaq_all = [], [], []
        if links.is_cuda:
            torch.cuda.synchronize(links.device)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            links, q, acc, plaq = chunk_fn(links)
            qs_all.append(q)
            acc_all.append(acc)
            if plaq is not None:
                plaq_all.append(plaq)
        if links.is_cuda:
            torch.cuda.synchronize(links.device)
        wall = time.perf_counter() - t0
        qs = torch.cat(qs_all).cpu().numpy()
        acc = float(np.mean([float(a.mean()) for a in acc_all]))
        plaq = (float(np.mean([float(p.mean()) for p in plaq_all]))
                if plaq_all else None)
        return qs, acc, plaq, wall

    qs_h, facc, plaq_h, wall_h = run_chain(hybrid_chunk, links)
    log(f"hybrid done: {wall_h:.1f}s flow_acc={facc:.4f}")
    qs_c, hacc, _, wall_c = run_chain(control_chunk, links)
    log(f"control done: {wall_c:.1f}s hmc_acc={hacc:.4f}")

    def q_stats(q):
        dq = np.abs(np.diff(q, axis=0)).mean()
        taus = [stats.integrated_time(q[:, c])[0]
                for c in range(min(32, q.shape[1]))]
        return float(dq), float(np.mean(taus)), float((q ** 2).mean())

    dq_h, tau_h, chi_h = q_stats(qs_h)
    dq_c, tau_c, chi_c = q_stats(qs_c)
    chi_exact = float(u1.topological_susceptibility_exact(args.beta, lt * lx))
    result = {
        "lattice": f"{lt}x{lx}", "beta": args.beta, "chains": b,
        "rounds": n_rounds, "hmc_per_round": args.hmc_per_round,
        "flow_accept": round(facc, 4),
        "hmc_accept": round(hacc, 4),
        "plaq_hybrid": round(plaq_h, 5),
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta)), 5),
        "chi_q": {"hybrid": round(chi_h, 3), "hmc": round(chi_c, 3),
                  "exact": round(chi_exact, 3)},
        "dq_per_round": {"hybrid": round(dq_h, 4), "hmc": round(dq_c, 4)},
        "tau_int_q_rounds": {"hybrid": round(tau_h, 2),
                             "hmc": round(tau_c, 2)},
        "wall_s": {"hybrid": round(wall_h, 2), "hmc": round(wall_c, 2)},
        "dq_per_s": {
            "hybrid": round(dq_h * n_rounds / wall_h, 2),
            "hmc": round(dq_c * n_rounds / wall_c, 2)},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
