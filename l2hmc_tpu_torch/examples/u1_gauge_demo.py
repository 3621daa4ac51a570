"""U(1) lattice gauge demo: train the sampler, check it against exact
values (port of ``examples/u1_gauge_demo.py``).

Trains the L x L L2HMC gauge sampler with beta annealing, then samples
and prints the average plaquette against I1/I0 and <Q^2> against the
finite-volume value.  Exits 1 unless the plaquette is within 0.01 and
<Q^2> within 25% (or 0.05) of exact.

Usage: python -m l2hmc_tpu_torch.examples.u1_gauge_demo [--train_steps 2000]
"""

import argparse


def run(args):
    """Train and sample: ``{"plaq", "plaq_exact", "q2", "q2_exact"}``."""
    import torch

    from l2hmc_tpu_torch._device import float32_matmuls, resolve_device
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.train.gauge import (
        GaugeConfig, init_train_state, make_eval_chunk, make_train_chunk,
    )

    float32_matmuls()
    device = resolve_device(args.device)
    cfg = GaugeConfig(time_size=args.l, space_size=args.l,
                      num_chains=args.num_chains, num_steps=3,
                      network_arch=args.arch, train_steps=args.train_steps,
                      beta_init=2.0, beta_final=args.beta)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, gen, device)
    chunk_size = min(200, cfg.train_steps)
    chunk = make_train_chunk(cfg, chunk_size)
    exact_p = float(u1.u1_plaq_exact(args.beta))
    done = 0
    while done < cfg.train_steps:
        state, m = chunk(state, gen)
        done += chunk_size
        print(f"step {done:5d}  loss {float(m['loss'][-1]):9.2f}  "
              f"acc {float(m['accept_prob'][-1]):.3f}  "
              f"plaq {float(m['plaqs'][-1]):.4f}  "
              f"(exact@beta_final {exact_p:.4f})", flush=True)

    ev = make_eval_chunk(cfg, args.eval_steps)
    _, met = ev(state.params, state.x, args.beta, gen)
    cut = args.eval_steps // 4
    q = met["charges"][cut:]
    return {"plaq": float(met["plaqs"][cut:].mean()), "plaq_exact": exact_p,
            "q2": float((q * q).mean()),
            "q2_exact": float(u1.topological_susceptibility_exact(
                args.beta, args.l * args.l))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--l", type=int, default=8)
    p.add_argument("--train_steps", type=int, default=2000)
    p.add_argument("--eval_steps", type=int, default=4000)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--arch", default="mlp", choices=["mlp", "conv"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    args = p.parse_args(argv)

    r = run(args)
    plaq, exact_p, q2, q2_exact = (r["plaq"], r["plaq_exact"], r["q2"],
                                   r["q2_exact"])
    print(f"\n<plaq> {plaq:.5f}  exact {exact_p:.5f}  "
          f"(err {abs(plaq - exact_p):.2e})")
    print(f"<Q^2>  {q2:.4f}  exact {q2_exact:.4f}")
    ok = (abs(plaq - exact_p) < 0.01
          and abs(q2 - q2_exact) < max(0.25 * q2_exact, 0.05))
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
