"""The train step of the README's commands on the card, with remat on and
off.

Builds each command's config from its flags (``cli/train_gauge.py``'s
parser), trains ``--warm`` steps from a seeded init, then times chunks of
``--steps`` train steps in turns (remat on, off, off, on; each turn from a
copy of the warmed state and generator), by CUDA events, and counts the
Wilson kernels' launches per step.  One window of three steps per setting
is traced with torch.profiler for the device time and the kernel count.
Prints one JSON line with the card's name and power limit::

    python3 -m l2hmc_tpu_torch.benchmarks.train_step_time [--steps 20]
"""

from __future__ import annotations

import argparse
import json

import torch

from l2hmc_tpu_torch._device import float32_matmuls
from l2hmc_tpu_torch.benchmarks import device_info, device_profile

# the README's commands (README.md "Quick start", "The topological sampler")
COMMANDS = {
    "canonical8": ["--space_size", "8", "--time_size", "8", "--num_samples",
                   "128", "--num_steps", "3", "--eps", "0.35", "--beta_init",
                   "2", "--beta_final", "4", "--train_steps", "5000"],
    "hmc16": ["--hmc", "--eps", "0.2921", "--space_size", "16",
              "--time_size", "16"],
    "topo16": ["--time_size", "16", "--space_size", "16", "--num_samples",
               "128", "--num_steps", "4", "--eps", "0.079", "--eps_fixed",
               "--network_arch", "mlp", "--num_hidden", "64",
               "--merge_v_halves", "--charge_reward", "--train_hops",
               "--beta_final", "5.0", "--train_steps", "12000"],
}


def wilson_launches():
    from l2hmc_tpu_torch.ops import wilson as W

    fns = (W.wilson_forward, W.wilson_action_only, W.wilson_backward,
           W.wilson_force, W.wilson_double_backward)
    return {f.__name__: f.launches for f in fns}


def time_command(argv, steps, warm, device):
    from l2hmc_tpu_torch.cli.train_gauge import build_parser, flags_to_config
    from l2hmc_tpu_torch.train import gauge as tg

    cfg = flags_to_config(build_parser().parse_args(argv))
    gen = torch.Generator(device=device).manual_seed(0)
    state = tg.init_train_state(cfg, gen, device)
    state, _ = tg.make_train_chunk(cfg, warm)(state, gen)
    chunks = {r: tg.make_train_chunk(cfg, steps, remat=r)
              for r in (True, False)}
    gen_state = gen.get_state()
    out = {"remat_on_ms": [], "remat_off_ms": []}
    for remat in (True, False, False, True):
        st = tg.clone_train_state(state)
        gen.set_state(gen_state)
        before = wilson_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chunks[remat](st, gen)
        end.record()
        torch.cuda.synchronize()
        key = "remat_on" if remat else "remat_off"
        out[f"{key}_ms"].append(start.elapsed_time(end) / steps)
        after = wilson_launches()
        out[f"{key}_wilson_launches_per_step"] = {
            k: (after[k] - before[k]) / steps for k in after}
    for remat in (True, False):
        step = tg.make_train_step(cfg, remat=remat)[0]
        st = tg.clone_train_state(state)
        prof = device_profile(lambda: step(st, gen), 3)
        key = "remat_on" if remat else "remat_off"
        out[f"{key}_device_ms"] = None if prof is None else prof[0]
        out[f"{key}_kernels_per_step"] = None if prof is None else prof[1]
    torch.cuda.reset_peak_memory_stats(device)
    for remat in (True, False):
        st = tg.clone_train_state(state)
        torch.cuda.reset_peak_memory_stats(device)
        tg.make_train_step(cfg, remat=remat)[0](st, gen)
        torch.cuda.synchronize()
        key = "remat_on" if remat else "remat_off"
        out[f"{key}_peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warm", type=int, default=5)
    p.add_argument("--commands", nargs="+", default=list(COMMANDS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("train_step_time needs a CUDA device")
    float32_matmuls()
    device = torch.device("cuda", 0)
    res = {name: time_command(COMMANDS[name], args.steps, args.warm, device)
           for name in args.commands}
    print(json.dumps({"train_step_time": res, "steps": args.steps,
                      "device": device_info()}), flush=True)


if __name__ == "__main__":
    main()
