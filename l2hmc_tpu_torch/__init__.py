"""l2hmc_tpu_torch — the PyTorch/CUDA port of ``l2hmc_tpu``.

The JAX package ``l2hmc_tpu`` is the reference; this package mirrors its
subpackage and module names so each counterpart is found at the same path.
It imports ``torch`` and never ``jax``.

Subpackages
-----------
lattice   U(1) gauge lattice: Wilson action, observables, exact oracles;
          the checkerboard Metropolis sampler (warm start)
ops       Wilson action with analytic gradient and its kernels (forward,
          backward, double backward); the fused chain kernels (hand-written
          CUDA C++ for sm_90a, with plain PyTorch versions)
networks  the S/T/Q conditioners (MLP, periodic CNN, local image net,
          local 5-point stencil) as ``nn.Module``s
dynamics  the trained L2HMC transition (every DynamicsConfig setting but
          the chain operator), plain HMC, the exact instanton hop, dual
          averaging of the step size; the ensembles (SMC, replica
          exchange, AIS, multinomial HMC); the gauge-equivariant flow
train     gauge config, builders, losses, schedules, the optimizer and train
          step, train/eval chunks, checkpoints (save, restore, JAX states
          carried across)
analysis  MCMC statistics and the offline re-analysis of a run dir (numpy)
utils     argfile parsing, run dirs, the metrics logger
parallel  the multi-device path on ``torch.distributed``: the process
          mesh and chain sharding, the domain-decomposed action, the dry run
cli       ``python -m l2hmc_tpu_torch.cli.train_gauge`` (the training CLI,
          data-parallel under ``torchrun``), ``.train_flow`` and
          ``.analyze_run``

Entry points that create tensors put them on this process's CUDA device
(``cuda:<local rank>``) unless given ``device="cpu"``
(``_device.resolve_device``).

Conventions kept from the reference: links are ``(B, Lt, Lx, 2)`` angles,
the flat state is ``(B, 2*Lt*Lx)`` interleaved as ``(t*Lx + s)*2 + mu``,
chain traces are ``(N, B)``.  Randomness is drawn from an explicit
``torch.Generator``; nothing uses the global RNG.
"""

__version__ = "0.1.0"
