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
networks  the S/T/Q conditioners (MLP, local 5-point stencil) as
          ``nn.Module``s
dynamics  the trained L2HMC transition (u1, merge_v_halves), plain HMC,
          the exact instanton hop, dual averaging of the step size
train     gauge config, builders, losses, schedules, the optimizer and train
          step, train/eval chunks, checkpoints

Entry points that create tensors put them on the first CUDA device unless
given ``device="cpu"`` (``_device.resolve_device``).

Conventions kept from the reference: links are ``(B, Lt, Lx, 2)`` angles,
the flat state is ``(B, 2*Lt*Lx)`` interleaved as ``(t*Lx + s)*2 + mu``,
chain traces are ``(N, B)``.  Randomness is drawn from an explicit
``torch.Generator``; nothing uses the global RNG.
"""

__version__ = "0.1.0"
