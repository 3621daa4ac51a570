"""Example scripts of the port, each run as
``python -m l2hmc_tpu_torch.examples.<name>`` (``--device cpu`` runs the
plain versions on the CPU)."""
