"""Multi-device path on ``torch.distributed`` (port of ``l2hmc_tpu/parallel``).

``mesh``    the ``(data, space)`` process mesh, the launcher bring-up, and
            the chain-sharding operations (slice, gather, replicate)
``domain``  the Wilson action with the lattice's time axis sharded over
            'space' and one-row halo exchanges
``dryrun``  the twin of ``__graft_entry__.dryrun_multichip`` on n spawned
            ranks (sharding modes 1, 2, 4, 5 and 6)
"""
