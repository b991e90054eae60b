"""The user programs of ``examples/``, over the port: each module here
is the counterpart of the JAX example of the same name and runs as

    python -m risc0_tpu_torch.examples.<name> [--device cpu]

Every example proves on the card unless ``--device`` names another
device, and raises without one, dev mode included.  The proving modes
are the JAX examples': dev mode by default, ``RISC0_REAL_PROVE=1`` for a
real prove, and ``RISC0_DEV_MODE`` where the JAX example reads it
(``povw``, ``cluster``, ``bonsai_remote``).  Each ``main(argv)`` returns
what it computed (the guest ELF, the image ID, the session, the
receipt), so a test or a smoke run can check it; importing a module does
nothing.
"""
