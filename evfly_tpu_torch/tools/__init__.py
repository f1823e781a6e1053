"""The drivers of the port, one module per driver of the repo's ``tools/``
(``tools/<name>.py`` -> ``evfly_tpu_torch.tools.<name>``), each run as

    python -m evfly_tpu_torch.tools.<name> ...

with the JAX driver's arguments and a ``--device`` (CUDA by default; ``cpu``
to run on the CPU) where it runs a model, the simulator or the envs.
Importing a driver touches no device.
"""
