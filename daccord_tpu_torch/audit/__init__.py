"""The shadow audit's reference outside the pipeline's process.

``ladder``: the port's CPU ladder (``kernels/tiers.py`` through every
kernel's plain version) transcribed op for op into numpy, byte-equal to it.
``worker``: the process that solves the audit's samples on it, and the
pipeline's handle on that process.

Nothing here imports torch (nor does this package's ``__init__``): the
worker starts in under a second, where one that imported torch took 9-12 s
on an H100 host.
"""
