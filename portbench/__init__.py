"""The benchmark of ``daccord_tpu_torch``: concurrent window streams through
the port's cross-job solve group on one card.

``python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` from the root of a checkout. Everything
that belongs to one configuration, traffic mix or metric is a file of its
own (``configs/``, ``traffic/``, ``metrics/``), found by its name. The
reference (``reference/``) imports numpy only.
"""
