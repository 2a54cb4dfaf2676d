"""Share of the roofline of the fused DP and backtrack
(``csrc/dp_backtrack.cu``) at top-M 64: tier 0 and the k=10 and k=12 tiers,
in percent."""

from portbench.roofline import share


def read(ctx):
    t = ctx["trace"]
    return None if t is None else share(t["launches"], "dp_backtrack", 64)
