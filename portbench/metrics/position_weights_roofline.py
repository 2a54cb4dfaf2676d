"""Share of the roofline of the OffsetLikely weights W
(``csrc/position_weights.cu``), every tier, in percent."""

from portbench.roofline import share


def read(ctx):
    t = ctx["trace"]
    return None if t is None else share(t["launches"], "position_weights", None)
