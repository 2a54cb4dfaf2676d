"""Share of the roofline of the Myers rescore and pick (``csrc/rescore.cu``),
every tier; its operations count the segment bases of the rows each tier
solves, in percent."""

from portbench.roofline import share


def read(ctx):
    t = ctx["trace"]
    return None if t is None else share(t["launches"], "rescore", None)
