"""Share of the traced slice in which no operation ran on the card (the
union of the timeline's kernel, copy and set intervals), in percent."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
