"""Host launch calls (``cudaGraphLaunch`` and ``cudaLaunchKernel`` and its
kin) in the traced slice over the ladder calls the card ran in it."""

LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch")


def read(ctx):
    t = ctx["trace"]
    if t is None or t["calls"] <= 0:
        return None
    return sum(h["name"] in LAUNCH_APIS for h in t["parsed"]["host"]) / t["calls"]
