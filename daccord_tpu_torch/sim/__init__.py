from .synth import SimConfig, SimResult, make_dataset, simulate

__all__ = ["SimConfig", "SimResult", "simulate", "make_dataset"]
