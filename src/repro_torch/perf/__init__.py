from repro_torch.perf.timers import LatencyStats

__all__ = ["LatencyStats"]
