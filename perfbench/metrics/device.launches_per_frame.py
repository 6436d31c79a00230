"""Kernels launched per frame of the traced calls (the profiler's count)."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    return t["kernels"] / t["frames"]
