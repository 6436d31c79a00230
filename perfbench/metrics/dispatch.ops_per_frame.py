"""Tensor operations dispatched per frame (a TorchDispatchMode count)."""


def read(rec):
    if "ops" not in rec:
        return None
    return rec["ops"] / rec["ops_frames"]
