"""Tensor operations dispatched per frame of the fleet's counted calls (a
TorchDispatchMode count), over all S streams' frames."""


def read(rec):
    if "ops" not in rec:
        return None
    return rec["ops"] / rec["ops_frames"]
