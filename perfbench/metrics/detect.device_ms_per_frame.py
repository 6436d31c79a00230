"""Device time of the kernels launched under the detector's stage_* ranges,
per frame of the traced calls."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["stage_s"]:
        return None
    return sum(t["stage_s"].values()) * 1e3 / t["frames"]
