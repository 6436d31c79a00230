"""Device time outside every detector stage, per frame: in a cell that runs
only detection and PnP, PnP and its glue."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["stage_s"]:
        return None
    return t["outside_stage_s"] * 1e3 / t["frames"]
