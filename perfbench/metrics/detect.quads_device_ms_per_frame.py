"""Device time of the kernels launched under stage_quads, per frame."""


def read(rec):
    t = rec.get("trace")
    if not t or "stage_quads" not in t["stage_s"]:
        return None
    return t["stage_s"]["stage_quads"] * 1e3 / t["frames"]
