"""Host time of the chunk's bundle adjustment (the ``slam.ba`` span) per
chunk, from the pass under the program's span recorder."""


def read(rec):
    s = rec.get("spans", {}).get("slam.ba")
    if s is None:
        return None
    return s["host_s"] * 1e3 / rec["span_calls"]
