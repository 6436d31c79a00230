"""Device time of the kernels, copies and memsets launched under the back
end's span (``slam.back`` and the spans under it), per traced chunk."""

from perfbench.spans import subtree


def read(rec):
    t = rec.get("trace", {})
    if "slam.back" not in t.get("span_parents", {}):
        return None
    dev = t["span_device_s"]
    s = sum(dev.get(n, 0.0) for n in subtree(t["span_parents"], "slam.back"))
    return s * 1e3 / (t["frames"] / rec["frames_per_call"])
