"""The CCL kernels' share of their byte bound: one int8 read and one int32
write per pixel of the decimated map at the HBM's 3.35 TB/s, over their
device time in the traced calls."""

from perfbench.reduce import ccl_bytes, roofline_pct


def read(rec):
    t = rec.get("trace")
    if not t or t["ccl_s"] <= 0:
        return None
    return roofline_pct(ccl_bytes(t["frames"], rec["height"], rec["width"], rec["decimate"]), t["ccl_s"])
