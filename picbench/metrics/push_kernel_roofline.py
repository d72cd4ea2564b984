"""The push kernel's share of its roofline, in %: the least time the
traced graphed window's pushes could take (``picbench/counts/push.py``:
every species pushed once a step, bytes over the bandwidth or operations
over the rate, whichever is larger) over the device time of the kernels
named ``push_walk_kernel`` in that window.  Nothing is returned where the
window holds no such kernel."""

from picbench.counts.push import least_seconds

KERNEL = "push_walk_kernel"


def read(rec):
    g = rec.get("graphed")
    if g is None:
        return None
    t = sum(e - s for name, s, e in g["kernels"] if KERNEL in name) / 1e6
    if t <= 0:
        return None
    d = rec["deck"]
    return 100.0 * g["steps"] * least_seconds(d["live"], d["cells"]) / t
