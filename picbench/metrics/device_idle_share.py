"""1 - (union of device op intervals / wall time) over the traced graphed
window.  A trace does not show the kernels of a conditional node's body,
so on a deck with interval cleans the window holds only steps between
two cleans."""


def read(rec):
    g = rec.get("graphed")
    if g is None or g["window_s"] <= 0 or g["busy_s"] <= 0:
        return None
    return 1.0 - g["busy_s"] / g["window_s"]
