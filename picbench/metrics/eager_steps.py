"""Steps that ran op by op inside the traced graphed window (the delta of
``Simulation.dispatch_counts["eager_steps"]``): each costs 5-10 graphed
steps."""


def read(rec):
    g = rec.get("graphed")
    return None if g is None else g["eager_steps"]
