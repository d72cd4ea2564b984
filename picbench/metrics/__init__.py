"""One reader per per-layer metric: ``picbench/metrics/<name>.py`` with
``read(record) -> number or None``, over the traced run's record
(``picbench/run.py``'s ``traced``).  A reader that finds nothing to read
returns None and the harness leaves the metric out."""


def part_ms(rec, part):
    """Busy device ms per op-by-op step in one of the program's step-part
    scopes; None without op-by-op steps or without the scope's ops."""
    e = rec.get("eager")
    if e is None or not e["steps"] or not e["parts_s"].get(part):
        return None
    return 1e3 * e["parts_s"][part] / e["steps"]
