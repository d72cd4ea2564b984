"""Run one cell of the benchmark of vpic_tpu_torch on the card:

    python3 picbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Set-up builds the cell's deck through the
deck API from ``--seed`` (its numpy draws of the particles, its fields;
the kernels are built into ``vpic_tpu_torch/_build`` on the first run of
a checkout), runs the units of the deck's dispatch plan that the window
will replay (capturing their CUDA graphs) and times one.  The window
then replays whole units, the host kept a tenth of a second ahead of the
card, until ``--seconds`` have passed, and ends in a synchronize.  With
``--trace 0`` it prints the cell's end-to-end metrics; with ``--trace 1``
a profiled graphed window and a profiled op-by-op window give the
per-layer metrics (``picbench/metrics``).  Then a few more units are snapshotted, the
program is freed, and the plain reference (``picbench/reference``) judges
``correct`` (``picbench/judge.py``).  The last line of standard output is
the result, as JSON; the numbers compared, each beside its limit, end
standard error and the result.

Exits with 3, printing no result, without a CUDA card or with fewer than
the cell asks for, and with 4 where a module of JAX or of the JAX package
``vpic_tpu`` has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vpic_tpu")


def forbidden(modules) -> list:
    """The loaded modules' top-level names (the part before the first dot,
    compared whole) that belong to JAX or to the JAX package."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def set_caches():
    """Every build or kernel cache a library may keep, at fixed paths in
    the checkout (the port's own nvcc build is ``vpic_tpu_torch/_build``)."""
    cache = ROOT / ".picbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def build(cfg: dict, seed: int, device):
    """The configuration's deck, made by the function its module names.
    The deck's ``env`` knobs and ``kwargs`` each name the top-level key of
    the configuration that gives their value (``seed``: the run's seed),
    so every size is stated once."""
    deck = cfg["deck"]
    value = lambda key: seed if key == "seed" else cfg[key]
    env = {k: str(value(key)) for k, key in deck.get("env", {}).items()}
    kwargs = {k: value(key) for k, key in deck.get("kwargs", {}).items()}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mod = importlib.import_module(deck["module"])
        sim = getattr(mod, deck["call"])(device=device, **kwargs)
        if deck.get("finalize"):
            sim.finalize()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return sim


class Cell:
    """One run of a cell on ``device``; the steps of its phases."""

    def __init__(self, name, seed, seconds, device, overrides=None):
        import torch
        from picbench import spec
        self.torch = torch
        w = spec.workload(name)
        self.name, self.seed, self.seconds = name, seed, seconds
        self.traffic = w["traffic"]
        self.cfg = spec.merged(w["config"], overrides or {})
        self.limits = w["cell"]["limits"]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.unit = self.cfg["unit_steps"]
        self.clean = max(self.cfg["cleans"].values())

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def advance(self, steps):
        """Whole units of the plan on the graphs (op by op on the CPU)."""
        assert steps % self.unit == 0 and self.sim.step_count % self.unit == 0
        self.sim.advance_steps(steps)

    def to_step(self, residue: int):
        """Advance to the next step that is ``residue`` past a multiple of
        the clean interval (in whole units)."""
        if self.clean:
            left = (residue - self.sim.step_count) % self.clean
            left += (-left) % self.unit
            if left:
                self.advance(left)

    def setup(self):
        from picbench import state
        torch = self.torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.sim = build(self.cfg, self.seed, self.device)
        t = time.perf_counter()
        self.start = state.snapshot(self.sim)
        paused = time.perf_counter() - t
        self.live = [sp["np"] for sp in self.start["species"]]
        warm = self.traffic["warm_units"] * self.unit
        self.advance(warm)
        self.sync()
        t = time.perf_counter()
        cal = self.traffic["calibrate_units"]
        self.advance(cal * self.unit)
        self.sync()
        self.unit_s = (time.perf_counter() - t) / cal
        self.lead = max(2, math.ceil(self.traffic["lead_seconds"]
                                     / self.unit_s))
        self.setup_s = time.perf_counter() - T0 - paused
        log(f"set-up {self.setup_s:.3f} s (snapshot {paused:.3f} s apart); "
            f"live {self.live}; unit {self.unit} steps {self.unit_s:.6f} s;"
            f" lead {self.lead} units")

    def paced(self, more):
        """Replay whole units, one ``advance_steps`` call each, while
        ``more(steps, seconds so far)``, the host kept at most ``self.lead`` units
        ahead of the card by an event per unit and never waiting for the
        card to drain until the end; (steps, seconds to the final
        synchronize)."""
        from torch.profiler import record_function
        pending = collections.deque()
        steps, t0 = 0, time.perf_counter()
        while more(steps, time.perf_counter() - t0):
            with record_function("picbench.replay"):
                self.advance(self.unit)
            steps += self.unit
            if self.cuda:
                pending.append(self.torch.cuda.Event())
                pending[-1].record()
                if len(pending) > self.lead:
                    pending.popleft().synchronize()
        with record_function("picbench.sync"):
            self.sync()
        return steps, time.perf_counter() - t0

    def window(self, seconds):
        """The timed window: units until ``seconds`` have passed."""
        return self.paced(lambda steps, t: t < seconds)

    def timed(self):
        from picbench import spec
        steps, dt = self.window(self.seconds)
        self.peak = (self.torch.cuda.max_memory_allocated() if self.cuda
                     else 0)
        self.attempted = steps
        rate = sum(self.live) * steps / dt
        log(f"window {steps} steps in {dt:.6f} s: {rate:.6e} pushes/s; "
            f"peak {self.peak} B")
        values = dict(pushes_per_s=rate, peak_mem_gib=self.peak / 2 ** 30,
                      setup_s=self.setup_s)
        return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                for m in spec.metrics_of(self.name, "end_to_end")}

    def traced(self):
        """A profiled graphed window (on a deck with interval cleans: the
        steps between two cleans, whose conditional bodies a trace cannot
        see) and a profiled op-by-op window of whole units, between cleans
        too; the per-layer metrics read their record."""
        from torch.profiler import record_function
        from picbench import spec, trace
        counts = self.sim.dispatch_counts
        if self.clean:
            n_units = (self.clean - 1) // self.unit
        else:
            n_units = max(1, round(self.traffic["trace_seconds"]
                                   / self.unit_s))
        eager0 = counts["eager_steps"]
        profiled_steps = []

        def graphed():
            first = self.sim.step_count
            self.paced(lambda steps, t: steps < n_units * self.unit)
            profiled_steps.append((first, self.sim.step_count))

        wall, events, dev, lost = trace.profiled(
            graphed, prepare=lambda: self.to_step(1))
        g = trace.graphed_record(events, dev, wall, n_units * self.unit)
        g["eager_steps"] = counts["eager_steps"] - eager0
        self.peak = self.torch.cuda.max_memory_allocated()
        self.attempted = n_units * self.unit
        del events, dev

        e_steps = self.unit * math.ceil(self.traffic["eager_steps"]
                                        / self.unit)

        def eager():
            with record_function("picbench.eager"):
                self.sim.advance_eager(e_steps)

        def before_eager():
            # one untraced op-by-op unit first: its allocations
            self.to_step(1)
            self.sim.advance_eager(self.unit)
            self.sync()

        _, events, dev, e_lost = trace.profiled(eager, prepare=before_eager)
        e = trace.eager_record(events, dev, e_steps)
        del events, dev
        rec = dict(graphed=g, eager=e, profiled_steps=profiled_steps,
                   deck=dict(live=self.live, cells=self.cells()))
        out = {}
        for m in spec.metrics_of(self.name, "per_layer"):
            v = importlib.import_module(
                f"picbench.metrics.{m['name']}").read(rec)
            if v is not None:
                out[m["name"]] = dict(value=v, unit=m["unit"])
        power = card_power()
        log(f"traced: {g['steps']} graphed steps, busy {g['busy_s']:.6f} of "
            f"{g['window_s']:.6f} s, {lost} launches without device events; "
            f"{e_steps} op-by-op steps, {e_lost}; card {power}")
        self.breakdown = dict(device_ops=trace.device_ops(g["kernels"]),
                              idle_gaps=[[n, s] for n, s in g["idle_gaps"]])
        self.busy = (g["busy_s"], g["window_s"])
        return out

    def cells(self):
        from picbench import judge
        return judge.config_module(self.cfg["name"]).box(self.cfg).cells

    def compared_units(self):
        """Snapshots around the compared units: whole units from a clean
        step where the deck has interval cleans."""
        from picbench import state
        self.to_step(0)
        snaps = [state.snapshot(self.sim)]
        for _ in range(self.traffic["compare_units"]):
            self.advance(self.unit)
            snaps.append(state.snapshot(self.sim))
        return snaps

    def release(self):
        del self.sim
        gc.collect()
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None):
    """One run: the result's dict, or None where a forbidden module was
    loaded (named on standard error)."""
    from picbench import judge
    set_caches()
    cell = Cell(name, seed, seconds, device, overrides)
    cell.setup()
    metrics = cell.traced() if trace else cell.timed()
    snaps = cell.compared_units()
    cell.release()
    t = time.perf_counter()
    numbers = judge.readings(cell.cfg, seed, cell.start, snaps, cell.device)
    correct = judge.verdict(numbers, cell.limits)
    log(f"reference and comparison {time.perf_counter() - t:.3f} s")
    bad = forbidden(list(sys.modules))
    if bad:
        log(f"loaded modules of JAX or of the JAX package: {bad}")
        return None
    torch = cell.torch
    dev = dict(platform="gpu" if cell.cuda else "cpu",
               kind=(torch.cuda.get_device_name(cell.device) if cell.cuda
                     else "cpu"),
               count=1, memory_peak_bytes=cell.peak)
    out = dict(correct=correct, attempted=cell.attempted,
               failed=0 if correct else cell.attempted, metrics=metrics,
               device=dev)
    if trace:
        dev.update(busy_s=cell.busy[0], window_s=cell.busy[1])
        out["breakdown"] = cell.breakdown
    out["checks"] = {k: dict(value=v, limit=cell.limits.get(k))
                     for k, v in numbers.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from picbench import spec
    chips = spec.workload(args.workload)["entry"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count()}")
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, args.trace)
    if out is None:
        return 4
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
