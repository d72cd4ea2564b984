"""The per-layer readers and the push's byte count on a synthetic traced
record with known answers."""

import importlib

import pytest

from picbench import trace
from picbench.counts import push

# two species of 1000 live particles on 10 cells, 4 graphed steps; each
# step one 2 us push kernel per species and a 1 us sort op, in a 40 us
# window; op by op 2 steps with 6 us of sort, 8 of push, 4 of field
KERNELS = []
for step in range(4):
    t = 10.0 * step
    KERNELS += [("(anonymous namespace)::push_walk_kernel(PushArgs)", t,
                 t + 2.0),
                ("(anonymous namespace)::push_walk_kernel(PushArgs)", t + 2,
                 t + 4.0),
                ("void cub::DeviceRadixSortOnesweepKernel<int>(int)", t + 4,
                 t + 5.0)]
RECORD = dict(
    graphed=dict(kernels=KERNELS, busy_s=20e-6, window_s=40e-6, steps=4,
                 eager_steps=0, idle_gaps=[]),
    eager=dict(steps=2, parts_s={"step.sort": 6e-6, "step.push": 8e-6,
                                 "step.field": 4e-6}),
    deck=dict(live=[1000, 1000], cells=10))


def read(name, rec=RECORD):
    return importlib.import_module(f"picbench.metrics.{name}").read(rec)


def test_push_bytes_count_each_word_once():
    assert push.push_bytes(1000, 10) == 4 * 15 * 1000 + 4 * 30 * 10
    assert push.push_flops(1000) == 246_000
    # bytes bound: 2 * 61 200 B at 3.35 TB/s against 2 * 246 000 flops
    want = 2 * 61_200 / push.PEAK_BYTES_PER_S
    assert push.least_seconds([1000, 1000], 10) == pytest.approx(want)


def test_roofline_reads_the_push_kernels_only():
    # 4 steps' least time over 16 us of push kernels
    want = 100 * 4 * push.least_seconds([1000, 1000], 10) / 16e-6
    assert read("push_kernel_roofline") == pytest.approx(want)


def test_roofline_without_its_kernel_reads_nothing():
    rec = dict(RECORD, graphed=dict(RECORD["graphed"], kernels=KERNELS[2::3]))
    assert read("push_kernel_roofline", rec) is None


@pytest.mark.parametrize("name,want", [
    ("eager_steps", 0), ("device_idle_share", 0.5), ("sort_busy_ms", 3e-3),
    ("push_busy_ms", 4e-3), ("field_busy_ms", 2e-3)])
def test_readers(name, want):
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_share", "sort_busy_ms",
                                  "push_busy_ms", "push_kernel_roofline",
                                  "field_busy_ms", "eager_steps"])
def test_a_reader_without_its_window_reads_nothing(name):
    assert read(name, dict(deck=RECORD["deck"])) is None


def test_busy_is_the_union_of_intervals():
    assert trace.busy_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_device_ops_by_family():
    ops = trace.device_ops(KERNELS)
    assert ops[0] == ["push_walk_kernel", pytest.approx(16e-6)]
    assert ops[1] == ["cub::DeviceRadixSortOnesweepKernel",
                      pytest.approx(4e-6)]
