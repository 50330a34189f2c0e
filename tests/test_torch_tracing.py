"""The port's span tree (``otter_tpu_torch/utils/metrics.py``): self times
under a patched clock, the profiler gate, the spans a CPU ``assemble``
opens, and the benchmark's readers of them."""

import io
import threading

import pytest
import torch

from benchmark.harness import LayerContext, metric_reader
from otter_tpu_torch.config import OtterOpts
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.utils import metrics
from otter_tpu_torch.utils.synth import region_fixture

# the spans this tree adds, each opened on every pass of the assemble path
NEW_SPANS = ("assemble", "open", "extract", "realign", "pair_prep", "ladder",
             "device_wait", "affine_tb", "affine_ladder", "emit")
# the phases the benchmark's first eight readers read (the KDE's four with
# the device KDE on)
READ_PHASES = ("host_io", "device_dispatch", "kde_device", "kde_certify",
               "cluster_labels", "cluster_finish", "consensus_batch")
READERS = {
    "extract_ms_per_region": "time.extract",
    "realign_ms_per_region": "time.realign",
    "ladder_ms_per_region": "time.ladder",
    "device_wait_ms_per_region": "time.device_wait",
    "device_syncs_per_region": "count.device_syncs",
    "affine_ladder_ms_per_region": "time.affine_ladder",
    "untraced_ms_per_region": "self.assemble",
}


class _Clock:
    """``metrics.time`` with a hand-set ``perf_counter``."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(metrics, "time", c)
    metrics.reset()
    yield c
    metrics.reset()


def test_self_times_add_up_to_the_root(clock):
    """A span's self time is its duration less its children's; the self
    times of a tree add up to the root's duration."""
    with metrics.phase("root"):
        clock.now = 1.0
        with metrics.phase("a"):
            clock.now = 4.0
        clock.now = 5.0
        with metrics.phase("b"):
            clock.now = 5.5
            with metrics.phase("c"):
                clock.now = 5.75
            with metrics.phase("a"):
                clock.now = 6.0
        clock.now = 10.0
    snap = metrics.snapshot()
    assert snap["time.root"] == 10.0 and snap["self.root"] == 6.0
    assert snap["time.a"] == 3.25 and snap["self.a"] == 3.25
    assert snap["time.b"] == 1.0 and snap["self.b"] == 0.5
    assert snap["time.c"] == 0.25 and snap["self.c"] == 0.25
    assert sum(v for k, v in snap.items() if k.startswith("self.")) == 10.0
    assert getattr(metrics._local, "top", None) is None


def test_reset_keeps_an_open_span(clock):
    """``reset()`` clears the totals; a span open across it closes into the
    new totals with its whole duration, its parent link intact."""
    with metrics.phase("outer"):
        with metrics.phase("inner"):
            clock.now = 2.0
            metrics.add("n", 3)
            metrics.reset()
            assert metrics.snapshot() == {}
            clock.now = 3.0
        clock.now = 7.0
    snap = metrics.snapshot()
    assert snap == {"time.inner": 3.0, "self.inner": 3.0,
                    "time.outer": 7.0, "self.outer": 4.0}
    assert getattr(metrics._local, "top", None) is None


def test_a_second_thread_has_its_own_stack(clock):
    """A span opened on another thread is a root there: it is no child of
    the span this thread has open."""
    done = []

    def work():
        clock.now = 1.0
        with metrics.phase("worker"):
            assert metrics._local.top.name == "worker"
            clock.now = 3.0
        done.append(getattr(metrics._local, "top", None))

    with metrics.phase("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert metrics._local.top.name == "main"
        clock.now = 10.0
    snap = metrics.snapshot()
    assert done == [None]
    assert snap["time.worker"] == snap["self.worker"] == 2.0
    assert snap["time.main"] == snap["self.main"] == 10.0


def test_to_host_is_a_counted_wait(clock):
    """``to_host`` returns ``.cpu().numpy()`` inside span ``device_wait``
    and counts one sync."""
    t = torch.arange(7, dtype=torch.int32)
    got = metrics.to_host(t)
    assert got.dtype == t.numpy().dtype and got.tolist() == list(range(7))
    snap = metrics.snapshot()
    assert snap["count.device_syncs"] == 1.0 and "time.device_wait" in snap


def _assemble(tmp_path, n_regions=4) -> str:
    tmp_path.mkdir(exist_ok=True)
    bam, bed, fa = region_fixture(str(tmp_path), n_regions=n_regions)
    params = OtterOpts()
    params.read_group = "S1"
    params.device = "cpu"
    out = io.StringIO()
    assemble(bam, bed, fa, False, params, out=out)
    return out.getvalue()


def test_profiler_gate(tmp_path, monkeypatch):
    """Under ``torch.profiler`` each span is an ``otter.<name>`` range of
    the trace; with no profiler active no range is entered. The SAM is the
    same either way."""
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    plain = _assemble(tmp_path / "a")
    assert entered == []
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        traced = _assemble(tmp_path / "b")
    assert traced == plain
    names = {ev.name for ev in prof.events()}
    for span in ("extract", "realign", "device_wait", "assemble"):
        assert f"otter.{span}" in names, span
        assert f"otter.{span}" in entered, span


def test_assemble_span_coverage(tmp_path, monkeypatch):
    """A CPU ``assemble`` (device KDE on) opens every new span, the root's
    self time and the sync counter, keeps every phase the first readers
    read, and its self times add up to ``time.assemble``."""
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    metrics.reset()
    _assemble(tmp_path, n_regions=6)
    snap = metrics.snapshot()
    metrics.reset()
    for span in NEW_SPANS + READ_PHASES:
        assert f"time.{span}" in snap, span
    assert "self.assemble" in snap and snap["count.device_syncs"] > 0
    assert "time.region_total" not in snap
    selfs = sum(v for k, v in snap.items() if k.startswith("self."))
    assert selfs == pytest.approx(snap["time.assemble"], rel=0.01)
    assert snap["time.extract"] + snap["time.realign"] <= snap["time.host_io"]
    assert snap["time.affine_ladder"] <= snap["time.consensus_batch"]


def _ctx(snapshot, regions):
    return LayerContext(snapshot, regions, 10.0, None, None, 0, 0, 0.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader(name):
    """Each new reader: its key a region (ms for a span), None for no
    regions, and None on a program without the span or counter."""
    read = metric_reader(name)
    key = READERS[name]
    snap = {key: 0.5, "time.host_io": 2.0, "self.host_io": 1.0}
    want = 0.5 / 4 if key.startswith("count.") else 1e3 * 0.5 / 4
    assert read(_ctx(snap, 4)) == pytest.approx(want)
    assert read(_ctx(snap, 0)) is None
    assert read(_ctx({"time.host_io": 2.0}, 4)) is None
    assert read(_ctx(dict(snap, **{key: 0.0}), 4)) == 0.0
