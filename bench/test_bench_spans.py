"""Device time attributed to the program's spans by launch
(``bench/spans.py``) on synthetic kineto-shaped traces, the readers of the
span metrics against values worked by hand, and the existing readers
unmoved by the new keys."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from bench import harness, spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@dataclasses.dataclass
class Ev:
    """One kineto event, as ``kineto_results.events()`` gives it."""
    n: str
    dev: object
    t0: int
    t1: int
    corr: int = 0
    linked: int = 0
    ua: bool = False

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return self.ua


def _range(name, t0, t1, corr):
    """A ``record_function`` range: on the host, and its mirror on the
    device's timeline (which is no device operation)."""
    return [Ev(name, CPU, t0, t1, corr, ua=True),
            Ev(name, CUDA, t0 + 5, t1 + 5, corr, ua=True)]


#: nested spans; times in ns from the profiler's start (bench.generate
#: opens at 1,000)
EVENTS = [
    *_range("bench.generate", 1_000, 100_000, 1),
    *_range("serve.generate", 1_100, 99_000, 2),
    *_range("serve.prefill", 1_200, 50_000, 3),
    *_range("bench.prefill", 1_300, 49_000, 4),
    *_range("mamba.seq", 1_400, 40_000, 5),
    *_range("ssd.chunked", 2_000, 30_000, 6),
    *_range("ssd.intra", 3_000, 4_000, 7),
    # B5 through ctypes: a runtime call inside ssd.intra, no linked op; the
    # kernel runs after every span above has closed
    Ev("cudaLaunchKernel", CPU, 3_500, 3_600, 1001),
    Ev("ssd_wgmma_kernel", CUDA, 60_000, 61_000, 1001),
    # an aten op in ssd.chunked outside ssd.intra, its runtime call
    Ev("aten::exp", CPU, 5_000, 5_400, 8),
    Ev("cudaLaunchKernel", CPU, 5_100, 5_300, 1002, linked=8),
    Ev("elementwise_kernel", CUDA, 61_000, 61_500, 1002, linked=8),
    # an op in mamba.seq outside ssd.chunked with no runtime event: its
    # linked op places it
    Ev("aten::mm", CPU, 35_000, 35_500, 9),
    Ev("gemm", CUDA, 61_500, 62_500, 1003, linked=9),
    # a copy launched inside bench.generate, outside every program span
    Ev("cudaMemcpyAsync", CPU, 99_500, 99_600, 1004),
    Ev("Memcpy DtoH", CUDA, 99_700, 99_800, 1004),
    # a device operation whose launch the trace lacks
    Ev("orphan_kernel", CUDA, 99_810, 99_820, 1005, linked=77),
    # before bench.generate: not the call's
    Ev("cudaLaunchKernel", CPU, 100, 200, 1006),
    Ev("early_kernel", CUDA, 300, 400, 1006),
]


def test_convert_attributes_by_launch_not_by_run_time():
    tr = spans.convert(EVENTS)
    names = [n for n, _, _ in tr["kernels"]]
    assert names == ["ssd_wgmma_kernel", "elementwise_kernel", "gemm",
                     "Memcpy DtoH", "orphan_kernel"]
    assert tr["launched_in"] == ["ssd.intra", "ssd.chunked", "mamba.seq",
                                 "bench.generate", None]
    assert tr["launched_at"][:4] == pytest.approx(
        [2.5e-6, 4.1e-6, 34e-6, 98.5e-6])
    assert tr["launched_at"][4] is None
    assert tr["window_s"] == pytest.approx(99e-6)
    assert [s[0] for s in tr["spans"]] == ["bench.generate", "bench.prefill"]
    assert [s[0] for s in tr["program_spans"]] == [
        "serve.generate", "serve.prefill", "mamba.seq", "ssd.chunked",
        "ssd.intra"]
    assert tr["program_spans"][4][1:] == pytest.approx((2e-6, 3e-6))
    by = spans.device_ms_by_span(tr)
    assert by == pytest.approx({"ssd.intra": 1e-3, "mamba.seq": 1e-3,
                                "ssd.chunked": 5e-4, "bench.generate": 1e-4,
                                "none": 1e-5})


def test_innermost_takes_the_latest_open_span():
    s = [("a", 0.0, 10.0), ("b", 1.0, 5.0), ("c", 2.0, 3.0), ("d", 6.0, 7.0),
         ("e", 11.0, 12.0)]
    got = spans.innermost(s, [0.5, 2.5, 4.0, 3.0, 6.5, 8.0, 10.5, 11.0, 1.0])
    assert got == [0, 2, 1, 2, 3, 0, None, 4, 1]


class _Rec:
    spans = False


class _Stub:
    """What ``Bench.traced_call`` touches of a bench."""

    def __init__(self):
        self.rec = _Rec()
        self.calls = []

    def call(self, seed, k, record=True):
        self.calls.append((seed, k, record))
        return "call"


class _Prof:
    def __init__(self, *a, **k):
        self.profiler = self
        self.kineto_results = self

    def events(self):
        return EVENTS

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_profiled_call_keeps_the_harness_trace(monkeypatch):
    """On the same events, ``profiled_call``'s ``kernels``, ``spans`` and
    ``window_s`` are ``harness.Bench.traced_call``'s, and the program's
    telemetry is installed during the call only."""
    from repro_torch.core.telemetry import get_telemetry
    monkeypatch.setattr(torch.profiler, "profile", _Prof)
    want = harness.Bench.traced_call(_Stub(), 3, 9)
    seen = []
    stub = _Stub()
    stub.call = lambda seed, k, record=True: seen.append(get_telemetry())
    _, got = spans.profiled_call(stub, 3, 9)
    assert {k: got[k] for k in want} == want
    assert seen[0] is not None and get_telemetry() is None
    assert not stub.rec.spans


def test_host_spans_pairs_the_tracers_events():
    from repro_torch.core.telemetry import Telemetry
    clock = iter(range(100))
    tel = Telemetry(clock=lambda: next(clock) * 1e-3)
    with tel.span("serve.generate", call=1):
        for i in range(2):
            with tel.span("serve.decode_step", step=i):
                with tel.span("serve.readback"):
                    pass
    got = spans.host_spans(tel.tracer.events())
    assert [n for n, _, _ in got] == [
        "serve.generate", "serve.decode_step", "serve.readback",
        "serve.decode_step", "serve.readback"]
    assert got[0][1] == 0.0 and got[0][2] == pytest.approx(0.009)
    assert spans.host_self_s(got, "serve.decode_step", ("serve.readback",)) \
        == pytest.approx([0.002, 0.002])


class _Served:
    """What ``spanned_call`` touches of a bench: a 2-block narrow mamba2
    server on the CPU."""

    def __init__(self):
        from repro_torch.configs import get
        from repro_torch.launch.serve import Server
        cfg = dataclasses.replace(get("mamba2-2.7b").reduced(), n_layers=2)
        self.srv = Server(cfg, batch=2, prompt_len=9, max_new=3, eos_id=-1,
                          device="cpu")
        self.srv.init_params(5)
        self.device = torch.device("cpu")
        self.tokens = np.random.default_rng(1).integers(
            2, cfg.vocab, (2, 9)).astype(np.int32)

    def call(self, seed, k, record=True):
        return self.srv.generate({"tokens": self.tokens})


def test_drained_call_waits_before_each_block_step():
    """``drain``: a ``bench.drain`` span before each block's decode step
    (two blocks, two steps), none in the prefill; the tokens are the
    undrained call's, and the blocks' own ``step`` is back afterwards."""
    bench = _Served()
    plain, host = spans.spanned_call(bench, 0, 0)
    drained, dhost = spans.spanned_call(bench, 0, 0, drain=True)
    assert spans.count(host, spans.DRAIN) == 0
    assert spans.count(dhost, spans.DRAIN) == 4
    cover = spans._Cover(dhost, ["serve.decode_step"])
    assert all(a in cover for n, a, _ in dhost if n == spans.DRAIN)
    assert (plain["tokens"] == drained["tokens"]).all()
    assert all("step" not in vars(m) for m in bench.srv.model.modules())
    own = spans.host_self_s(dhost, "serve.decode_step",
                            ("serve.readback", spans.DRAIN))
    assert len(own) == 2 and all(x > 0 for x in own)


# ---------------------------------------------------------------------------
# the readers, on hand-built traces
# ---------------------------------------------------------------------------

#: a call of two decode steps after a prefill with one block; times in ms
PROGRAM = [
    ("serve.generate", 0, 100), ("serve.prefill", 1, 40),
    ("mamba.seq", 2, 30), ("ssd.chunked", 5, 25), ("ssd.intra", 6, 8),
    ("serve.readback", 40, 45),
    ("serve.decode_step", 50, 70), ("mamba.state", 52, 54),
    ("mamba.store", 54, 55), ("serve.readback", 60, 70),
    ("serve.decode_step", 75, 95), ("mamba.state", 77, 79),
    ("mamba.store", 79, 80), ("serve.readback", 85, 95),
]
#: (name, device start, device end, launch), ms
OPS = [
    ("proj", 3, 7, 2.5),          # mamba.seq, outside ssd.chunked: block
    ("cumsum", 7, 9, 5.5),        # ssd.chunked: ssd glue
    ("b5", 9, 12, 7.0),           # ssd.intra
    ("exp", 12, 15, 9.0),         # ssd.chunked: ssd glue
    ("gemm", 15, 18, 26.0),       # mamba.seq: block
    ("head", 18, 20, 35.0),       # serve.prefill only
    ("copy", 40, 41, 41.0),       # the prefill's read-back
    ("in_proj", 56, 58, 51.0),    # step 1
    ("state_mul", 58, 61, 52.5),  # mamba.state
    ("state_add", 60, 62, 53.5),  # mamba.state, overlapping the one before
    ("store", 62, 64, 54.5),      # mamba.store
    ("copy", 64, 65, 60.0),       # read-back
    ("in_proj", 81, 83, 76.0),    # step 2
    ("state_mul", 83, 86, 77.5),
    ("store", 86, 87, 79.5),
    ("copy", 87, 88, 85.0),
    ("late", 99, 99.5, None),     # no launch found
]


def _trace(extra=True):
    ms = 1e-3
    tr = {"kernels": [(n, a * ms, b * ms) for n, a, b, _ in OPS],
          "spans": [("bench.generate", 0.0, 0.1),
                    ("bench.prefill", 1.5 * ms, 39 * ms),
                    ("bench.decode_step", 50.5 * ms, 59 * ms),
                    ("bench.decode_step", 75.5 * ms, 84 * ms)],
          "window_s": 0.1}
    if extra:
        tr["program_spans"] = [(n, a * ms, b * ms) for n, a, b in PROGRAM]
        tr["launched_at"] = [None if t is None else t * ms
                             for *_, t in OPS]
        tr["launched_in"] = ["x"] * len(OPS)
    return tr


def _ctx(tr, host=None):
    c = harness.cell("mamba2-2.7b.prefill-2k")
    t = c.traffic
    ref = harness.reference(c.conf)
    call = harness.Call(prompt=None, served=None, t0=0.0, t_first=0.7,
                        t1=3.0, decode_s=2.0, steps=31, rows=8, failed=0,
                        logits=None)
    return {"conf": c.conf, "traffic": t, "calls": [call, call],
            "window_s": 6.0, "setup_s": 12.0, "trace": tr,
            "reference": ref, "program_spans": host,
            "flops": ref.flops(c.conf, t.batch, t.prompt_len,
                               t.new_tokens)}


#: by hand: step 1 busy 56-65 = 9 ms, step 2 81-88 = 7 ms; state and store
#: 58-64 = 6 and 83-87 = 4 ms; 5 and 4 operations; prefill glue 2 + 3 ms;
#: block 4 + 3 ms
HAND = {"decode_busy_ms_per_step": 8.0, "decode_ops_per_step": 4.5,
        "decode_state_ms_per_step": 5.0, "prefill_ssd_ms": 5.0,
        "prefill_block_ms": 7.0}


@pytest.mark.parametrize("name", sorted(HAND))
def test_span_reader_by_hand(name):
    tr = _trace()
    assert harness.reader(name)(_ctx(tr)) == pytest.approx(HAND[name])
    assert harness.reader(name)(_ctx(_trace(extra=False))) is None
    assert harness.reader(name)(_ctx(None)) is None


def test_host_ms_per_step_by_hand():
    """Steps of 20 ms, each waiting 10 ms in its read-back: 10 ms; drained
    for 1 and 1.5 ms before their blocks: 8.75 ms."""
    ms = 1e-3
    host = [(n, a * ms, b * ms) for n, a, b in PROGRAM]
    read = harness.reader("decode_host_ms_per_step")
    assert read(_ctx(None, host)) == pytest.approx(10.0)
    drains = [(spans.DRAIN, 51 * ms, 52 * ms), (spans.DRAIN, 76 * ms,
                                                 77.5 * ms)]
    assert read(_ctx(None, host + drains)) == pytest.approx(8.75)
    assert read(_ctx(None, None)) is None


def test_span_metrics_are_readers():
    for name in spans.SPAN_METRICS:
        assert callable(harness.reader(name))


@pytest.mark.parametrize("name", sorted(
    {m["name"] for m in harness.cell("mamba2-2.7b.prefill-2k").per_layer}
    | {m["name"] for m in harness.cell("mamba2-2.7b.decode-b256").per_layer}))
def test_existing_readers_ignore_the_new_keys(name):
    """Every per-layer reader of the manifest reads the same value with and
    without ``program_spans``, ``launched_at`` and ``launched_in``."""
    read = harness.reader(name)
    a = read(_ctx(_trace(extra=False)))
    b = read(_ctx(_trace(extra=True), host=[("serve.decode_step", 0, 1)]))
    assert a == b and (a is None or math.isfinite(a))


def test_idle_gaps_by_program_span():
    """Gaps are named by the innermost program span open at their middle,
    else the innermost bench span, else bench.generate."""
    # by hand, ms: 0-3 (middle in serve.prefill), 20-40 (mamba.seq, to
    # its end at 30), 41-56, 65-81, 99.5-100 (between spans), 88-99
    # (serve.readback)
    idle = spans.idle_by_span(_trace())
    assert {n: [round(g * 1e3, 6) for g in v] for n, v in idle.items()} \
        == {"mamba.seq": [20.0], "serve.generate": [15.0, 16.0, 0.5],
            "serve.readback": [11.0], "serve.prefill": [3.0]}
    bare = dict(_trace(), program_spans=[])
    assert {n: len(v) for n, v in spans.idle_by_span(bare).items()} \
        == {"bench.prefill": 2, "bench.generate": 4}
