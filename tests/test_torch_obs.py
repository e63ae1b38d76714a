"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU.

- The same recorded values give the reference's ``Histogram.summary()``;
  the registry's snapshot and last-writer-wins semantics.
- The port's exported traces pass the reference's ``validate_trace_file``,
  and both validators reject the same malformed event lists; the bounded
  buffer, the no-op span, ``timed``, and the ``torch.profiler`` bridge
  (spans framed as ``record_function`` ranges, exceptions not swallowed).
- Obs on equals obs off bit for bit, dense and banked; the selection
  trace's counts equal ``state["opt"]["counts"]`` at every boundary;
  ``topk_grad`` masks are the JAX ``Trainer``'s step for step from the same
  exported state and batches, and ``report.render`` gives the same string.
- ``SwapStats.as_dict()`` holds the reference's keys, each ``*_us`` its
  histogram's total, and the registry holds the planner's instruments.
- ``stats_snapshot()`` has the reference's keys but ``fn_cache``, equal
  ``engine`` stats and histogram counts, and the trace the same ``e2e`` and
  ``ttft`` request lanes, on a preempting prefix-cache workload and a
  chunked-prefill one.
- The straggler watchdog, made to fire once, calls its hook once.
- The CPU launchers' ``--trace`` and ``--metrics-json`` files validate and
  ``launch.inspect`` renders them.

The global registries (the port's and the reference's) are reset between
tests.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro.obs.registry import Histogram as JHistogram
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert, obs
from repro_torch.launch import inspect as launch_inspect
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.obs import report
from repro_torch.obs.registry import Histogram
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import Trainer
from test_torch_checkpoint import _assert_same_state, _tcfg
from test_torch_serve_stack import (_engines, _mixed, _prefix_uneven,
                                    _run_both, model)  # noqa: F401
from test_torch_train import _tcfgs


@pytest.fixture(autouse=True)
def _obs_clean():
    for o in (obs, jobs):
        o.disable()
        o.metrics.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    for o in (obs, jobs):
        o.disable()
        o.metrics.reset()


# -------------------------------------------------------------- registry


@pytest.mark.parametrize("seed, n, scale", [
    (0, 1, 1.0), (1, 37, 1e-3), (2, 400, 1e3), (3, 250, 1e6),
    (4, 64, 2.0**-20)])
def test_histogram_summary_matches_the_reference(seed, n, scale):
    """Lognormal values (with zeros and negatives mixed in, and values past
    the bucketed range at the extremes) give the reference's summary."""
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(0.0, 2.0, n) * scale
    xs[::7] = 0.0
    xs[3::11] = -xs[3::11]
    h, jh = Histogram(), JHistogram()
    for x in xs:
        h.record(x)
        jh.record(x)
    assert h.summary() == jh.summary()
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert len(h._counts) == Histogram.num_buckets == JHistogram.num_buckets


def test_registry_snapshot_and_register_semantics():
    reg = obs.MetricsRegistry()
    reg.counter("a", subsystem="s1").inc(3)
    reg.gauge("g", subsystem="s1").set(2.5)
    reg.histogram("h", subsystem="s2").record(1.0)
    reg.register("cb", lambda: {"x": 1}, subsystem="s2")
    snap = reg.snapshot()
    assert snap == {"s1": {"a": 3, "g": 2.5},
                    "s2": {"h": snap["s2"]["h"], "cb": {"x": 1}}}
    assert snap["s2"]["h"]["count"] == 1
    json.dumps(snap)
    reg.register("cb", lambda: 1 / 0, subsystem="s2")
    assert "error" in reg.snapshot()["s2"]["cb"]
    assert reg.counter("a", subsystem="s1") is reg.counter("a",
                                                           subsystem="s1")
    reg.unregister("cb", subsystem="s2")
    assert "cb" not in reg.snapshot()["s2"]
    reg.reset()
    assert reg.snapshot() == {}


# ----------------------------------------------------------------- tracer


def test_port_traces_pass_the_reference_validator(tmp_path):
    tr = obs.enable()
    with obs.span("outer", {"k": 1}):
        with obs.span("inner"):
            pass
        obs.instant("tick", {"n": 2})
    tr.complete("retro", tr._t0_ns + 1000, tr._t0_ns + 5000, track="lane A")
    tr.complete("before", tr._t0_ns - 10, tr._t0_ns + 5)   # dropped
    path = tmp_path / "t.json"
    obs.export_trace(str(path))
    events = jtrace.validate_trace_file(str(path))
    assert events == obs.validate_trace_file(str(path))
    assert [e["name"] for e in events if e["ph"] == "B"] == ["outer", "inner"]
    (x,) = [e for e in events if e["ph"] == "X"]
    assert x["name"] == "retro" and x["dur"] == pytest.approx(4.0)
    assert {"lane A", "MainThread"} <= {e["args"]["name"] for e in events
                                        if e["ph"] == "M"}


_OK = [{"ph": "B", "name": "a", "pid": 0, "tid": 1, "ts": 1.0},
       {"ph": "E", "name": "a", "pid": 0, "tid": 1, "ts": 2.0}]


@pytest.mark.parametrize("events", [
    _OK[:1], [_OK[0], {**_OK[1], "name": "b"}], [{**_OK[0], "ts": 5.0},
                                                  _OK[1]],
    [{**_OK[0], "ph": "Q"}], [_OK[1]], [{"ph": "i", "name": "x", "pid": 0}],
    [{**_OK[0], "ph": "X", "dur": -1.0}], ["not an event"],
    [{**_OK[0], "ts": -1.0}, _OK[1]]],
    ids=["unterminated", "mismatched", "backwards", "phase", "empty-stack",
         "no-tid", "negative-dur", "not-a-dict", "negative-ts"])
def test_both_validators_reject_the_same_lists(events):
    obs.validate_trace(_OK)
    for validate in (obs.validate_trace, jtrace.validate_trace):
        with pytest.raises(AssertionError):
            validate(events)


def test_bounded_buffer_noop_span_and_timed():
    tr = obs.Tracer(max_events=10)
    for i in range(50):
        tr.instant(f"e{i}")
    assert len(tr.events()) == 10 and tr.dropped == 41
    assert not obs.enabled() and obs.span("x") is obs.NOOP_SPAN
    obs.instant("ignored")
    with pytest.raises(RuntimeError):
        obs.export_trace("never.json")
    h = Histogram()
    with obs.timed(h, "work"):
        pass
    assert h.count == 1
    tr = obs.enable()
    with obs.timed(h, "work"):
        pass
    assert h.count == 2
    assert [e["name"] for e in tr.events() if e["ph"] == "B"] == ["work"]


def test_torch_profiler_bridge_frames_spans():
    """``enable(torch_profiler=True)``: each span is a ``record_function``
    range in a ``torch.profiler`` capture; an exception in the body passes
    through the bridge."""
    obs.enable(torch_profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with obs.span("train_step"):
                torch.ones(4).add_(1)
        with pytest.raises(ValueError, match="inside"):
            with obs.span("failing"):
                raise ValueError("inside")
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["train_step"] == 2 and counts["failing"] == 1
    obs.validate_trace(obs.tracer().events())


# ------------------------------------------------------------- training


def _obs_tcfg(residency, steps=5, **kw):
    opt = (dict(moment_residency="banked", offload="host", async_swap=True)
           if residency == "banked" else {})
    return _tcfg(steps=steps, **opt, **kw)


@pytest.mark.parametrize("residency", ["device", "banked"])
def test_obs_on_equals_off_bit_for_bit(residency, tmp_path):
    """Obs on (trace + selection telemetry) against off: the same losses
    and state bits; the exported trace validates under the reference's
    checker with a ``train_step`` a step (and the banked phases)."""
    off = Trainer(_obs_tcfg(residency), device="cpu")
    off.train()
    obs.enable()
    on = Trainer(_obs_tcfg(residency), device="cpu")
    on.train()
    assert on.log.losses == off.log.losses
    _assert_same_state(on.state, off.state)
    path = tmp_path / "train.json"
    obs.export_trace(str(path))
    events = jtrace.validate_trace_file(str(path))
    names = [e["name"] for e in events if e["ph"] == "B"]
    assert names.count("train_step") == 5
    if residency == "banked":
        assert names.count("phase_a") == names.count("phase_b") == 5
        lanes = {e["tid"]: e["args"]["name"] for e in events
                 if e["ph"] == "M"}
        jobs_ = [e for e in events if e["name"] == "swap_dispatch_job"]
        assert len(jobs_) == 5
        assert {lanes[e["tid"]] for e in jobs_} == {"swap-planner "
                                                    "(copy stream)"}


@pytest.mark.parametrize("residency", ["device", "banked"])
def test_selection_counts_equal_opt_counts_every_step(residency):
    obs.enable()
    tr = Trainer(_obs_tcfg(residency, steps=6), device="cpu")
    sel = obs.selection_trace()
    for i in range(6):
        tr.train(1)
        np.testing.assert_array_equal(
            sel.counts, tr.state["opt"]["counts"].numpy().astype(np.float64))
    assert sel.masks().shape == (6, sel.num_blocks)
    assert sel.norms().shape == (6, sel.num_blocks)
    assert np.isfinite(sel.norms()).all()


def test_selection_series_and_report_match_the_jax_trainer():
    """topk_grad from the JAX trainer's exported state on the same
    synthetic batches: the recorded masks equal step for step, the block
    norms to 1e-4 relative, and the rendered heatmaps are one string."""
    jt, tt = _tcfgs("topk_grad")
    jobs.enable()
    jtr = JTrainer(jt)
    ttr = Trainer(tt, device="cpu")
    ttr.state = convert.train_state_from_numpy(jax.device_get(jtr.state),
                                               tt.model, "cpu")
    obs.enable()
    jtr.train()
    ttr.train()
    jsel, tsel = jobs.selection_trace(), obs.selection_trace()
    np.testing.assert_array_equal(tsel.masks(), jsel.masks())
    np.testing.assert_array_equal(tsel.counts, jsel.counts)
    np.testing.assert_allclose(tsel.norms(), jsel.norms(), rtol=1e-4,
                               atol=1e-7)
    assert tsel.snapshot()["steps"] == jsel.snapshot()["steps"]
    for bins in (2, 5):
        assert report.render_selection_trace(tsel, bins=bins) == \
            jreport.render_selection_trace(jsel, bins=bins)
    assert report.render(tsel.masks(), bins=3) == \
        jreport.render(jsel.masks(), bins=3)


def test_swap_stats_are_views_over_the_histograms():
    tr = Trainer(_obs_tcfg("banked", steps=6), device="cpu")
    tr.train()
    stats = tr.step_fn.swap_stats
    d = stats.as_dict()
    ref_keys = {"steps", "boundaries", "predicted_hits", "sync_swaps",
                "dispatches", "phase_a_us", "swap_us", "phase_b_us",
                "predicted_hit_rate"}
    assert set(d) == ref_keys | {"mispredicts", "dispatched_hit_rate"}
    assert d["steps"] == 6
    for name in ("phase_a", "swap", "phase_b"):
        hist = getattr(stats, name)
        assert hist.count == 6
        assert d[f"{name}_us"] == hist.total > 0
    snap = obs.metrics.snapshot()["swap"]
    assert snap["banked"] == d
    assert snap["phase_a_us"]["count"] == 6
    assert snap["mispredicts"] == stats.mispredicts == d["mispredicts"]


def test_straggler_watchdog_fires_once(monkeypatch):
    """Step 4 takes 10 s of a fake clock, the others 1 s: the EWMA (from
    the fourth step) flags it alone, the hook runs once, one straggler is
    counted and the trace has its instant."""
    clock = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock.t))
    calls = []
    obs.enable()
    tr = Trainer(_obs_tcfg("device", steps=6), device="cpu",
                 on_straggler=lambda *a: calls.append(a))
    inner = tr.step_fn

    def step_fn(state, batch):
        clock.t += 10.0 if state["step"] == 4 else 1.0
        return inner(state, batch)
    tr.step_fn = step_fn
    tr.train()
    assert [c[:2] for c in calls] == [(4, 10.0)]
    assert calls[0][2] == pytest.approx(0.9 * 1.0 + 0.1 * 10.0)
    snap = obs.metrics.snapshot()["train"]
    assert snap["stragglers"] == 1 and snap["steps"] == 6
    assert snap["step_time_us"]["count"] == 6   # a sync every step
    assert [e["args"]["step"] for e in obs.tracer().events()
            if e["name"] == "straggler"] == [4]


# -------------------------------------------------------------- serving


@pytest.mark.parametrize("case", ["preempt-prefix", "chunked"])
def test_serving_snapshot_and_lanes_match_the_jax_engine(model, case,
                                                         tmp_path):
    """One workload on both engines with tracing on: the snapshot's keys
    (the reference's but ``fn_cache``), ``engine`` stats and histogram
    counts are equal, the pool's live pages reach the gauge, and every
    completed request has its ``e2e`` and ``ttft`` lane in both traces."""
    if case == "chunked":
        work = _mixed()
        kw = dict(max_len=64, num_slots=4, decode_chunk=4, min_bucket=8,
                  prefill_chunk=8)
    else:
        work = _prefix_uneven()
        kw = dict(max_len=32, num_slots=3, decode_chunk=4, min_bucket=8,
                  kv_layout="paged", page_size=4, prefix_cache=True,
                  num_pages=8, preempt=True)
    streamed = []
    jobs.enable(selection=False)
    obs.enable(selection=False)
    jeng, teng = _engines(model, on_complete=streamed.append, **kw)
    _run_both(jeng, teng, work)
    tsnap, jsnap = teng.stats_snapshot(), jeng.stats_snapshot()
    assert set(tsnap) == set(jsnap) - {"fn_cache"}
    assert tsnap["engine"] == jsnap["engine"] == teng.stats
    for key in ("pages", "scheduler", "prefix_cache"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["stream_out"] == {"pending": 0}
    for name, h in tsnap["latency_us"].items():
        assert h["count"] == jsnap["latency_us"][name]["count"] == len(work)
    if case == "preempt-prefix":
        assert teng.stats["preempted"] >= 1
    reg = obs.metrics.snapshot()["serve"]
    assert reg["engine"] == teng.stats
    assert reg["e2e_us"]["count"] == len(work)
    assert reg["streamed_completions"] == len(work)
    live = tsnap["pages"]["live_pages"] if tsnap["pages"] else 0
    assert reg.get("page_pool_live", 0.0) == live

    def lanes(tracer):
        out = {}
        names = {e["tid"]: e["args"]["name"] for e in tracer.events()
                 if e["ph"] == "M"}
        for e in tracer.events():
            if e["ph"] == "X":
                out.setdefault(names[e["tid"]], []).append(e["name"])
        return {k: sorted(v) for k, v in out.items()}
    assert lanes(obs.tracer()) == lanes(jobs.tracer()) == {
        f"request {w['uid']}": ["e2e", "ttft"] for w in work}
    for e in obs.tracer().events():
        if e["ph"] == "X" and e["name"] == "ttft":
            (e2e,) = [x for x in obs.tracer().events() if x["ph"] == "X"
                      and x["tid"] == e["tid"] and x["name"] == "e2e"]
            assert e["dur"] <= e2e["dur"]
    path = tmp_path / "serve.json"
    obs.export_trace(str(path))
    names = {e["name"] for e in jtrace.validate_trace_file(str(path))}
    want = {"admission", "decode_chunk", "streamout_callback"}
    if case == "chunked":
        want.add("prefill_chunk")
    assert want <= names


# ------------------------------------------------------------- launchers


@pytest.mark.parametrize("extra", [
    ["--pack", "--prefetch-depth", "2"],
    ["--moment-residency", "banked", "--offload", "host", "--async-swap",
     "on"]], ids=["packed-prefetch", "banked"])
def test_train_launcher_writes_trace_and_metrics(extra, tmp_path, capsys):
    trace, snap = tmp_path / "t.json", tmp_path / "m.json"
    assert launch_train.main([
        "--arch", "qwen2.5-0.5b", "--smoke", "--device", "cpu", "--steps",
        "5", "--seq-len", "96", "--global-batch", "2", "--trace", str(trace),
        "--metrics-json", str(snap), "--report"] + extra) == 0
    out = capsys.readouterr().out
    assert "selection heatmap — 5 steps" in out
    assert not obs.enabled()
    events = jtrace.validate_trace_file(str(trace))
    names = [e["name"] for e in events if e["ph"] == "B"]
    assert names.count("train_step") == 5
    threads = {e["args"]["name"] for e in events if e["ph"] == "M"}
    doc = json.loads(snap.read_text())
    assert doc["train"]["steps"] == 5
    assert len(doc["selection"]["steps"]) == 5
    if "--pack" in extra:
        assert "data-prefetch" in threads
        assert doc["data"]["prefetch_batches"] == 5
    else:
        assert doc["swap"]["banked"]["steps"] == 5
    assert launch_inspect.main([str(snap), "--bins", "2"]) == 0
    shown = capsys.readouterr().out
    assert "selection heatmap — 5 steps" in shown and "[train]" in shown


def test_serve_launcher_snapshot_renders(tmp_path, capsys):
    snap = tmp_path / "m.json"
    assert launch_serve.main([
        "--arch", "qwen2.5-0.5b", "--smoke", "--device", "cpu",
        "--new-tokens", "4", "--metrics-json", str(snap)]) == 0
    assert json.loads(snap.read_text())["serve"]["ttft_us"]["count"] == 4
    capsys.readouterr()
    assert launch_inspect.main([str(snap), "--no-heatmap"]) == 0
    shown = capsys.readouterr().out
    assert "[serve]" in shown and "ttft_us" in shown
