"""``harness/spans.py`` on a chrome trace built by hand: nested spans, a
second thread (autograd's) with no span, a kernel launched through a
``cu*`` entry point with no ATen operation, overlapping kernels, idle
gaps, a kernel whose launch the trace lacks and one outside every span;
and the stage and counter metrics, which give no number where the program
has no span or counter."""

import json
from types import SimpleNamespace as NS

import pytest

from port_bench.harness import cells, spans

MAIN, AUTOGRAD = (1, 1), (1, 2)


def span(name, ts, end, thread=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": f"nerfacc.{name}",
            "pid": thread[0], "tid": thread[1], "ts": ts, "dur": end - ts}


def launch(corr, ts, thread=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel",
            "pid": thread[0], "tid": thread[1], "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}}


def op(corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "pid": 0, "tid": 7,
            "ts": ts, "dur": end - ts, "args": {"correlation": corr}}


def events(with_composite=True):
    ev = [span("train_step", 0, 100), span("render", 0, 40),
          span("march", 0, 10), span("field", 10, 30),
          span("encoder", 12, 20), span("backward", 40, 80),
          span("optimizer", 80, 100),
          # not the program's: ignored
          {"ph": "X", "cat": "user_annotation", "name": "Optimizer.step",
           "pid": 1, "tid": 1, "ts": 81, "dur": 10},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "nerfacc.render",
           "pid": 0, "tid": 7, "ts": 0, "dur": 40},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1,
           "tid": 1, "ts": 1.5, "dur": 2}]
    if with_composite:
        ev.append(span("composite", 30, 40))
    ev += [
        launch(1, 2), op(1, 5, 15),  # march
        launch(2, 14), op(2, 15, 25),  # encoder, inside field
        launch(3, 22, cat="cuda_driver"), op(3, 30, 35),  # field, 5 idle
        launch(4, 32), op(4, 33, 40),  # composite, overlaps op 3
        launch(5, 50, AUTOGRAD), op(5, 50, 70),  # backward, 10 idle
        launch(6, 60, AUTOGRAD), op(6, 72, 74, "gpu_memset"),  # 2 idle
        launch(7, 90), op(7, 90, 96),  # optimizer, 16 idle
        op(9, 97, 98),  # no launch: the main thread's span at its start
        launch(8, 101), op(8, 110, 112),  # outside every span, 12 idle
    ]
    return ev


def test_stages_attribute_time_idle_and_launches():
    out = spans.stage_table(events(), units=2)
    want = {  # per unit of two: device, self, idle, kernels
        "march": (10, 10, 0, 1),
        "encoder": (10, 10, 0, 1),
        "field": (15, 5, 5, 2),
        "composite": (5, 5, 0, 1),
        "render": (30, 0, 5, 4),
        "backward": (22, 22, 12, 1),
        "optimizer": (7, 7, 17, 2),
        "train_step": (59, 0, 34, 7),
        spans.OUTSIDE: (2, 2, 12, 1),
    }
    assert set(out["stages"]) == set(want)
    for name, (dev, own, idle, kernels) in want.items():
        row = out["stages"][name]
        assert row["device_ms"] == pytest.approx(dev * 1e-3 / 2), name
        assert row["self_ms"] == pytest.approx(own * 1e-3 / 2), name
        assert row["idle_ms"] == pytest.approx(idle * 1e-3 / 2), name
        assert row["launches"] == kernels / 2, name
    assert out["device_ms"] == pytest.approx(61e-3 / 2)
    assert out["idle_ms"] == pytest.approx(46e-3 / 2)
    assert out["under_spans"] == pytest.approx(59 / 61)
    assert out["unlinked_ops"] == 1
    # the self times partition the busy time
    assert sum(r["self_ms"] for r in out["stages"].values()) == pytest.approx(
        out["device_ms"])


def _ctx(tmp_path, monkeypatch, ev, counts, workload="instant_ngp.train"):
    monkeypatch.setattr(spans, "TRACES", tmp_path)
    monkeypatch.setattr(spans, "counters", lambda: dict(counts))
    (tmp_path / f"{workload}.host.json").write_text(
        json.dumps({"traceEvents": ev}))
    cell = cells.load(workload)
    return cell, {"cell": cell, "host_trace": NS(units=1)}


STAGES = {"march_ms.train": "march", "encoder_ms.train": "encoder",
          "composite_ms.train": "composite", "backward_ms.train": "backward",
          "optimizer_ms.train": "optimizer"}


@pytest.mark.parametrize("with_composite", [True, False])
def test_stage_metrics_read_their_span_or_nothing(tmp_path, monkeypatch,
                                                  with_composite):
    cell, ctx = _ctx(tmp_path, monkeypatch, events(with_composite), {})
    readers = dict((e["name"], r) for e, r in cell.per_layer)
    table = spans.stage_table(events(with_composite), 1)["stages"]
    for metric, stage in STAGES.items():
        got = readers[metric].read(ctx)
        if stage == "composite" and not with_composite:
            assert got is None
        else:
            assert got == pytest.approx(table[stage]["device_ms"]), metric
    written = json.loads((tmp_path / "instant_ngp.train.stages.json")
                         .read_text())
    assert written["stages"] == ctx["stages"]["stages"]


def test_stage_metrics_give_nothing_without_spans(tmp_path, monkeypatch):
    no_spans = [e for e in events() if e["cat"] != "user_annotation"]
    cell, ctx = _ctx(tmp_path, monkeypatch, no_spans, {})
    readers = dict((e["name"], r) for e, r in cell.per_layer)
    for metric in list(STAGES) + ["density_pass_live.train",
                                  "field_rows_live.train"]:
        assert readers[metric].read(ctx) is None, metric
    assert ctx["stages"]["under_spans"] == 0.0


def test_live_shares_read_the_counters(tmp_path, monkeypatch):
    counts = {"density_rows": 400, "density_live": 100, "field_rows": 200,
              "field_live": 150}
    cell, ctx = _ctx(tmp_path, monkeypatch, events(), counts)
    readers = dict((e["name"], r) for e, r in cell.per_layer)
    assert readers["density_pass_live.train"].read(ctx) == 25.0
    assert readers["field_rows_live.train"].read(ctx) == 75.0
    view, vctx = _ctx(tmp_path, monkeypatch, events(),
                      {"field_rows": 10, "field_live": 4}, "instant_ngp.view")
    readers = dict((e["name"], r) for e, r in view.per_layer)
    assert readers["field_rows_live.render"].read(vctx) == 40.0
    assert readers["density_pass_live.render"].read(vctx) is None
