"""The port's spans and counters (``utils/tracing.py``) on the CPU, over a
3-step ScaffoldGS run at 32x32 (feat 8, hidden 16, k 4):

- the span tree, its parents and step ids, with ``enable()``;
- the counters against the step's own outputs;
- off: no ``record_function``, no CUDA event, no counter, nothing recorded;
- the losses bit-equal with tracing on and off;
- under ``torch.profiler`` alone: the spans as ``user_annotation`` events
  inside ``step``'s interval, a second session dropping the first's
  records, and the trainer's profile window writing ``spans_*.json``;
- the record cap, and parents kept within a session;
- ``tools/trace_report.py`` on a synthetic Chrome trace.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from triangle_splatting_tpu_torch.tools import trace_report
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils import tracing
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

UPDATE_AT = 3           # the anchor update of the 3-step run
VIEW_SPANS = ("scaffold.prefilter", "scaffold.decode", "raster.preprocess", "raster.binning",
              "raster.blend", "loss", "backward", "stats")


def scaffold_config(root, out_dir, iters=3, **trainer):
    lr = lambda v: dict(v_init=v, v_final=v, max_steps=iters)  # noqa: E731
    return dict(
        dataset=dict(type="NerfSynthetic", local_dir=str(root), background="white",
                     use_alpha_mask=False, num_workers=2, pcd_path="point_cloud.ply",
                     hold_test_set=True),
        model=dict(
            feat_dim=8, hidden_dim=16, n_offsets=4, voxel_size=0.1, max_offset_scale=1.0,
            max_scaling_scale=1.0, capacity_factor=4.0, pairs_per_triangle=8,
            optimizer=dict(anchor=lr(0.0), anchor_feat=lr(0.05), mlp_offset=lr(0.01),
                           mlp_opacity=lr(0.01), mlp_cov=lr(0.01), mlp_color=lr(0.01),
                           mlp_scaling=lr(0.01)),
            anchor_update=dict(start_iter=0, end_iter=iters, interval_iter=UPDATE_AT,
                               grad_threshold_init=1e-4, grad_threshold_final=1e-4,
                               opacity_threshold_init=0.005, opacity_threshold_final=0.005,
                               grad_min_view_count=1, opacity_min_view_count=1,
                               update_depth=2, update_init_factor=4,
                               update_hierachy_factor=4)),
        trainer=dict(dict(type="ScaffoldGS", output_dir=str(out_dir), iterations=iters,
                          initial_eval=False, log_interval_iter=0, eval_interval_iter=0,
                          w_ssim=0.2, w_scaling_reg=0.01, w_opacity_reg=0.01,
                          save_iterations=[], checkpoint_iterations=[],
                          train_background="white", eval_background="white",
                          use_tensorboard=False, seed=0), **trainer))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("tracing"), res=32, n_tri=80,
                                        pcd_points=300, seed=6, device="cpu")


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def trainer(dataset, tmp_path, **kw):
    tr = build_trainer(dict_to_config(scaffold_config(dataset, tmp_path / "out", **kw)),
                       log_file=False, device="cpu")
    tr._init_model()
    return tr


def run_steps(tr, iterations):
    """The ``_train`` loop's body, as the benchmark drives it; returns each
    step's (loss, aux, C * k)."""
    out = []
    for it in iterations:
        camera, views, idle = tr._next_batch()
        slots = tr.params.capacity * tr.model_cfg.n_offsets
        tr.params, tr.opt, tr.state, loss, aux = tr._train_step_dp(
            tr._settings_for(camera), tr.params, tr.opt, tr.state, views, tr._loss_weights(it),
            tr._lrs(it), torch.ones(3), it, idle_camera=idle)
        tr._model_update(it)
        out.append((loss, aux, slots))
    return out


def records():
    return tracing._REG.records


def test_span_tree_of_a_scaffold_run(dataset, tmp_path):
    tr = trainer(dataset, tmp_path)
    tracing.enable()
    run_steps(tr, [1, 2, 3])
    recs = records()
    parent = lambda r: recs[r.parent].name if r.parent >= 0 else None  # noqa: E731
    tree = {}
    for r in recs:
        tree.setdefault(r.name, set()).add(parent(r))
    assert tree["data"] == {None} and tree["step"] == {None} and tree["update"] == {None}
    assert tree["view"] == {"step"} and tree["adam"] == {"step"}
    for name in VIEW_SPANS:
        assert "view" in tree[name], name
    assert tree["stats"] == {"view", "step"}          # the view's entries, then the state's
    assert tree["scaffold.grow"] == tree["scaffold.prune"] == {"update"}
    assert tree.get("data.wait", {"data"}) == {"data"}
    snap = tracing.snapshot()
    calls = {n: s["calls"] for n, s in snap["spans"].items()}
    assert calls["step"] == calls["view"] == calls["adam"] == calls["update"] == 3
    assert calls["scaffold.grow"] == calls["scaffold.prune"] == 1
    assert all(calls[n] == 3 for n in VIEW_SPANS if n != "stats") and calls["stats"] == 6
    assert all(s["device_ms"] is None and s["host_ms"] >= 0 for s in snap["spans"].values())
    # every span of a step and of its update carries the iteration
    for r in recs:
        top = r
        while top.parent >= 0:
            top = recs[top.parent]
        if top.name in ("step", "update"):
            assert r.step == top.step, (r.name, r.step, top.step)
    assert [r.step for r in recs if r.name == "step"] == [1, 2, 3]
    assert [r.step for r in recs if r.name == "scaffold.grow"] == [UPDATE_AT]
    assert snap["dropped"] == 0 and snap["records"] == len(recs)
    assert "blend_forward.GS" in snap["launches"]


def test_counters_match_the_steps(dataset, tmp_path):
    tr = trainer(dataset, tmp_path)
    tracing.enable()
    steps = run_steps(tr, [1, 2, 3])
    c = tracing.snapshot()["counters"]
    assert c["scaffold.selected"] == sum(int(aux["n_gaussians"]) for _, aux, _ in steps) > 0
    assert c["raster.pairs"] == sum(int(aux["num_pairs"]) for _, aux, _ in steps) > 0
    assert c["scaffold.slots"] == sum(slots for _, _, slots in steps)
    assert c["raster.overflow"] == sum(int(aux["overflow"]) for _, aux, _ in steps)
    assert c["raster.evals"] > 0 and 0 < c["scaffold.visible"] <= c["scaffold.alive"]
    hist = tr.anchor_history[-1]
    assert c["scaffold.added"] == hist["added"] and c["scaffold.removed"] == hist["removed"]
    assert c["data.loaded"] + c.get("data.cache_hit", 0) == 3


def test_off_records_nothing_and_touches_nothing(dataset, tmp_path, monkeypatch):
    tr = trainer(dataset, tmp_path)
    tracing.enable()
    tracing.disable()                     # an empty session, closed

    def refuse(*a, **k):
        raise AssertionError("tracing off reached the recorder")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing.Registry, "add", refuse)
    monkeypatch.setattr(tracing.Registry, "open", refuse)
    run_steps(tr, [1, 2, 3])
    assert not tracing.active() and records() == [] and tracing._REG.counters() == {}


def test_losses_equal_with_tracing_on_and_off(dataset, tmp_path):
    off = [float(loss) for loss, _, _ in run_steps(trainer(dataset, tmp_path / "a"), [1, 2, 3])]
    tracing.enable()
    on = [float(loss) for loss, _, _ in run_steps(trainer(dataset, tmp_path / "b"), [1, 2, 3])]
    assert len(records()) > 0
    assert on == off


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_lie_in_the_profilers_trace_inside_step(dataset, tmp_path):
    tr = trainer(dataset, tmp_path)
    run_steps(tr, [1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_steps(tr, [2])
    ann = _annotations(prof, tmp_path)
    (step,) = [e for e in ann if e["name"] == "step"]
    s0, s1 = step["ts"], step["ts"] + step["dur"]
    names = {e["name"] for e in ann}
    assert {"data", "update", "view", "adam", *VIEW_SPANS} <= names
    inner = [e for e in ann if e["name"] in ("view", "adam", *VIEW_SPANS)]
    assert inner and all(s0 <= e["ts"] and e["ts"] + e["dur"] <= s1 for e in inner)
    # recorded without enable(), the profiler's session alone
    assert [r.step for r in records() if r.name == "step"] == [2]
    assert not tracing.active()


def test_a_new_profiler_session_drops_the_last(dataset, tmp_path):
    tr = trainer(dataset, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]):
        run_steps(tr, [1])
    assert [r.step for r in records() if r.name == "step"] == [1]
    run_steps(tr, [2])
    assert [r.step for r in records() if r.name == "step"] == [1]   # off: kept, not added
    with profile(activities=[ProfilerActivity.CPU]):
        run_steps(tr, [3])
    steps = {r.step for r in records()}
    assert [r.step for r in records() if r.name == "step"] == [3] and 1 not in steps


def test_record_cap_holds(dataset, tmp_path, monkeypatch):
    tr = trainer(dataset, tmp_path)
    monkeypatch.setattr(tracing._REG, "cap", 7)
    tracing.enable()
    run_steps(tr, [1, 2])
    snap = tracing.snapshot()
    assert len(records()) == snap["records"] == 7 and snap["dropped"] > 0
    assert sum(s["calls"] for s in snap["spans"].values()) == 7
    assert tracing._REG.stack() == []


def test_a_session_begun_inside_a_span_keeps_its_parents_its_own(tmp_path):
    tracing.enable()
    with tracing.span("outer"):
        tracing.enable()                  # a new session while "outer" is open
        with tracing.span("inner"):
            tracing.count("n", 2)
    assert [(r.name, r.parent) for r in records()] == [("inner", -1)]
    tracing.write(tmp_path / "s.json")
    doc = json.loads((tmp_path / "s.json").read_text())
    assert doc["records"][0]["parent"] is None and doc["snapshot"]["counters"] == {"n": 2}


def test_profile_window_writes_the_spans(dataset, tmp_path):
    tr = trainer(dataset, tmp_path, iterations=4, profile_start_iter=2, profile_end_iter=4)
    tr.train()
    out = Path(tr.output_dir) / "profile"
    assert (out / "trace_2_4.json").exists()
    doc = json.loads((out / "spans_2_4.json").read_text())
    assert {r["step"] for r in doc["records"] if r["name"] == "step"} == {2, 3}
    assert doc["snapshot"]["spans"]["step"]["calls"] == 2
    assert doc["snapshot"]["counters"]["scaffold.slots"] > 0
    rep = trace_report.report(json.loads((out / "trace_2_4.json").read_text()))
    assert rep["device_ms"] == {} and rep["spans"] >= doc["snapshot"]["records"]


def _ev(name, cat, ts, dur, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=1, args=args)


def test_trace_report_attributes_gaps_to_the_innermost_span():
    """step [0, 100) holds view [5, 60) holding raster.blend [10, 30) and
    loss [35, 55); adam [62, 90). Kernels launched at 12 (blend), 36
    (loss), 63 (adam) and 40 (loss, its launch's correlation) run on the
    device at [20, 28), [40, 44), [70, 80) and [44, 46)."""
    ev = [_ev("step", "user_annotation", 0, 100), _ev("view", "user_annotation", 5, 55),
          _ev("raster.blend", "user_annotation", 10, 20), _ev("loss", "user_annotation", 35, 20),
          _ev("adam", "user_annotation", 62, 28), _ev("bench.step", "user_annotation", 0, 100)]
    for corr, (launch, k0, k1) in enumerate([(12, 20, 28), (36, 40, 44), (63, 70, 80),
                                             (40, 44, 46)]):
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", launch, 1, correlation=corr))
        ev.append(_ev(f"kernel{corr}", "kernel", k0, k1 - k0, correlation=corr))
    rep = trace_report.report(dict(traceEvents=ev))
    ms = lambda us: us * 1e-3  # noqa: E731
    assert rep["device_ms"] == pytest.approx({"raster.blend": ms(8), "loss": ms(6),
                                              "adam": ms(10)})
    # gaps: [28, 40) closed by loss's kernel, [46, 70) by adam's
    assert rep["idle_ms"] == pytest.approx({"loss": ms(12), "adam": ms(24)})
    assert rep["busy_ms"] == pytest.approx(ms(24)) and rep["in_span_share"] == 1.0
    text = trace_report.format_report(rep)
    assert "raster.blend" in text and "adam" in text
