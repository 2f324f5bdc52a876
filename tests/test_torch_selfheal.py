"""Self-healing training in the port against the JAX package, on the
CPU: the hang watchdog (deadman, phase-aware stall classification, the
cooperative raise, auto-resume byte-identity), the numeric sentinels
(host and device verdicts, the limit as a tensor operand, the fault
seam's poison, the degraded-mode ladder) and the quarantine drills,
whose model text must equal the JAX package's under the same fault plan
(tolerance: byte equality but the ``device_type`` line), with no extra
host read per iteration.
"""
import time

import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import network
from lightgbm_tpu_torch.robust import FaultPlan, install_plan
from lightgbm_tpu_torch.robust.sentinel import (DEGRADED_LADDER,
                                                NumericSentinel,
                                                apply_degraded_rung,
                                                read_verdicts)
from lightgbm_tpu_torch.robust.watchdog import (HangTimeout, Watchdog,
                                                activate_watchdog,
                                                classify_stall,
                                                deactivate_watchdog,
                                                watch_phase)

from test_torch_robust import (BASE, _jax_reference_loop,  # noqa: F401
                               _make_data, _no_residual_fault_plan, _text,
                               _train, jax_text)


def _auc(y, p):
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    npos = int(y.sum())
    nneg = len(y) - npos
    return (ranks[y == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg)


# -- fault grammar: hang / nan / overflow --------------------------------

class TestSelfHealFaultGrammar:
    def test_parse(self):
        plan = FaultPlan.parse(
            "train.iteration:hang=2.5@3; sentinel.check:nan,"
            "collective.dispatch:overflow@*")
        assert [(s.seam, s.mode, s.arg, s.trigger) for s in plan.specs] == [
            ("train.iteration", "hang", 2.5, 3),
            ("sentinel.check", "nan", 0.0, 1),
            ("collective.dispatch", "overflow", 0.0, None),
        ]

    def test_hang_blocks_then_disarms(self):
        plan = FaultPlan.parse("collective.dispatch:hang=0.05@*")
        t0 = time.monotonic()
        spec = plan.check("collective.dispatch")
        assert spec is not None and spec.mode == "hang"
        assert time.monotonic() - t0 >= 0.05
        assert spec.disarmed
        # one-shot: the auto-resumed replay must not hang again
        assert plan.check("collective.dispatch") is None

    def test_nan_is_returned_to_the_caller(self):
        plan = FaultPlan.parse("train.iteration:nan@4")
        assert plan.check("train.iteration", index=3) is None
        spec = plan.check("train.iteration", index=4)
        assert spec is not None and spec.mode == "nan"


# -- watchdog ------------------------------------------------------------

@pytest.mark.parametrize("phase,stall", [
    ("collective:psum", "collective"), ("dispatch:update", "dispatch"),
    ("readback:eval scalars", "readback"),
    ("host-callback:after", "host-callback"),
    ("something:else", "iteration"), (None, "iteration")])
def test_classify_stall(phase, stall):
    from lightgbm_tpu.robust.watchdog import classify_stall as jclassify
    assert classify_stall(phase) == stall == jclassify(phase)


class TestWatchdog:
    def test_timeout_must_be_positive(self):
        with pytest.raises(ValueError):
            Watchdog(0.0)

    def test_deadman_trips_between_heartbeats(self):
        wd = Watchdog(0.08, poll_s=0.02).start()
        try:
            time.sleep(0.25)
            with pytest.raises(HangTimeout) as ei:
                wd.check()
            d = ei.value.diagnosis
            assert d["stall_class"] == "iteration"
            assert "hang_timeout" in d["message"]
            assert wd.trip_count == 1
            wd.clear()
            wd.check()                       # re-armed, no residual trip
        finally:
            wd.stop()

    def test_phase_exit_is_a_cooperative_check_point(self):
        wd = Watchdog(0.08, poll_s=0.02).start()
        try:
            with pytest.raises(HangTimeout) as ei:
                with wd.phase("readback:eval scalars"):
                    time.sleep(0.25)
            d = ei.value.diagnosis
            assert d["stall_class"] == "readback"
            assert d["phase"] == "readback:eval scalars"
        finally:
            wd.stop()

    def test_warmup_grace_tolerates_cold_starts(self):
        wd = Watchdog(0.05, poll_s=0.02, warmup_grace_s=30.0).start()
        try:
            wd.beat(0)
            time.sleep(0.2)                  # would trip without grace
            wd.check()
            for i in range(1, Watchdog.WARMUP_ITERS + 1):
                wd.beat(i)
            time.sleep(0.2)                  # warm now: strict timeout
            with pytest.raises(HangTimeout):
                wd.check()
        finally:
            wd.stop()

    def test_watch_phase_is_free_without_a_watchdog(self):
        deactivate_watchdog()
        with watch_phase("collective:psum") as wd:
            assert wd is None

    def test_diagnosis_keys_are_the_jax_packages(self):
        """The port's trip carries the JAX package's diagnosis keys; the
        trace file and the straggler are None until their subsystems
        are ported, as the JAX package's are when they are off."""
        from lightgbm_tpu.robust.watchdog import Watchdog as JaxWatchdog
        diags = []
        for cls in (Watchdog, JaxWatchdog):
            wd = cls(0.05, poll_s=0.02).start()
            try:
                time.sleep(0.2)
                diags.append(wd.tripped)
            finally:
                wd.stop()
        assert sorted(diags[0]) == sorted(diags[1])
        assert diags[0]["trace_file"] is None
        assert diags[0]["slowest_rank"] is None


def test_collective_hang_is_classified():
    """An injected collective.dispatch hang is detected and classified as
    a 'collective' stall at the span's exit (no process group needed)."""
    wd = activate_watchdog(Watchdog(0.15, poll_s=0.04).start())
    install_plan("collective.dispatch:hang=0.6")
    try:
        with pytest.raises(HangTimeout) as ei:
            with network.collective_span("psum"):
                pass
    finally:
        deactivate_watchdog(wd)
        wd.stop()
    d = ei.value.diagnosis
    assert d["stall_class"] == "collective"
    assert d["phase"] == "collective:psum"


def test_collective_seam_raises_through_the_span():
    install_plan("collective.dispatch:ioerror")
    with pytest.raises(OSError):
        with network.collective_span("all_gather"):
            pass


class TestTrainingHang:
    def test_hang_raises_actionable_timeout_without_auto_resume(self):
        X, y = _make_data()
        install_plan("train.iteration:hang=0.6@3")
        with pytest.raises(HangTimeout) as ei:
            _train(tlgb, dict(BASE, hang_timeout=0.25), X, y, 5)
        d = ei.value.diagnosis
        assert d["stall_class"] in ("iteration", "dispatch")
        assert d["iteration"] == 3
        assert "trace_file" in d and "slowest_rank" in d

    def test_auto_resume_is_byte_identical(self, tmp_path):
        """A hang mid-train with auto_resume: the watchdog's trip
        restores the last checkpoint in-process, and the model text
        equals a run that never hung (the JAX tests' margins)."""
        X, y = _make_data()
        install_plan("train.iteration:hang=3.0@4")
        healed = _train(tlgb, dict(BASE, hang_timeout=1.2, auto_resume=True),
                        X, y, 6, str(tmp_path / "ck"))
        install_plan(None)
        assert healed.model_to_string() == _train(tlgb, BASE, X, y,
                                                  6).model_to_string()

    def test_auto_resume_without_checkpoint_raises(self):
        X, y = _make_data()
        install_plan("train.iteration:hang=0.6@3")
        with pytest.raises(HangTimeout):
            _train(tlgb, dict(BASE, hang_timeout=0.25, auto_resume=True),
                   X, y, 5)


# -- numeric sentinels ---------------------------------------------------

class TestNumericSentinel:
    def test_host_nan_and_overflow_verdicts(self):
        s = NumericSentinel(overflow_limit=1e30)
        s.dispatch([np.array([1.0, np.nan, 2.0])], 3)
        assert s.pop_trips() == [(3, "nan")]
        s.dispatch([np.array([1.0, 2e30])], 4)
        assert s.pop_trips() == [(4, "overflow")]
        assert (s.trips, s.total_trips) == (2, 2)
        s.reset_trips()
        assert (s.trips, s.total_trips) == (0, 2)

    def test_device_verdicts_ride_one_read(self):
        s = NumericSentinel()
        s.dispatch([torch.tensor([1.0, float("nan"), 2.0]),
                    torch.tensor([1.0, float("inf")])], 1)
        s.dispatch([np.array([5.0])], 2, defer=True)
        assert s.has_pending and s.pop_trips() == []
        pending = s.take_pending()
        assert not s.has_pending
        extra = [torch.tensor([0.25, 0.5], dtype=torch.float64)]
        values, host = read_verdicts(pending, extra)
        assert host.tolist() == [0.25, 0.5]
        s.resolve(pending, values)
        assert s.pop_trips() == [(1, "nan"), (1, "nan")]

    def test_overflow_limit_is_a_tensor_operand(self):
        arr = torch.full((8,), 100.0)
        s = NumericSentinel(overflow_limit=50.0)
        s.dispatch([arr], 1)
        limit = s._limits[str(arr.device)]
        assert torch.is_tensor(limit) and limit.dtype == torch.float32
        s.dispatch([arr], 2)
        assert s._limits[str(arr.device)] is limit     # made once
        pending = s.take_pending()
        s.resolve(pending, read_verdicts(pending)[0])
        assert s.pop_trips() == [(1, "overflow"), (2, "overflow")]
        s2 = NumericSentinel(overflow_limit=1e30)
        s2.dispatch([arr], 3)
        pending = s2.take_pending()
        s2.resolve(pending, read_verdicts(pending)[0])
        assert s2.pop_trips() == []

    @pytest.mark.parametrize("mode,kind", [("nan", "nan"),
                                           ("overflow", "overflow")])
    def test_seam_poisons_the_checked_plane(self, mode, kind):
        install_plan(f"sentinel.check:{mode}")
        s = NumericSentinel()
        s.dispatch([np.zeros(4)], 2)
        assert s.pop_trips() == [(2, kind)]
        s.dispatch([torch.zeros(4)], 3)          # the seam fired once
        pending = s.take_pending()
        s.resolve(pending, read_verdicts(pending)[0])
        assert s.pop_trips() == []

    def test_drop_pending_abandons_the_old_timeline(self):
        s = NumericSentinel()
        s.dispatch([torch.tensor([float("nan")])], 0)
        s.dispatch([np.array([np.nan])], 1)      # host: trips at once
        assert s.has_pending and s._trips_out
        s.drop_pending()
        assert not s.has_pending and s.pop_trips() == []

    def test_quant_tripwire_is_quiet_without_a_registry(self):
        assert NumericSentinel().poll_quant_tripwire() is False


def test_degraded_ladder_matches_the_jax_package():
    from lightgbm_tpu.robust.sentinel import DEGRADED_LADDER as JLADDER

    class G:
        _pipeline = True
        _device_eval = True
        degraded_rungs = []
    g = G()
    assert DEGRADED_LADDER == JLADDER == ("pipeline", "device_eval",
                                          "aot_store")
    assert apply_degraded_rung(g, 0) == "pipeline" and g._pipeline is False
    assert apply_degraded_rung(g, 1) == "device_eval"
    assert g._device_eval is False
    assert apply_degraded_rung(g, 2) == "aot_store"
    assert apply_degraded_rung(g, len(DEGRADED_LADDER)) is None
    assert g.degraded_rungs == list(DEGRADED_LADDER)


def test_host_eval_rung_keeps_the_metrics():
    """The device_eval rung evaluates on a host copy of the scores: the
    same values."""
    X, y = _make_data()
    Xv, yv = _make_data(200, seed=8)
    ds = tlgb.Dataset(X, label=y)
    bst = tlgb.train(dict(BASE, device_type="cpu", metric="auc"), ds,
                     num_boost_round=3, valid_sets=[ds.create_valid(
                         Xv, label=yv)], verbose_eval=False,
                     keep_training_booster=True)
    before = bst._gbdt.eval_at_iter()
    bst._gbdt._device_eval = False
    assert bst._gbdt.eval_at_iter() == before


# -- quarantine, against the JAX package ---------------------------------

DRILLS = {
    "host_loop_nan_gradient": ({"tpu_fused": False}, "train.iteration:nan@3"),
    "fused_leaf_sentinel": ({}, "sentinel.check:nan@3"),
    "host_loop_overflow_gradient": ({"tpu_fused": False},
                                    "train.iteration:overflow@2"),
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_quarantine_drill_matches_the_jax_package(drill):
    """Under the same fault plan, with numeric_sentinels: exactly one
    tree fewer than the clean run, finite predictions, and the JAX
    package's model text."""
    extra, plan = DRILLS[drill]
    X, y = _make_data()
    params = dict(BASE, numeric_sentinels=True, **extra)
    install_plan(plan)
    poisoned = _train(tlgb, params, X, y, 6)
    install_plan(None)
    clean = _train(tlgb, params, X, y, 6)
    assert poisoned.num_trees() == clean.num_trees() - 1
    p = poisoned.predict(X)
    assert np.isfinite(p).all()
    assert abs(_auc(y, p) - _auc(y, clean.predict(X))) <= 1e-2
    assert _text(poisoned) == jax_text("drill:" + drill, params, X, y, 6,
                                       plan=plan)


def test_sentinels_off_leave_the_model_unchanged():
    X, y = _make_data()
    plain = _train(tlgb, BASE, X, y, 2)
    knobs = _train(tlgb, dict(BASE, numeric_sentinels=True,
                              sentinel_overflow_limit=123.0,
                              sentinel_max_trips=5), X, y, 2)
    text = knobs.model_to_string()
    assert "sentinel" not in text and text == plain.model_to_string()


class TestQuarantine:
    def test_quarantine_iter_bounds_and_rebuild(self):
        X, y = _make_data()
        bst = _train(tlgb, BASE, X, y, 4, keep_training_booster=True)
        g = bst._gbdt
        assert not g.quarantine_iter(99)
        assert g.quarantine_iter(2)
        assert bst.num_trees() == 3 and g.iter == 3
        assert np.isfinite(bst.predict(X)).all()
        # the scores are the surviving trees' own
        raw = bst.predict(X, raw_score=True).astype(np.float32)
        np.testing.assert_allclose(g.get_training_score()[0].numpy(), raw,
                                   rtol=1e-6, atol=1e-6)

    def test_dart_quarantine_drops_tree_weight(self):
        X, y = _make_data()
        bst = _train(tlgb, dict(BASE, boosting="dart", drop_rate=0.3,
                                tpu_fused=False), X, y, 3,
                     keep_training_booster=True)
        g = bst._gbdt
        n, w, sw = len(g.models), len(g.tree_weight), g.sum_weight
        assert g.quarantine_iter(1)
        assert len(g.models) == n - 1
        assert len(g.tree_weight) == w - 1
        assert g.sum_weight < sw
        assert np.isfinite(bst.predict(X)).all()

    def test_repeated_trips_roll_back_and_step_down(self, tmp_path):
        """Two trips reach sentinel_max_trips: the run rolls back to the
        last checkpoint, takes the first rung of the ladder, and still
        finishes with finite predictions."""
        X, y = _make_data()
        install_plan("train.iteration:nan@3;train.iteration:nan@4")
        bst = _train(tlgb, dict(BASE, tpu_fused=False,
                                numeric_sentinels=True), X, y, 6,
                     str(tmp_path / "ck"), keep_training_booster=True)
        assert bst._gbdt.degraded_rungs == ["pipeline"]
        assert np.isfinite(bst.predict(X)).all()


def _count_reads(monkeypatch):
    """Counts of the host reads a training takes (.cpu, .item, .tolist)."""
    counts = {"n": 0}
    for name in ("cpu", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            counts["n"] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return counts


@pytest.mark.parametrize("extra", [{}, {"tpu_fused": False},
                                   {"bagging_fraction": 0.7,
                                    "bagging_freq": 1}],
                         ids=["fused", "host_loop", "per_tree"])
def test_sentinels_add_no_host_read(monkeypatch, extra):
    """The verdicts ride the reads the loop makes anyway: with a valid
    set, a training with sentinels takes as many host reads as one
    without."""
    X, y = _make_data()
    Xv, yv = _make_data(200, seed=8)
    reads = {}
    for on in (False, True):
        ds = tlgb.Dataset(X, label=y)
        vs = ds.create_valid(Xv, label=yv)
        ds.construct()
        vs.construct()
        with monkeypatch.context() as mp:
            counts = _count_reads(mp)
            tlgb.train(dict(BASE, device_type="cpu", numeric_sentinels=on,
                            metric="binary_logloss", **extra), ds,
                       num_boost_round=5, valid_sets=[vs],
                       verbose_eval=False)
        reads[on] = counts["n"]
    assert reads[True] == reads[False] > 0
