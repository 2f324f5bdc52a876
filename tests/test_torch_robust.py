"""Preemption-safe training in the port (``lightgbm_tpu_torch/robust/``)
against the JAX package's, on the CPU.

Covers the fault-plan grammar (parsed alike by both packages), the
atomic checkpoint writer with its torn / partial / corrupt fallbacks,
the checkpoint file format (each package reads the other's files), the
configuration digest, resume bit-identity on both learners and the
boosting modes (tolerance: the resumed model text equals the
uninterrupted run's byte for byte, and that text equals the JAX
package's for the same params but the ``device_type`` line), the
``checkpoint_dir`` param and CLI flags, and a SIGKILL'd child process
resumed to the uninterrupted model text.

The JAX package's trainings run once per case and process (module-level
cache) with its synchronous loop (``LGBM_TPU_PIPELINE=0``, the port's
parity reference) and its AOT store off.
"""
import errno
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.robust import CheckpointManager as JaxCheckpointManager
from lightgbm_tpu.robust import faultinject as jfi
from lightgbm_tpu_torch.robust import (CheckpointError, CheckpointManager,
                                       FaultPlan, install_plan)
from lightgbm_tpu_torch.robust import faultinject as fi
from lightgbm_tpu_torch.robust import watchdog as twd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_loop():
    """The JAX package's synchronous loop and no AOT store; torch on two
    threads, as the other port test modules."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setenv("LGBM_TPU_PIPELINE", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_residual_fault_plan(monkeypatch):
    """No fault plan or watchdog leaks between tests, in either package."""
    from lightgbm_tpu.robust import install_plan as jinstall
    from lightgbm_tpu.robust.watchdog import deactivate_watchdog as jdeact
    monkeypatch.delenv(fi.ENV_VAR, raising=False)
    for inst, mod in ((install_plan, fi), (jinstall, jfi)):
        inst(None)
        mod._ENV_CACHE = None
    yield
    for inst, mod in ((install_plan, fi), (jinstall, jfi)):
        inst(None)
        mod._ENV_CACHE = None
    twd.deactivate_watchdog()
    jdeact()


# -- fault plan grammar -------------------------------------------------

class TestFaultPlan:
    def test_parse_grammar(self):
        plan = FaultPlan.parse(
            "checkpoint.write:enospc@2; store.load:corrupt,"
            "train.iteration:delay=0.5@3")
        assert [(s.seam, s.mode, s.arg, s.trigger) for s in plan.specs] == [
            ("checkpoint.write", "enospc", 0.0, 2),
            ("store.load", "corrupt", 0.0, None),
            ("train.iteration", "delay", 0.5, 3),
        ]

    def test_default_and_explicit_triggers(self):
        assert FaultPlan.parse("sink.write:ioerror").specs[0].trigger == 1
        assert FaultPlan.parse("sink.write:ioerror@*").specs[0].trigger is None
        assert FaultPlan.parse("store.load:truncate").specs[0].trigger is None

    @pytest.mark.parametrize("text,word", [("garbage", "garbage"),
                                           ("checkpoint.write:explode",
                                            "explode")])
    def test_bad_entry_names_itself(self, text, word):
        with pytest.raises(ValueError, match=word):
            FaultPlan.parse(text)

    def test_hit_count_trigger(self):
        plan = FaultPlan.parse("sink.write:ioerror@2")
        assert plan.check("sink.write") is None
        with pytest.raises(OSError) as ei:
            plan.check("sink.write")
        assert ei.value.errno == errno.EIO
        assert plan.fired == ["sink.write:ioerror@2"]
        assert plan.check("other.seam") is None

    def test_indexed_seam_matches_iteration(self):
        plan = FaultPlan.parse("train.iteration:enospc@3")
        assert plan.check("train.iteration", index=0) is None
        assert plan.check("train.iteration", index=2) is None
        with pytest.raises(OSError) as ei:
            plan.check("train.iteration", index=3)
        assert ei.value.errno == errno.ENOSPC

    def test_filter_bytes_truncate_and_corrupt(self):
        payload = bytes(range(200))
        out = FaultPlan.parse("store.load:truncate").filter_bytes(
            "store.load", payload)
        assert out == payload[:100]
        out = FaultPlan.parse("store.load:corrupt").filter_bytes(
            "store.load", payload)
        assert len(out) == len(payload) and out != payload
        assert out[:100] == payload[:100]
        assert fi.filter_bytes("store.load", payload) == payload  # no plan

    def test_install_plan_overrides_env(self, monkeypatch):
        monkeypatch.setenv(fi.ENV_VAR, "sink.write:ioerror")
        env_plan = fi.active_plan()
        assert env_plan is not None and env_plan.text == "sink.write:ioerror"
        assert fi.active_plan() is env_plan              # cached per text
        mine = install_plan("trace.export:ioerror")
        assert fi.active_plan() is mine
        install_plan(None)
        assert fi.active_plan() is env_plan

    def test_module_seam_is_quiet_without_a_plan(self):
        assert fi.check_fault("train.iteration", index=3) is None


PLANS = [
    "checkpoint.write:enospc@2; store.load:corrupt,train.iteration:delay=0.5@3",
    "train.iteration:sigkill@5",
    "train.iteration:hang=3.0@4",
    "train.iteration:nan@3; sentinel.check:overflow",
    "collective.dispatch:hang=0.6@*",
    "checkpoint.write:torn, checkpoint.write:partial@2",
    "store.load:truncate@4;sink.write:ioerror@*",
    " trace.export : ioerror ; ",
]


@pytest.mark.parametrize("text", PLANS)
def test_plan_parses_as_in_the_jax_package(text):
    """Both packages read one ``LGBM_TPU_FAULT_PLAN`` the same way:
    seams, modes, arguments and triggers equal."""
    def specs(plan):
        return [(s.seam, s.mode, s.arg, s.trigger, repr(s))
                for s in plan.specs]
    assert specs(FaultPlan.parse(text)) == specs(jfi.FaultPlan.parse(text))


# -- checkpoint manager -------------------------------------------------

def _mgr(tmp_path, cls=CheckpointManager, **kw):
    kw.setdefault("interval", 2)
    kw.setdefault("barrier", lambda: None)
    kw.setdefault("process_index", 0)
    return cls(str(tmp_path / "ck"), **kw)


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"iter": 7, "score": rng.randn(64).astype(np.float32),
            "bits": rng.randint(-2 ** 31, 2 ** 31, 16).astype(np.int32),
            "nested": {"rng": rng.randint(0, 2 ** 31, 8, dtype=np.int64),
                       "names": ["a", "b"], "flag": True,
                       "keys": rng.randint(0, 2 ** 32, 624,
                                           dtype=np.uint64).astype(np.uint32),
                       "none": None}}


def _assert_states_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, (list, tuple))
                                   and isinstance(b, (list, tuple)))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_states_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_states_equal(x, y)
    else:
        assert a == b


class TestCheckpointManager:
    def test_due_schedule(self, tmp_path):
        m = _mgr(tmp_path, interval=3)
        assert [i for i in range(9) if m.due(i)] == [2, 5, 8]
        assert not any(_mgr(tmp_path, interval=0).due(i) for i in range(9))

    def test_save_load_round_trip_is_bit_exact(self, tmp_path):
        m = _mgr(tmp_path)
        st = _state()
        path = m.save(5, st, "tree\nv=1\n")
        assert path == m.path_for(5) and os.path.exists(path)
        it, got, model = m.load_latest()
        assert it == 5 and model == "tree\nv=1\n"
        _assert_states_equal(got, st)

    def test_tensors_are_stored_through_numpy(self, tmp_path):
        m = _mgr(tmp_path)
        t = torch.arange(6, dtype=torch.float32) / 3
        m.save(1, {"t": t}, "m")
        _, got, _ = m.load_latest()
        assert got["t"].dtype == np.float32
        assert got["t"].tobytes() == t.numpy().tobytes()

    def test_prune_keeps_newest_k(self, tmp_path):
        m = _mgr(tmp_path, keep=2)
        for it in (1, 3, 5):
            m.save(it, {"x": 1}, "m")
        assert sorted(os.listdir(m.directory)) == [
            "ckpt_0000003.lgbckpt", "ckpt_0000005.lgbckpt"]

    def test_prune_never_unlinks_the_kept_window(self, tmp_path):
        m = _mgr(tmp_path, keep=3)
        for it in (1, 3, 5, 7, 9):
            m.save(it, {"x": it}, "m")
        assert sorted(os.listdir(m.directory)) == [
            "ckpt_0000005.lgbckpt", "ckpt_0000007.lgbckpt",
            "ckpt_0000009.lgbckpt"]

    def test_load_latest_tolerates_concurrent_prune(self, tmp_path,
                                                    monkeypatch):
        m = _mgr(tmp_path)
        m.save(1, {"x": 1}, "one")
        m.save(3, {"x": 3}, "three")
        orig = m._read

        def racing_read(path):
            if path.endswith("0000003.lgbckpt"):
                raise FileNotFoundError(path)
            return orig(path)
        monkeypatch.setattr(m, "_read", racing_read)
        assert m.load_latest()[::2] == (1, "one")

    def test_corrupt_newest_falls_back_to_previous(self, tmp_path):
        m = _mgr(tmp_path)
        m.save(1, {"x": 1}, "one")
        m.save(3, {"x": 3}, "three")
        with open(m.path_for(3), "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            fh.write(b"\xff")
        it, _, model = m.load_latest()
        assert (it, model) == (1, "one")

    def test_torn_write_falls_back(self, tmp_path):
        m = _mgr(tmp_path)
        m.save(1, {"x": 1}, "one")
        install_plan("checkpoint.write:torn")
        m.save(3, {"x": 3}, "three")
        install_plan(None)
        assert os.path.exists(m.path_for(3))
        it, _, model = m.load_latest()
        assert (it, model) == (1, "one")

    def test_partial_write_leaves_no_checkpoint(self, tmp_path):
        m = _mgr(tmp_path)
        install_plan("checkpoint.write:partial")
        assert m.save(1, {"x": 1}, "one") is None
        install_plan(None)
        assert not os.path.exists(m.path_for(1))
        assert m.load_latest() is None

    @pytest.mark.parametrize("mode", ["enospc", "ioerror"])
    def test_write_error_is_nonfatal(self, tmp_path, mode):
        m = _mgr(tmp_path)
        m.save(1, {"x": 1}, "one")
        install_plan(f"checkpoint.write:{mode}")
        assert m.save(3, {"x": 3}, "three") is None     # no raise
        install_plan(None)
        assert m.load_latest()[::2] == (1, "one")

    def test_foreign_params_digest_is_refused(self, tmp_path):
        _mgr(tmp_path, params_digest="aaa").save(1, {"x": 1}, "one")
        assert _mgr(tmp_path, params_digest="bbb").load_latest() is None
        assert _mgr(tmp_path, params_digest="aaa").load_latest()[0] == 1

    def test_empty_directory_rejected(self, tmp_path):
        assert _mgr(tmp_path).load_latest() is None
        with pytest.raises(CheckpointError):
            CheckpointManager("")

    def test_nonwriter_rank_skips_write(self, tmp_path):
        m = _mgr(tmp_path, process_index=1)
        assert m.save(1, {"x": 1}, "one") is None
        assert m.load_latest() is None

    def test_barrier_brackets_the_write(self, tmp_path):
        calls = []
        m = _mgr(tmp_path, barrier=lambda: calls.append(
            sorted(os.listdir(tmp_path / "ck"))
            if (tmp_path / "ck").exists() else None))
        m.save(1, {"x": 1}, "one")
        assert calls == [None, ["ckpt_0000001.lgbckpt"]]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_files_cross_load(tmp_path, writer):
    """A file written by either package's CheckpointManager loads in the
    other's, with equal state and model text (same explicit digest)."""
    classes = {"jax": JaxCheckpointManager, "torch": CheckpointManager}
    reader = "torch" if writer == "jax" else "jax"
    st = _state(4)
    _mgr(tmp_path, classes[writer], params_digest="d1").save(
        3, st, "tree\nTree=0\n")
    it, got, model = _mgr(tmp_path, classes[reader],
                          params_digest="d1").load_latest()
    assert (it, model) == (3, "tree\nTree=0\n")
    _assert_states_equal(got, st)
    assert _mgr(tmp_path, classes[reader],
                params_digest="d2").load_latest() is None


# -- the configuration digest -------------------------------------------

def test_ignored_config_fields_match_the_jax_package():
    from lightgbm_tpu.compile import signature as jsig
    from lightgbm_tpu_torch.compile import signature as tsig
    assert tsig._IGNORED_CONFIG_FIELDS == jsig._IGNORED_CONFIG_FIELDS


def test_checkpoint_fields_do_not_change_the_digest(tmp_path):
    from lightgbm_tpu_torch.compile import signature as S
    a = tlgb.Config.from_params({"objective": "binary"})
    b = tlgb.Config.from_params({
        "objective": "binary", "checkpoint_dir": str(tmp_path),
        "checkpoint_interval": 7, "checkpoint_keep": 5, "hang_timeout": 3,
        "auto_resume": True, "numeric_sentinels": True})
    assert S.config_signature(a) == S.config_signature(b)
    assert S._digest(S.config_signature(a)) == \
        S._digest(S.config_signature(b))


def test_card_checkpoint_is_refused_by_a_cpu_resume(tmp_path):
    """``device_type`` is in the digest: a checkpoint written with
    ``cuda`` is skipped by a ``cpu`` run, which trains from scratch."""
    from lightgbm_tpu_torch.compile import signature as S

    def digest(dev):
        return S._digest(S.config_signature(tlgb.Config.from_params(
            {"objective": "binary", "device_type": dev})))
    assert digest("cuda") != digest("cpu")
    X, y = _make_data()
    d = str(tmp_path / "ck")
    params = dict(BASE, device_type="cpu")
    _train(tlgb, params, X, y, 4, d)
    it, st, model = CheckpointManager(d).load_latest()
    for name in os.listdir(d):
        os.remove(os.path.join(d, name))
    # the same state, as a run on the card would have written it
    _mgr(tmp_path, params_digest=digest("cuda")).save(it, st, model)
    assert _mgr(tmp_path, params_digest=digest("cpu")).load_latest() is None
    resumed = _train(tlgb, params, X, y, 6, d)
    assert resumed.model_to_string() == _train(tlgb, params, X, y, 6
                                               ).model_to_string()
    # the refused file stays; the run wrote its own beside it
    assert len(os.listdir(d)) == 2


# -- resume bit-identity, against the JAX package -----------------------

def _make_data(n=400, f=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (1.2 * X[:, 0] - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


BASE = {"objective": "binary", "verbose": -1, "min_data_in_leaf": 5,
        "checkpoint_interval": 2}

RESUME_CASES = {
    "fused": {},
    "host_loop": {"tpu_fused": False},
    "quantized": {"use_quantized_grad": True},
    "dart": {"boosting": "dart", "drop_rate": 0.5},
    "bagging_feature_fraction": {"bagging_fraction": 0.7, "bagging_freq": 1,
                                 "feature_fraction": 0.6, "seed": 9},
    "goss": {"boosting": "goss", "learning_rate": 0.5},
    "extra_trees": {"tpu_fused": False, "extra_trees": True,
                    "feature_fraction": 0.8},
    "multiclass": {"objective": "multiclass", "num_class": 3},
}


def _labels(params, y, X):
    """Three classes for multiclass (terciles of a score), else y."""
    if params.get("objective") == "multiclass":
        s = X[:, 0] - 0.5 * X[:, 1]
        return np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(float)
    return y


def _train(lib, params, X, y, rounds, ckpt_dir=None, **kw):
    p = dict(params)
    if lib is jlgb:
        p.pop("device_type", None)
    else:
        p.setdefault("device_type", "cpu")
    return lib.train(p, lib.Dataset(X, label=_labels(p, y, X)),
                     num_boost_round=rounds, verbose_eval=False,
                     checkpoint_dir=ckpt_dir, **kw)


def _text(booster) -> str:
    """The model text but its ``device_type`` parameter line (the
    packages' defaults differ: tpu and cuda)."""
    return "\n".join(ln for ln in booster.model_to_string().splitlines()
                     if not ln.startswith("[device_type"))


_JAX_TEXT = {}


def jax_text(case, params, X, y, rounds, plan=None):
    """The JAX package's model text of a case, trained once per process."""
    if case not in _JAX_TEXT:
        from lightgbm_tpu.robust import install_plan as jinstall
        jinstall(plan)
        try:
            _JAX_TEXT[case] = _text(_train(jlgb, params, X, y, rounds))
        finally:
            jinstall(None)
    return _JAX_TEXT[case]


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bit_identical(tmp_path, case):
    """Half the rounds into a checkpoint directory, then all of them in
    a second train() call: the resumed model text equals the
    uninterrupted run's byte for byte, and that text equals the JAX
    package's."""
    X, y = _make_data()
    params = dict(BASE, **RESUME_CASES[case])
    d = str(tmp_path / "ck")
    _train(tlgb, params, X, y, 3, d)
    assert sorted(os.listdir(d)) == ["ckpt_0000001.lgbckpt"]
    resumed = _train(tlgb, params, X, y, 6, d)
    fresh = _train(tlgb, params, X, y, 6)
    assert resumed.model_to_string() == fresh.model_to_string()
    assert _text(fresh) == jax_text(case, params, X, y, 6)


def test_fused_resume_restores_the_lane_order(tmp_path):
    """The persistent state's lanes are restored as saved (not rebuilt
    in row order): the resumed state's rowid and score planes equal the
    uninterrupted run's at the same iteration."""
    X, y = _make_data()
    params = dict(BASE, device_type="cpu")
    d = str(tmp_path / "ck")
    straight = _train(tlgb, params, X, y, 4, keep_training_booster=True)
    _train(tlgb, params, X, y, 4, d)
    ds = tlgb.Dataset(X, label=y)
    resumed = tlgb.Booster(params=dict(params), train_set=ds)
    it, st, model = CheckpointManager(d).load_latest()
    resumed._gbdt.restore_checkpoint_state(st["gbdt"], model)
    rowid, bits = straight._gbdt._fused.persistent_lane_state(
        straight._gbdt._fused_state)
    assert it == 3 and not np.array_equal(rowid[:400], np.arange(400))
    r2, b2 = resumed._gbdt._fused.persistent_lane_state(
        resumed._gbdt._fused_state)
    assert np.array_equal(rowid, r2) and np.array_equal(bits, b2)
    # every plane but the grad / hess ones (dead between iterations)
    Ly = straight._gbdt._fused.layout
    live = [p for p in range(Ly.num_planes) if p not in (Ly.grad, Ly.hess)]
    assert torch.equal(straight._gbdt._fused_state[live],
                       resumed._gbdt._fused_state[live])


def test_early_stopping_resume(tmp_path):
    X, y = _make_data(600)
    Xv, yv = _make_data(200, seed=8)
    params = dict(BASE, metric="binary_logloss")

    def run(lib, ckpt_dir, rounds):
        p = dict(params) if lib is jlgb else dict(params, device_type="cpu")
        ds = lib.Dataset(X, label=y)
        ev = {}
        bst = lib.train(p, ds, num_boost_round=rounds,
                        valid_sets=[ds.create_valid(Xv, label=yv)],
                        valid_names=["v"], early_stopping_rounds=3,
                        evals_result=ev, verbose_eval=False,
                        checkpoint_dir=ckpt_dir)
        return bst, ev

    d = str(tmp_path / "ck")
    run(tlgb, d, 5)
    resumed, ev_r = run(tlgb, d, 12)
    fresh, ev_f = run(tlgb, None, 12)
    assert resumed.model_to_string() == fresh.model_to_string()
    assert resumed.best_iteration == fresh.best_iteration
    # the recorder's history came back with the checkpoint
    assert ev_r == ev_f
    np.testing.assert_array_equal(resumed.predict(Xv), fresh.predict(Xv))
    jax_bst, ev_j = run(jlgb, None, 12)
    assert _text(fresh) == _text(jax_bst)
    assert fresh.best_iteration == jax_bst.best_iteration
    # the metric values: within 1e-6 (their last bits are no gate here)
    np.testing.assert_allclose(ev_f["v"]["binary_logloss"],
                               ev_j["v"]["binary_logloss"], rtol=1e-6)


def test_init_model_wins_over_resume(tmp_path):
    X, y = _make_data()
    d = str(tmp_path / "ck")
    params = dict(BASE, device_type="cpu")
    base = tlgb.train(dict(params), tlgb.Dataset(X, label=y,
                                                 free_raw_data=False),
                      num_boost_round=4, verbose_eval=False,
                      checkpoint_dir=d)
    cont = tlgb.train(dict(params), tlgb.Dataset(X, label=y,
                                                 free_raw_data=False),
                      num_boost_round=2, init_model=base,
                      verbose_eval=False, checkpoint_dir=d)
    # resume skipped: 4 init + 2 new trees, not 4 + (8 - 4)
    assert cont.num_trees() == 6


# -- the checkpoint_dir param and the CLI -------------------------------

def test_checkpoint_dir_param_writes_and_resumes(tmp_path):
    """``train({"checkpoint_dir": d, ...})`` writes the JAX package's
    ``*.lgbckpt`` files (keep 2) and a second call resumes from them."""
    X, y = _make_data()
    d = str(tmp_path / "ck")
    params = dict(BASE, device_type="cpu", checkpoint_dir=d)
    _train(tlgb, params, X, y, 6)
    assert sorted(os.listdir(d)) == ["ckpt_0000003.lgbckpt",
                                     "ckpt_0000005.lgbckpt"]
    it, st, model = CheckpointManager(d).load_latest()
    assert it == 5 and st["gbdt"]["iter"] == 6
    assert "checkpoint" not in model
    again = _train(tlgb, params, X, y, 8)
    assert again.model_to_string() == _train(
        tlgb, dict(BASE, device_type="cpu"), X, y, 8).model_to_string()


def test_cli_checkpoint_flags_resume(tmp_path):
    import lightgbm_tpu_torch.cli as tcli
    X, y = _make_data()
    csv = tmp_path / "train.csv"
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    d = tmp_path / "ck"

    def run(rounds, out, *extra):
        argv = ["task=train", f"data={csv}", "label_column=0",
                "objective=binary", "device_type=cpu", "verbose=-1",
                "min_data_in_leaf=5", f"num_iterations={rounds}",
                f"output_model={tmp_path / out}", *extra]
        assert tcli.main(argv) == 0
        return (tmp_path / out).read_text()
    run(3, "m3.txt", "--checkpoint-dir", str(d),
        "--checkpoint-interval=1")
    assert sorted(os.listdir(d)) == ["ckpt_0000001.lgbckpt",
                                     "ckpt_0000002.lgbckpt"]
    resumed = run(6, "m6.txt", f"checkpoint_dir={d}", "checkpoint_interval=1")
    fresh = run(6, "fresh.txt")
    def strip(text):
        return [ln for ln in text.splitlines() if "output_model" not in ln]
    assert "[checkpoint" not in resumed
    assert strip(resumed) == strip(fresh)


# -- chaos: SIGKILL a real training process, resume it ------------------

_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import lightgbm_tpu_torch as lgb
    assert "jax" not in sys.modules
    rng = np.random.RandomState(3)
    X = rng.randn(400, 5)
    y = (1.2 * X[:, 0] - X[:, 1] + 0.3 * rng.randn(400) > 0).astype(float)
    params = {"objective": "binary", "verbose": -1, "min_data_in_leaf": 5,
              "checkpoint_interval": 2, "device_type": "cpu"}
    bst = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=6,
                    verbose_eval=False, checkpoint_dir=sys.argv[1])
    assert "jax" not in sys.modules
    with open(sys.argv[2], "w") as fh:
        fh.write(bst.model_to_string())
""")


def test_chaos_sigkill_resume_is_bit_identical(tmp_path):
    """A child process importing only the port is killed entering
    iteration 4 (SIGKILL: no atexit, no flush), a second one resumes
    from the surviving checkpoints, and its model text equals the
    uninterrupted run's byte for byte."""
    d = str(tmp_path / "ck")
    out = str(tmp_path / "model.txt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               LGBM_TPU_FAULT_PLAN="train.iteration:sigkill@4")
    proc = subprocess.run([sys.executable, "-c", _CHILD, d, out],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert not os.path.exists(out)
    assert sorted(os.listdir(d)) == ["ckpt_0000001.lgbckpt",
                                     "ckpt_0000003.lgbckpt"]
    env.pop("LGBM_TPU_FAULT_PLAN")
    proc = subprocess.run([sys.executable, "-c", _CHILD, d, out],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    with open(out) as fh:
        resumed = fh.read()
    X, y = _make_data()
    assert resumed == _train(tlgb, dict(BASE, device_type="cpu"), X, y,
                             6).model_to_string()
