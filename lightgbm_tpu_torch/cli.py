"""Command-line application: train / predict / convert_model / refit /
warmup.

The port of the JAX package's CLI (reference
src/application/application.cpp: argv + config-file parsing :49-82,
task dispatch, InitTrain :164 with snapshotting, Predict :213; the
reference's src/main.cpp). Usage mirrors the reference binary:

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

Data files go through ``io/text_loader.py``; the booster runs on the
card unless the parameters say ``device_type=cpu``. ``--checkpoint-dir``
/ ``--checkpoint-interval`` (the keys ``checkpoint_dir`` /
``checkpoint_interval``) checkpoint the training, and a rerun resumes
from the newest valid checkpoint (engine.py ``train``). The
observability flags ``--metrics-out``, ``--trace-out``,
``--profile-dir``, ``--metrics-interval``, ``--obs-port`` and
``--flight-dir`` (the keys ``metrics_file``, ``trace_file``,
``profile_dir``, ``metrics_interval``, ``obs_port``, ``flight_dir``)
turn on the training's telemetry (obs/), and

    python -m lightgbm_tpu_torch trace-report trace.json [--top N]
        [--merge r0.json r1.json ... --out merged.json] [--flight DIR]

summarizes a trace (obs/report.py).

    python -m lightgbm_tpu_torch warmup config=train.conf

(or ``task=warmup``) builds the Dataset and Booster as ``task=train``
would and builds every kernel library of ops/cuda.py into the build
directory, so a later ``task=train`` process finds them by their hash
instead of building them (compile/warmup.py ``run_warmup``).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from .config import Config
from .utils import log

# GNU-style flags accepted alongside the reference's key=value args
# (both `--flag value` and `--flag=value`), as in the JAX package
_FLAG_PARAMS = {
    "--metrics-out": "metrics_file",
    "--profile-dir": "profile_dir",
    "--trace-out": "trace_file",
    "--metrics-interval": "metrics_interval",
    "--conf": "config",
    "--checkpoint-dir": "checkpoint_dir",
    "--checkpoint-interval": "checkpoint_interval",
    "--obs-port": "obs_port",
    "--flight-dir": "flight_dir",
}

# bare subcommand words accepted as the first argument
_SUBCOMMANDS = {"train", "predict", "convert_model", "refit", "warmup"}


def parse_args(argv: List[str]) -> Dict[str, str]:
    """key=value args + config= file (reference application.cpp:49-82;
    Config::KV2Map/Str2Map), plus the GNU-style flags."""
    params: Dict[str, str] = {}
    if argv and argv[0] in _SUBCOMMANDS:
        params["task"] = argv[0]
        argv = argv[1:]
    i = 0
    while i < len(argv):
        arg = argv[i]
        flag, eq, flag_val = arg.partition("=")
        if flag in _FLAG_PARAMS:
            if not eq:
                if i + 1 >= len(argv):
                    log.warning("Flag %s expects a value, ignored", flag)
                    i += 1
                    continue
                i += 1
                flag_val = argv[i]
            params[_FLAG_PARAMS[flag]] = flag_val.strip()
            i += 1
            continue
        i += 1
        if "=" not in arg:
            log.warning("Unknown argument %s, ignored", arg)
            continue
        key, val = arg.split("=", 1)
        params[key.strip()] = val.strip()
    cfg_file = params.get("config", params.get("config_file", ""))
    if cfg_file:
        file_params: Dict[str, str] = {}
        with open(cfg_file) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                key, val = line.split("=", 1)
                file_params[key.strip()] = val.strip()
        # CLI args take precedence over config file (reference :78-80)
        file_params.update(params)
        params = file_params
    return params


def run_train(config: Config, params: Dict[str, str]) -> None:
    import lightgbm_tpu_torch as lgb
    from .engine import _ensure_network

    # the network keys (num_machines, machines, time_out) set up the
    # process group before any dataset is built, as train() does
    _ensure_network(params)
    train_set = lgb.Dataset(config.data, params=dict(params))
    valid_sets = []
    valid_names = []
    for vf in config.valid:
        valid_sets.append(train_set.create_valid(vf))
        valid_names.append(os.path.basename(vf))

    callbacks = []
    if config.snapshot_freq > 0:
        out_model = config.output_model

        def snapshot_cb(env):
            if (env.iteration + 1) % config.snapshot_freq == 0:
                path = f"{out_model}.snapshot_iter_{env.iteration + 1}"
                env.model.save_model(path)
                log.info("Saved snapshot to %s", path)
        snapshot_cb.order = 50
        callbacks.append(snapshot_cb)

    booster = lgb.train(
        dict(params), train_set,
        num_boost_round=config.num_iterations,
        valid_sets=valid_sets or None, valid_names=valid_names or None,
        init_model=config.input_model if config.input_model else None,
        early_stopping_rounds=config.early_stopping_round or None,
        verbose_eval=max(config.metric_freq, 1),
        callbacks=callbacks or None)
    booster.save_model(config.output_model)
    log.info("Finished training, model saved to %s", config.output_model)


def run_predict(config: Config, params: Dict[str, str]) -> None:
    import lightgbm_tpu_torch as lgb
    from .io.text_loader import load_text_file

    if not config.input_model:
        log.fatal("task=predict requires input_model")
    booster = lgb.Booster(model_file=config.input_model, params=dict(params))
    mat, _, _, _, _ = load_text_file(config.data, config)
    preds = booster.predict(
        mat, raw_score=config.predict_raw_score,
        pred_leaf=config.predict_leaf_index,
        pred_contrib=config.predict_contrib,
        start_iteration=config.start_iteration_predict,
        num_iteration=config.num_iteration_predict)
    preds = np.atleast_2d(np.asarray(preds))
    if preds.shape[0] == 1:
        preds = preds.T
    with open(config.output_result, "w") as fh:
        for row in preds:
            fh.write("\t".join(f"{v:g}" for v in np.atleast_1d(row)) + "\n")
    log.info("Finished prediction, results saved to %s", config.output_result)


def run_convert_model(config: Config, params: Dict[str, str]) -> None:
    """Model -> standalone C++ if-else code (reference
    gbdt_model_text.cpp:127 SaveModelToIfElse; ``models/codegen.py``)."""
    import lightgbm_tpu_torch as lgb
    from .models.codegen import model_to_cpp

    if not config.input_model:
        log.fatal("task=convert_model requires input_model")
    booster = lgb.Booster(model_file=config.input_model, params=dict(params))
    code = model_to_cpp(booster._gbdt)
    with open(config.convert_model, "w") as fh:
        fh.write(code)
    log.info("Converted model saved to %s", config.convert_model)


def run_refit(config: Config, params: Dict[str, str]) -> None:
    """reference application.cpp refit task :214-239."""
    import lightgbm_tpu_torch as lgb
    from .io.text_loader import load_text_file

    if not config.input_model:
        log.fatal("task=refit requires input_model")
    booster = lgb.Booster(model_file=config.input_model,
                          params=dict(params))
    mat, label, _, _, _ = load_text_file(config.data, config)
    new_booster = booster.refit(mat, label,
                                decay_rate=config.refit_decay_rate)
    new_booster.save_model(config.output_model)
    log.info("Finished refit, model saved to %s", config.output_model)


def run_warmup_task(config: Config, params: Dict[str, str]) -> None:
    """Build every kernel library the configured training needs, so the
    next ``task=train`` process loads them instead of building them."""
    from .compile.warmup import run_warmup

    summary = run_warmup(config, params)
    log.info("Warm-up built %d/%d kernel libraries in %.1fs (build "
             "directory: %s)", summary["compiled"], summary["entries"],
             summary["seconds"], summary["build_dir"])


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "trace-report":
        # a file-analysis subcommand: no Config, no device
        from .obs.report import main as report_main
        return report_main(argv[1:])
    params = parse_args(argv)
    config = Config.from_params(params)
    try:
        if config.task == "train":
            run_train(config, params)
        elif config.task in ("predict", "prediction", "test"):
            run_predict(config, params)
        elif config.task == "convert_model":
            run_convert_model(config, params)
        elif config.task == "refit":
            run_refit(config, params)
        elif config.task == "warmup":
            run_warmup_task(config, params)
        else:
            log.fatal("Unknown task %s", config.task)
    except Exception as e:  # mirror main.cpp catch-all
        print(f"Met Exceptions:\n{e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
