"""Flags, then a YAML config file, then the environment, into the
``HOROVOD_*`` knobs the workers read at ``hvd.init()`` (port of
``horovod_tpu/run/config_parser.py``; reference:
horovod/run/common/util/config_parser.py). The precedence is the JAX
package's (reference: run/run.py:422-425, 581-585): a flag given on the
command line overrides the file (``args.seen_args``), and both override
the environment.

It yields only knobs that the port reads (``utils/env.py``). The JAX
package's ``HOROVOD_MESH_SHAPE`` (``--mesh-shape``) has no counterpart: the
port has no device mesh.
"""

from __future__ import annotations

from typing import Optional

# YAML section/key names mirror the reference's config schema
# (reference: config_parser.py constants).
_PARAMS = "params"
_TIMELINE = "timeline"
_AUTOTUNE = "autotune"
_STALL_CHECK = "stall_check"
_LOGGING = "logging"


def parse_config_file(path: str) -> dict:
    import yaml  # only a config file needs it

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must be a YAML mapping")
    return data


def set_args_from_config_file(args, config: dict) -> None:
    """Apply YAML values onto the parsed-args namespace, honoring
    ``args.seen_args``: a flag given on the command line keeps its value
    (reference: run.py:581-585)."""
    seen = getattr(args, "seen_args", set())

    def put(attr, value):
        if attr not in seen and value is not None:
            setattr(args, attr, value)

    params = config.get(_PARAMS, {})
    put("fusion_threshold_mb", params.get("fusion_threshold_mb"))
    put("cycle_time_ms", params.get("cycle_time_ms"))
    put("cache_capacity", params.get("cache_capacity"))
    put("hierarchical_allreduce", params.get("hierarchical_allreduce"))
    put("hierarchical_allgather", params.get("hierarchical_allgather"))

    timeline = config.get(_TIMELINE, {})
    put("timeline_filename", timeline.get("filename"))
    put("timeline_mark_cycles", timeline.get("mark_cycles"))

    autotune = config.get(_AUTOTUNE, {})
    put("autotune", autotune.get("enabled"))
    put("autotune_log_file", autotune.get("log_file"))
    put("autotune_warmup_samples", autotune.get("warmup_samples"))
    put("autotune_steps_per_sample", autotune.get("steps_per_sample"))
    put("autotune_bayes_opt_max_samples",
        autotune.get("bayes_opt_max_samples"))
    put("autotune_gaussian_process_noise",
        autotune.get("gaussian_process_noise"))

    stall = config.get(_STALL_CHECK, {})
    put("no_stall_check",
        None if stall.get("enabled") is None else not stall["enabled"])
    put("stall_check_warning_time_seconds",
        stall.get("warning_time_seconds"))
    put("stall_check_shutdown_time_seconds",
        stall.get("shutdown_time_seconds"))

    logging_cfg = config.get(_LOGGING, {})
    put("log_level", logging_cfg.get("level"))
    put("log_hide_timestamp", logging_cfg.get("hide_timestamp"))


def env_from_args(args) -> dict:
    """Translate parsed args into the HOROVOD_* env contract (reference:
    config_parser.set_env_from_args). Returns only the keys to inject."""
    env: dict = {}

    def put(name: str, value, transform=str):
        if value is not None:
            env[name] = transform(value)

    def put_bool(name: str, value):
        if value:
            env[name] = "1"

    put("HOROVOD_FUSION_THRESHOLD", args.fusion_threshold_mb,
        lambda v: str(int(float(v) * 1024 * 1024)))
    put("HOROVOD_CYCLE_TIME", args.cycle_time_ms)
    put("HOROVOD_CACHE_CAPACITY", args.cache_capacity)
    put_bool("HOROVOD_HIERARCHICAL_ALLREDUCE",
             getattr(args, "hierarchical_allreduce", None))
    put_bool("HOROVOD_HIERARCHICAL_ALLGATHER",
             getattr(args, "hierarchical_allgather", None))

    put("HOROVOD_TIMELINE", getattr(args, "timeline_filename", None))
    put_bool("HOROVOD_TIMELINE_MARK_CYCLES",
             getattr(args, "timeline_mark_cycles", None))

    put_bool("HOROVOD_AUTOTUNE", getattr(args, "autotune", None))
    put("HOROVOD_AUTOTUNE_LOG", getattr(args, "autotune_log_file", None))
    put("HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
        getattr(args, "autotune_warmup_samples", None))
    put("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
        getattr(args, "autotune_steps_per_sample", None))
    put("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
        getattr(args, "autotune_bayes_opt_max_samples", None))
    put("HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
        getattr(args, "autotune_gaussian_process_noise", None))

    put_bool("HOROVOD_STALL_CHECK_DISABLE",
             getattr(args, "no_stall_check", None))
    put("HOROVOD_STALL_CHECK_TIME_SECONDS",
        getattr(args, "stall_check_warning_time_seconds", None))
    put("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
        getattr(args, "stall_check_shutdown_time_seconds", None))

    put("HOROVOD_LOG_LEVEL", getattr(args, "log_level", None))
    put_bool("HOROVOD_LOG_HIDE_TIME",
             getattr(args, "log_hide_timestamp", None))

    put("HOROVOD_FLIGHT_RECORDER_DIR",
        getattr(args, "flight_recorder_dir", None))
    return env


def validate_config_args(args) -> None:
    """Sanity checks mirroring reference validation
    (reference: config_parser.validate_config_args)."""
    fusion = getattr(args, "fusion_threshold_mb", None)
    if fusion is not None and float(fusion) < 0:
        raise ValueError("--fusion-threshold-mb must be >= 0")
    cycle = getattr(args, "cycle_time_ms", None)
    if cycle is not None and float(cycle) <= 0:
        raise ValueError("--cycle-time-ms must be > 0")
    cap: Optional[int] = getattr(args, "cache_capacity", None)
    if cap is not None and int(cap) < 0:
        raise ValueError("--cache-capacity must be >= 0")
