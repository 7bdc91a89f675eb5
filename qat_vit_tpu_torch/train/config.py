"""Three-tier hyperparameter config: defaults → YAML overlay → overrides (a
copy of ``qat_vit_tpu/train/config.py``: framework-free).

The same ``DEFAULT_HPARAMS`` as the JAX package, so one ``best_params.yaml``
configures either trainer; ``pyyaml`` is imported only when an overlay is
read. The CLI flags (``add_hparam_flags``) and the persisted
``effective_hparams.yaml`` come with the trainer CLI (ROADMAP.md Queue 1,
item 6); :func:`resolve_hparams` takes any object with the flags as
attributes.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

# The reference's DEFAULT_HPARAMS (qat_trainer.py:36-46) + the JAX package's
# additions, value for value (the JAX file documents each one). Keys the port
# does not act on yet are kept so one YAML configures either trainer.
DEFAULT_HPARAMS: Dict[str, Any] = {
    "lr": 1.5e-4,
    "weight_decay": 1e-3,
    "label_smoothing": 0.1,
    "kd_temperature": 4.0,
    "kd_alpha": 0.5,
    "qat_start_epoch": 2,
    "epochs": 10,
    "batch_size": 256,
    "qat_backend": "qnnpack",
    "qat_lr_scale": 0.5,  # LR x 0.5 at the QAT switch
    "amp": True,  # bf16 float phase
    "grad_clip_norm": 1.0,
    "seed": 0,
    "image_size": 224,
    "num_classes": 10,
    "eval_batch_size": 512,
    "model_parallel": 1,
    "data_dir": "./data",
    "output_dir": "./qat_output",
    "mlflow_uri": "sqlite:///mlflow.db",
    "experiment": "clue-vit-qat-final",
    "student_family": "vit",
    "limit_train_batches": 0,  # 0 = full epoch
    "limit_eval_batches": 0,
    "resume": "",
    "save_resume_state": True,
    "teacher_ckpt": "",
    "student_ckpt": "",
    "cache_teacher_logits": True,  # the frozen teacher's logits, once per dataset
    "qat_amp": True,  # bf16 matmuls under fake-quant
    "amp_fast_math": True,  # bf16 softmax + tanh-GELU in the bf16 phases
    "observer_interval": 1,
    "observer_stride": 1,
    "progress_bar": False,
    "remat": "none",
    "fq_in_kernel": True,  # the qkv fake-quant inside the attention kernels
    "per_channel_weights": False,
    "profile_dir": "",
    "task": "classification",
    "det_box_weight": 1.0,
    "det_obj_weight": 0.25,
    "num_queries": 4,
    "text_dim": 512,
    # the detection queries' seed (-1: the run's seed); the JAX detection
    # trainer reads it with the same default
    "query_seed": -1,
}

_TYPES = {k: type(v) for k, v in DEFAULT_HPARAMS.items()}

# Reference key spellings accepted on YAML load (the reference's optuna search
# and DEFAULT_HPARAMS call the distillation temperature ``kd_temp``,
# optuna_search.py:135 / qat_trainer.py:40) — a reference-produced
# best_params.yaml must feed this trainer without silent fallback to defaults.
_ALIASES = {"kd_temp": "kd_temperature"}


def _cast(key: str, value: Any) -> Any:
    """Type-normalize a YAML/CLI value to the default's type (ref :87-96)."""
    t = _TYPES.get(key)
    if t is None or value is None:
        return value
    if t is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    try:
        return t(value)
    except (TypeError, ValueError):
        logger.warning("could not cast hparam %s=%r to %s; keeping raw", key, value, t)
        return value


def load_hparams(config_path: Optional[str] = None) -> Dict[str, Any]:
    """defaults → optional flat-YAML overlay with casting (ref :84-109)."""
    hp = dict(DEFAULT_HPARAMS)
    if config_path:
        if os.path.isfile(config_path):
            import yaml  # only for a YAML overlay

            with open(config_path) as f:
                overlay = yaml.safe_load(f) or {}
            if not isinstance(overlay, dict):
                raise ValueError(f"config {config_path!r} must be a flat mapping")
            for k, v in overlay.items():
                k = _ALIASES.get(k, k)
                hp[k] = _cast(k, v)
        else:
            logger.warning("config %s not found; using defaults", config_path)
    return hp


def resolve_hparams(args) -> Dict[str, Any]:
    """defaults → YAML → non-None CLI flags (highest precedence)."""
    hp = load_hparams(getattr(args, "config", None))
    for key in DEFAULT_HPARAMS:
        val = getattr(args, key, None)
        if val is not None:
            hp[key] = _cast(key, val)
    return hp
