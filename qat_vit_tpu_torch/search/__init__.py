"""Hyperparameter search: TPE sampler + median pruner + the Optuna-shaped
driver (port of ``qat_vit_tpu/search``; optuna itself is used where it is
installed, the in-repo TPE engine otherwise)."""

from qat_vit_tpu_torch.search.driver import (
    HAS_OPTUNA,
    SearchConfig,
    run_optuna_search,
    suggest_hparams,
)
from qat_vit_tpu_torch.search.tpe import (
    MedianPruner,
    Study,
    TPESampler,
    Trial,
    TrialPruned,
    create_study,
)

__all__ = [
    "HAS_OPTUNA",
    "MedianPruner",
    "SearchConfig",
    "Study",
    "TPESampler",
    "Trial",
    "TrialPruned",
    "create_study",
    "run_optuna_search",
    "suggest_hparams",
]
