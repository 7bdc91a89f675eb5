"""In-repo hyperparameter optimization: TPE sampler + median pruner + study
(port of ``qat_vit_tpu/search/tpe.py``, numpy only, so the port keeps its own
copy: the same suggestions and prune decisions for the same seed and
history, univariate and multivariate).

The reference drives its search with Optuna (``TPESampler(multivariate=True,
seed=0)`` + ``MedianPruner(n_startup_trials=5, n_warmup_steps=1)``, reference
src/training/optuna_search.py:127-129). Where optuna is not installed, the
same contract is implemented here: a Tree-structured Parzen Estimator
sampler (Bergstra et al., NeurIPS 2011 — independent Parzen windows per
dimension, log-domain support, γ-quantile good/bad split, argmax of
l(x)/g(x) over candidates), a median pruner with startup/warmup gates, and a
Study/Trial API shaped like Optuna's so the search driver code reads
identically. Where optuna IS importable, the search driver uses it instead
(see search/driver.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np


class TrialPruned(Exception):
    """Raised inside an objective to abort an unpromising trial."""


@dataclasses.dataclass
class ParamSpec:
    name: str
    low: float
    high: float
    log: bool = False
    integer: bool = False

    def to_internal(self, v: float) -> float:
        return math.log(v) if self.log else float(v)

    def from_internal(self, u: float) -> float:
        v = math.exp(u) if self.log else u
        v = min(max(v, self.low), self.high)
        return int(round(v)) if self.integer else v

    @property
    def internal_bounds(self):
        if self.log:
            return math.log(self.low), math.log(self.high)
        return self.low, self.high


@dataclasses.dataclass
class FrozenTrial:
    number: int
    params: Dict[str, float]
    value: Optional[float] = None
    state: str = "RUNNING"  # RUNNING / COMPLETE / PRUNED / FAIL
    intermediate: Dict[int, float] = dataclasses.field(default_factory=dict)


class MedianPruner:
    """Prune when the intermediate value is below the median of completed
    trials' values at the same step (maximize direction), after
    ``n_startup_trials`` completed trials and ``n_warmup_steps`` steps —
    optuna's MedianPruner semantics (reference optuna_search.py:128-129)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 1):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, study: "Study", trial: FrozenTrial) -> bool:
        if not trial.intermediate:
            return False
        step = max(trial.intermediate)
        if step < self.n_warmup_steps:
            return False
        completed = [t for t in study.trials if t.state == "COMPLETE"]
        if len(completed) < self.n_startup_trials:
            return False
        peers = [t.intermediate[step] for t in completed if step in t.intermediate]
        if not peers:
            return False
        median = float(np.median(peers))
        sign = 1.0 if study.direction == "maximize" else -1.0
        return sign * trial.intermediate[step] < sign * median


class TPESampler:
    """TPE with optuna-like defaults; univariate by default (measured).

    good/bad split uses optuna's γ: ``min(ceil(0.1·n), 25)`` top trials;
    Parzen bandwidths follow a scaled Silverman rule with a prior-width
    floor; 24 candidates are drawn from l(x) and ranked by l(x)/g(x).

    ``multivariate=True`` samples the whole parameter VECTOR jointly
    (optuna's ``multivariate=True``, the reference's setting,
    optuna_search.py:127): candidates are good-set rows perturbed
    per-dimension and ranked by a row-wise product-kernel (joint Parzen).
    Default is ``False``, as in the JAX package, which settled it by a
    full-search A/B of the two samplers (its ``scripts/tpe_ab.py``: the
    joint variant lost on every seed; global-σ bandwidths inflate under
    multimodal good sets and wash out the pairing the joint kernel is meant
    to preserve). Where optuna is installed the search driver uses optuna's
    own multivariate TPE (the reference's exact configuration); this default
    governs only the in-repo sampler.
    """

    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 n_candidates: int = 24, multivariate: bool = False):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.multivariate = multivariate

    def _uniform(self, spec: ParamSpec) -> float:
        lo, hi = spec.internal_bounds
        return spec.from_internal(float(self.rng.uniform(lo, hi)))

    def sample(self, study: "Study", spec: ParamSpec) -> float:
        history = [
            (t.params[spec.name], t.value)
            for t in study.trials
            if t.state in ("COMPLETE", "PRUNED")
            and spec.name in t.params
            and t.value is not None
        ]
        if len(history) < self.n_startup_trials:
            return self._uniform(spec)

        sign = -1.0 if study.direction == "maximize" else 1.0
        history.sort(key=lambda pv: sign * pv[1])
        n = len(history)
        n_good = min(int(np.ceil(0.1 * n)), 25)
        n_good = max(n_good, 1)
        good = np.array([spec.to_internal(p) for p, _ in history[:n_good]])
        bad = np.array([spec.to_internal(p) for p, _ in history[n_good:]]) \
            if n > n_good else np.array([])

        lo, hi = spec.internal_bounds
        width = hi - lo

        def bandwidth(obs):
            if len(obs) < 2:
                return width / 3.0
            sigma = np.std(obs) + 1e-12
            return max(sigma * (len(obs) ** -0.2), width / (1.0 + len(obs)))

        bw_g, bw_b = bandwidth(good), bandwidth(bad)

        def log_pdf(x, centers, bw):
            if len(centers) == 0:
                return np.full_like(x, -np.log(width))  # uniform prior
            # mixture of gaussians + uniform prior component
            d = (x[:, None] - centers[None, :]) / bw
            comp = -0.5 * d * d - np.log(bw * math.sqrt(2 * math.pi))
            comp = np.concatenate(
                [comp, np.full((len(x), 1), -np.log(width))], axis=1
            )
            m = comp.max(axis=1, keepdims=True)
            return (m[:, 0] + np.log(np.exp(comp - m).sum(axis=1))) - math.log(
                comp.shape[1]
            )

        # sample candidates from the good-KDE (plus prior exploration)
        idx = self.rng.integers(0, len(good) + 1, self.n_candidates)
        cands = np.where(
            idx < len(good),
            good[np.minimum(idx, len(good) - 1)]
            + self.rng.normal(0, bw_g, self.n_candidates),
            self.rng.uniform(lo, hi, self.n_candidates),
        )
        cands = np.clip(cands, lo, hi)
        score = log_pdf(cands, good, bw_g) - log_pdf(cands, bad, bw_b)
        return spec.from_internal(float(cands[np.argmax(score)]))

    # -- multivariate path -------------------------------------------------

    def _dim_stats(self, study: "Study", spec: ParamSpec, rows):
        """good/bad internal values + bandwidths for one dimension over the
        shared (already good/bad-sorted) history rows."""
        n = len(rows)
        n_good = max(min(int(np.ceil(0.1 * n)), 25), 1)
        vals = np.array([spec.to_internal(r.params[spec.name]) for r in rows])
        good, bad = vals[:n_good], vals[n_good:]
        lo, hi = spec.internal_bounds
        width = hi - lo

        def bandwidth(obs):
            if len(obs) < 2:
                return width / 3.0
            sigma = np.std(obs) + 1e-12
            return max(sigma * (len(obs) ** -0.2), width / (1.0 + len(obs)))

        return good, bad, bandwidth(good), bandwidth(bad), lo, hi, width

    def sample_joint(
        self, study: "Study", specs: Dict[str, ParamSpec]
    ) -> Optional[Dict[str, float]]:
        """Sample the full parameter vector jointly (optuna multivariate=True
        semantics): each candidate is one good-set ROW perturbed per-dim, so
        cross-parameter structure of the good region is preserved; ranking
        uses the summed per-dim log l/g."""
        names = list(specs)
        rows = [
            t for t in study.trials
            if t.state in ("COMPLETE", "PRUNED") and t.value is not None
            and all(nm in t.params for nm in names)
        ]
        if len(rows) < self.n_startup_trials:
            return None
        sign = -1.0 if study.direction == "maximize" else 1.0
        rows.sort(key=lambda t: sign * t.value)

        per_dim = {nm: self._dim_stats(study, specs[nm], rows) for nm in names}
        n_good = len(per_dim[names[0]][0])
        # candidate rows: a good row index (or the uniform-prior "row")
        row_idx = self.rng.integers(0, n_good + 1, self.n_candidates)
        cand = {}
        for nm in names:
            good, bad, bw_g, bw_b, lo, hi, width = per_dim[nm]
            base = good[np.minimum(row_idx, n_good - 1)]
            noise = self.rng.normal(0, bw_g, self.n_candidates)
            uniform = self.rng.uniform(lo, hi, self.n_candidates)
            cand[nm] = np.clip(
                np.where(row_idx < n_good, base + noise, uniform), lo, hi)

        def joint_log_pdf(which: int) -> np.ndarray:
            """True multivariate Parzen: product kernel per ROW, logsumexp
            over rows (+ a uniform prior component) — this is what preserves
            cross-parameter correlation, unlike pooled per-dim marginals."""
            comp = None
            prior = 0.0
            for nm in names:
                good, bad, bw_g, bw_b, lo, hi, width = per_dim[nm]
                centers = good if which == 0 else bad
                bw = bw_g if which == 0 else bw_b
                prior += -math.log(width)
                if len(centers) == 0:
                    continue
                d = (cand[nm][:, None] - centers[None, :]) / bw
                k = -0.5 * d * d - math.log(bw * math.sqrt(2 * math.pi))
                comp = k if comp is None else comp + k
            if comp is None:
                return np.full(self.n_candidates, prior)
            comp = np.concatenate(
                [comp, np.full((self.n_candidates, 1), prior)], axis=1)
            m = comp.max(axis=1, keepdims=True)
            return (m[:, 0] + np.log(np.exp(comp - m).sum(axis=1))
                    ) - math.log(comp.shape[1])

        score = joint_log_pdf(0) - joint_log_pdf(1)
        best = int(np.argmax(score))
        return {nm: specs[nm].from_internal(float(cand[nm][best])) for nm in names}


class Trial:
    """Optuna-shaped trial handle passed to the objective."""

    def __init__(self, study: "Study", frozen: FrozenTrial):
        self._study = study
        self._frozen = frozen
        self.number = frozen.number
        self._joint_cache: Optional[Dict[str, float]] = None
        self._joint_tried = False

    def _suggest(self, spec: ParamSpec) -> float:
        study = self._study
        study.specs[spec.name] = spec
        sampler = study.sampler
        if getattr(sampler, "multivariate", False):
            if not self._joint_tried:
                self._joint_tried = True
                self._joint_cache = sampler.sample_joint(study, dict(study.specs))
            if self._joint_cache is not None and spec.name in self._joint_cache:
                v = self._joint_cache[spec.name]
                self._frozen.params[spec.name] = v
                return v
        v = sampler.sample(study, spec)
        self._frozen.params[spec.name] = v
        return v

    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        return float(self._suggest(ParamSpec(name, low, high, log=log)))

    def suggest_int(self, name: str, low: int, high: int) -> int:
        return int(self._suggest(ParamSpec(name, low, high, integer=True)))

    def report(self, value: float, step: int) -> None:
        self._frozen.intermediate[step] = float(value)

    def should_prune(self) -> bool:
        return self._study.pruner.should_prune(self._study, self._frozen)

    @property
    def params(self) -> Dict[str, float]:
        return dict(self._frozen.params)


class Study:
    """Optuna-shaped study: ``optimize``, ``best_params``, ``best_value``."""

    def __init__(self, direction: str = "maximize",
                 sampler: Optional[TPESampler] = None,
                 pruner: Optional[MedianPruner] = None):
        assert direction in ("maximize", "minimize")
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or MedianPruner()
        self.trials: List[FrozenTrial] = []
        self.specs: Dict[str, ParamSpec] = {}  # search space seen so far

    def optimize(self, objective: Callable[[Trial], float], n_trials: int,
                 catch: tuple = ()) -> None:
        for _ in range(n_trials):
            frozen = FrozenTrial(number=len(self.trials), params={})
            self.trials.append(frozen)
            trial = Trial(self, frozen)
            try:
                value = objective(trial)
                frozen.value = float(value)
                frozen.state = "COMPLETE"
            except TrialPruned:
                # last reported intermediate becomes the trial value (optuna)
                if frozen.intermediate:
                    frozen.value = frozen.intermediate[max(frozen.intermediate)]
                frozen.state = "PRUNED"
            except catch:
                frozen.state = "FAIL"

    @property
    def best_trial(self) -> FrozenTrial:
        done = [t for t in self.trials if t.state == "COMPLETE"]
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "maximize" else (lambda t: -t.value)
        return max(done, key=key)

    @property
    def best_params(self) -> Dict[str, float]:
        return dict(self.best_trial.params)

    @property
    def best_value(self) -> float:
        return self.best_trial.value


def create_study(direction: str = "maximize", seed: int = 0,
                 n_startup_trials: int = 5, n_warmup_steps: int = 1,
                 multivariate: bool = False) -> Study:
    """Factory with the reference's sampler/pruner settings
    (optuna_search.py:127-129). ``multivariate`` selects joint vector
    sampling (the reference's optuna setting); the in-repo default stays
    univariate, as in the JAX package."""
    return Study(
        direction=direction,
        sampler=TPESampler(seed=seed, multivariate=multivariate),
        pruner=MedianPruner(n_startup_trials, n_warmup_steps),
    )
