"""Grid, random and adaptive searches over config overrides
(``gotennet_tpu/utils/sweep.py``, numpy only).

Comma-separated values in the overrides expand to a cartesian grid; each
trial runs in its own workdir under ``sweep_dir`` (the sweep owns it), and
``sweep.jsonl`` collects each trial's overrides, results and metric, then
the best trial's overrides.  A trial that fails is recorded with its error
and the sweep goes on.  Distribution expressions drive the random and
adaptive (TPE-style) searches:

    model.lr=loguniform(1e-5,1e-3)   log-uniform float
    model.weight_decay=uniform(0,0.1)
    model.representation.lmax=int(1,3)       inclusive integer range
    model.representation.aggr=choice(add,mean,max)

``cli sweep`` runs them (``sampler=grid|random|adaptive n_trials=N``).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["expand_grid", "run_sweep", "sample_overrides",
           "run_random_search", "run_adaptive_search"]

_DIST_RE = re.compile(r"^(uniform|loguniform|int|choice)\((.*)\)$")


def expand_grid(overrides: List[str]) -> List[List[str]]:
    """['a=1,2', 'b=x'] -> [['a=1','b=x'], ['a=2','b=x']]."""
    axes: List[List[str]] = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        values = raw.split(",") if "," in raw else [raw]
        axes.append([f"{key}={v}" for v in values])
    return [list(combo) for combo in itertools.product(*axes)]


def sample_overrides(overrides: List[str],
                     rng: np.random.Generator) -> List[str]:
    """Sample one trial: distribution expressions are drawn, plain
    values pass through verbatim."""
    out = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        m = _DIST_RE.match(raw.strip())
        if not m:
            out.append(ov)
            continue
        kind, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        if kind == "uniform":
            lo, hi = float(args[0]), float(args[1])
            val = float(rng.uniform(lo, hi))
        elif kind == "loguniform":
            lo, hi = math.log(float(args[0])), math.log(float(args[1]))
            val = float(math.exp(rng.uniform(lo, hi)))
        elif kind == "int":
            lo, hi = int(args[0]), int(args[1])
            val = int(rng.integers(lo, hi + 1))
        else:  # choice
            val = args[int(rng.integers(0, len(args)))]
        out.append(f"{key}={val}")
    return out


def _run_trials(train_fn, load_cfg, trials, sweep_dir, metric,
                out: Optional[list] = None):
    """``trials`` may be a list or a lazy generator (adaptive search
    reads completed results from ``out`` between yields)."""
    os.makedirs(sweep_dir, exist_ok=True)
    summary_path = os.path.join(sweep_dir, "sweep.jsonl")
    out = [] if out is None else out
    best = None
    with open(summary_path, "a") as summary:
        for idx, trial in enumerate(trials):
            # the sweep owns each trial's workdir: drop any caller- or
            # sampler-supplied workdir override so the recorded
            # overrides (and best_overrides) are replayable as-is
            trial = [ov for ov in trial
                     if ov.partition("=")[0] != "workdir"]
            workdir = os.path.join(sweep_dir, f"trial_{idx}")
            cfg = load_cfg(trial + [f"workdir={workdir}"])
            rec: Dict = {"trial": idx, "overrides": trial}
            try:
                results = train_fn(cfg)
                rec["results"] = results
                if metric and metric in results:
                    rec["metric"] = results[metric]
                    if best is None or results[metric] < best[1]:
                        best = (trial, results[metric])
            except Exception as e:  # keep the sweep alive
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["traceback"] = traceback.format_exc(limit=5)
                results = {}
            summary.write(json.dumps(rec) + "\n")
            summary.flush()
            out.append((trial, results))
        if best is not None:
            summary.write(json.dumps(
                {"best_overrides": best[0], "best_metric": best[1],
                 "metric_name": metric}) + "\n")
    return out


def run_random_search(train_fn: Callable[[Dict], Dict],
                      load_cfg: Callable, overrides: List[str],
                      n_trials: int, seed: int = 0,
                      sweep_dir: str = "runs/sweep",
                      metric: Optional[str] = None):
    """Random search over distribution expressions in ``overrides``
    (minimizing ``metric``); the best trial is appended to sweep.jsonl.
    """
    rng = np.random.default_rng(seed)
    trials = [sample_overrides(overrides, rng) for _ in range(n_trials)]
    return _run_trials(train_fn, load_cfg, trials, sweep_dir, metric)


def _tpe_sample(overrides: List[str], done, metric_values,
                rng: np.random.Generator, gamma: float = 0.25,
                n_candidates: int = 24) -> List[str]:
    """One TPE-style draw: completed trials split into the best
    ``gamma`` fraction ("good") and the rest; numeric params pick the candidate maximizing the Parzen
    density ratio l_good/l_bad in the distribution's transformed
    space, categorical params sample by smoothed good-trial
    frequency."""
    order = np.argsort(metric_values)
    n_good = max(1, int(math.ceil(gamma * len(done))))
    good_idx = set(order[:n_good].tolist())

    def values_for(key, idx_set):
        vals = []
        for i, trial in enumerate(done):
            if i not in idx_set:
                continue
            for ov in trial:
                k, _, raw = ov.partition("=")
                if k == key:
                    vals.append(raw)
        return vals

    all_idx = set(range(len(done)))
    out = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        m = _DIST_RE.match(raw.strip())
        if not m:
            out.append(ov)
            continue
        kind, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        good_raw = values_for(key, good_idx)
        bad_raw = values_for(key, all_idx - good_idx)
        if kind == "choice":
            counts = {c: 1.0 for c in args}  # +1 smoothing
            for v in good_raw:
                counts[v] = counts.get(v, 1.0) + 1.0
            names = list(counts)
            p = np.asarray([counts[c] for c in names])
            out.append(f"{key}={names[rng.choice(len(names), p=p/p.sum())]}")
            continue
        lo, hi = float(args[0]), float(args[1])
        log = kind == "loguniform"
        tf = (lambda x: math.log(x)) if log else (lambda x: x)
        t_lo, t_hi = tf(lo), tf(hi)
        good = np.asarray([tf(float(v)) for v in good_raw])
        bad = np.asarray([tf(float(v)) for v in bad_raw])
        span = t_hi - t_lo
        bw = max(float(good.std()) if len(good) > 1 else span / 8,
                 span / 20)

        def parzen(x, obs):
            if len(obs) == 0:
                return 1.0 / span  # uniform prior
            d = (x - obs) / bw
            return float(np.mean(np.exp(-0.5 * d * d))) / bw + 1e-12

        # candidates from the good mixture (plus one uniform explore)
        centers = good[rng.integers(0, len(good), n_candidates - 1)]
        cands = np.clip(centers + rng.normal(0, bw, n_candidates - 1),
                        t_lo, t_hi)
        cands = np.concatenate([cands, [rng.uniform(t_lo, t_hi)]])
        scores = [parzen(c, good) / parzen(c, bad) for c in cands]
        best = float(cands[int(np.argmax(scores))])
        val = math.exp(best) if log else best
        if kind == "int":
            val = int(round(val))
            val = min(max(val, int(args[0])), int(args[1]))
        out.append(f"{key}={val}")
    return out


def run_adaptive_search(train_fn: Callable[[Dict], Dict],
                        load_cfg: Callable, overrides: List[str],
                        n_trials: int, seed: int = 0,
                        sweep_dir: str = "runs/sweep",
                        metric: Optional[str] = None,
                        n_startup: Optional[int] = None,
                        gamma: float = 0.25):
    """Sequential adaptive (TPE-style) search minimizing ``metric``:
    random warmup, then each trial is drawn from the density-ratio
    model over completed trials."""
    rng = np.random.default_rng(seed)
    startup = n_startup if n_startup is not None else max(
        4, n_trials // 5)
    history: list = []

    def gen():
        for _ in range(n_trials):
            done = [(t, r) for t, r in history
                    if metric and r and metric in r]
            if len(done) < startup:
                yield sample_overrides(overrides, rng)
            else:
                trials = [t for t, _ in done]
                vals = np.asarray([r[metric] for _, r in done])
                yield _tpe_sample(overrides, trials, vals, rng, gamma)

    return _run_trials(train_fn, load_cfg, gen(), sweep_dir, metric,
                       out=history)


def run_sweep(train_fn: Callable[[Dict], Dict], load_cfg: Callable,
              overrides: List[str], sweep_dir: str = "runs/sweep",
              metric: Optional[str] = None) -> List[Tuple[List[str], Dict]]:
    """Run the cartesian grid; returns [(trial_overrides, results)].

    ``train_fn(cfg) -> results dict``; ``load_cfg(extra_overrides)``
    builds a config from base + trial overrides.
    """
    return _run_trials(train_fn, load_cfg, expand_grid(overrides),
                       sweep_dir, metric)
