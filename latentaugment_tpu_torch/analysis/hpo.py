"""Hyperparameter search harness (counterpart:
latentaugment_tpu/analysis/hpo.py).

`create_study` returns an Optuna study where the package is importable
and otherwise the built-in `SimpleStudy`, with the surface the tuning
script uses: `optimize(objective, n_trials)`, `best_params`,
`trials_dataframe(attrs=...)`, and trials with `suggest_categorical` /
`suggest_float` / `suggest_int` (random sampling from one
`random.Random` seeded by the study's seed and its trial count, so one
seed gives the JAX package's trials). A study pickles and resumes.
"""

import pickle
import random


class SimpleTrial:
    def __init__(self, number, rng):
        self.number = number
        self._rng = rng
        self.params = {}

    def suggest_categorical(self, name, choices):
        value = self._rng.choice(list(choices))
        self.params[name] = value
        return value

    def suggest_float(self, name, low, high, log=False):
        if log:
            import math

            value = math.exp(self._rng.uniform(math.log(low), math.log(high)))
        else:
            value = self._rng.uniform(low, high)
        self.params[name] = value
        return value

    def suggest_int(self, name, low, high):
        value = self._rng.randint(low, high)
        self.params[name] = value
        return value


class SimpleStudy:
    """Random-search study with the Optuna surface the scripts use."""

    def __init__(self, directions=("maximize",), seed=42):
        self.directions = list(directions)
        self.trials = []  # list of dicts: number, value, params, state
        self._seed = seed

    def optimize(self, objective, n_trials=10, catch=()):
        rng = random.Random(self._seed + len(self.trials))
        for _ in range(n_trials):
            trial = SimpleTrial(len(self.trials), rng)
            try:
                value = objective(trial)
                state = "COMPLETE"
            except catch as e:  # noqa: PERF203
                value, state = None, f"FAIL({e})"
            self.trials.append(dict(number=trial.number, value=value,
                                    params=trial.params, state=state))

    @property
    def best_trial(self):
        done = [t for t in self.trials if t["value"] is not None]
        if not done:
            raise ValueError("no completed trials")
        sign = 1 if self.directions[0] == "maximize" else -1
        return max(done, key=lambda t: sign * t["value"])

    @property
    def best_params(self):
        return self.best_trial["params"]

    @property
    def best_value(self):
        return self.best_trial["value"]

    def trials_dataframe(self, attrs=("number", "value", "params", "state")):
        import pandas as pd

        rows = []
        for t in self.trials:
            row = {k: t[k] for k in attrs if k != "params"}
            if "params" in attrs:
                for k, v in t["params"].items():
                    row[f"params_{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f, pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(path):
        with open(path, "rb") as f:
            return pickle.load(f)


def create_study(directions=("maximize",), seed=42, prefer_optuna=True):
    if prefer_optuna:
        try:
            import optuna

            return optuna.create_study(directions=list(directions))
        except ImportError:
            pass
    return SimpleStudy(directions=directions, seed=seed)
