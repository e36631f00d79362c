"""Hyperparameter search-space DSL (counterpart of
analytics_zoo_tpu/orca/automl/hp.py): self-contained samplers over
`random.Random`, so one seed gives the same samples in both packages.

>>> import random
>>> from analytics_zoo_tpu_torch.orca.automl import hp
>>> rng = random.Random(0)
>>> hp.choice([16, 32, 64]).sample(rng) in (16, 32, 64)
True
>>> hp.choice([16, 32, 64]).grid_values()
[16, 32, 64]
>>> 1e-3 <= hp.loguniform(1e-3, 1e-1).sample(rng) <= 1e-1
True
>>> # randint's upper bound is EXCLUSIVE (randrange semantics)
>>> {hp.randint(5, 8).sample(rng) for _ in range(64)} == {5, 6, 7}
True
"""

from __future__ import annotations

import random
from typing import Any, List, Sequence


class SampleSpace:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    def grid_values(self) -> List[Any]:
        raise NotImplementedError("this space does not support grid search")


class Choice(SampleSpace):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)

    def grid_values(self):
        return list(self.categories)


class Uniform(SampleSpace):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class QUniform(SampleSpace):
    def __init__(self, lower: float, upper: float, q: float = 1.0):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return round(v / self.q) * self.q


class LogUniform(SampleSpace):
    def __init__(self, lower: float, upper: float):
        import math
        self.log_lower = math.log(lower)
        self.log_upper = math.log(upper)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self.log_lower, self.log_upper))


class RandInt(SampleSpace):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class GridSearch(SampleSpace):
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)

    def grid_values(self):
        return list(self.values)


def choice(categories):
    return Choice(categories)


def uniform(lower, upper):
    return Uniform(lower, upper)


def quniform(lower, upper, q=1.0):
    return QUniform(lower, upper, q)


def loguniform(lower, upper):
    return LogUniform(lower, upper)


def randint(lower, upper):
    return RandInt(lower, upper)


def grid_search(values):
    return GridSearch(values)


def sample_config(search_space: dict, rng: random.Random) -> dict:
    """Resolve a search space dict into one concrete config."""
    out = {}
    for k, v in search_space.items():
        out[k] = v.sample(rng) if isinstance(v, SampleSpace) else v
    return out
