"""Distributed scalar-metric collection (counterpart:
latentaugment_tpu/parallel/stats.py, after NVIDIA's training_stats):
per-name moment triples (count, sum, sum of squares) reduced across the
ranks of a mesh, accumulated on the host and read as mean / std.
"""

import collections
import re

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh

_counters = collections.defaultdict(lambda: np.zeros(3, dtype=np.float64))


def moments(x):
    """[n, sum, sum of squares] of a tensor (float32, on its device): the
    payload to accumulate or reduce."""
    x = torch.as_tensor(x).float()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        x.square().sum()])


def psum_moments(m, mesh):
    """The moment triple summed over the ranks of the mesh's batch axis."""
    return pmesh.all_sum(m, mesh)


def report(name, value):
    """Accumulate on the host (training_stats.report)."""
    _counters[name] += moments(value).detach().cpu().double().numpy()
    return value


def report0(name, value, process_index=None):
    """Accumulate on rank 0 only (training_stats.report0)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_index == 0:
        report(name, value)
    return value


class Collector:
    """Means / stds of the reported counters since the last update."""

    def __init__(self, regex=".*", keep_previous=True):
        self._regex = re.compile(regex)
        self._keep = keep_previous
        self._cumulative = collections.defaultdict(lambda: np.zeros(3))
        self._deltas = {}
        self.update()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self):
        for name in self.names():
            total = np.array(_counters[name])
            self._deltas[name] = total - self._cumulative[name]
            self._cumulative[name] = total
        if not self._keep:
            for name in self.names():
                _counters[name][:] = 0
                self._cumulative[name][:] = 0

    def _delta(self, name):
        return self._deltas.get(name, np.zeros(3))

    def num(self, name):
        return int(self._delta(name)[0])

    def mean(self, name):
        d = self._delta(name)
        return float(d[1] / d[0]) if d[0] > 0 else float("nan")

    def std(self, name):
        d = self._delta(name)
        if d[0] <= 1:
            return 0.0 if d[0] == 1 else float("nan")
        mean = d[1] / d[0]
        return float(np.sqrt(max(d[2] / d[0] - mean ** 2, 0.0)))

    def as_dict(self):
        from ..utils.util_easydict import EasyDict

        out = EasyDict()
        for name in self.names():
            out[name] = EasyDict(num=self.num(name), mean=self.mean(name), std=self.std(name))
        return out
