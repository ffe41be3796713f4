"""The one table of the hand-written kernels' launch counters
(`core/kernels/counters.py`): it names every counter the kernel modules
keep, resets them all, and is what the graph helper (`core/graphs.py`)
advances at a replay. CPU only: nothing here launches a kernel.
"""

import importlib
import pkgutil

import pytest
import torch

from hfa_gp_tpu_torch.core import graphs
from hfa_gp_tpu_torch.core import kernels as kernels_pkg
from hfa_gp_tpu_torch.core.kernels import counters

torch.set_num_threads(1)


def _module_counters() -> set:
    """(module, attribute) of every `LAUNCHES*` integer of every module in
    `core/kernels/`."""
    found = set()
    for info in pkgutil.iter_modules(kernels_pkg.__path__):
        m = importlib.import_module(f"{kernels_pkg.__name__}.{info.name}")
        found.update((m, a) for a in vars(m)
                     if a.startswith("LAUNCHES")
                     and isinstance(getattr(m, a), int))
    return found


def test_the_table_names_every_launch_counter_of_the_kernel_modules():
    table = list(counters.COUNTERS.values())
    assert len(set(table)) == len(table), "a counter named twice"
    assert set(table) == _module_counters()


def test_reset_launches_zeroes_every_counter(monkeypatch):
    for i, (m, attr) in enumerate(counters.COUNTERS.values()):
        monkeypatch.setattr(m, attr, i + 1)
    assert sorted(counters.launches().values()) == \
        list(range(1, len(counters.COUNTERS) + 1))
    counters.reset_launches()
    assert counters.launches() == dict.fromkeys(counters.COUNTERS, 0)
    assert all(getattr(m, attr) == 0
               for m, attr in counters.COUNTERS.values())


def test_the_graph_helpers_counters_are_the_table():
    assert graphs.COUNTERS == tuple(counters.COUNTERS.values())
    assert graphs._counters() == tuple(counters.launches().values())


@pytest.mark.parametrize("name", sorted(counters.COUNTERS))
def test_a_replay_advances_each_counter_by_its_graphs_launches(name,
                                                               monkeypatch):
    """`_advance`, which a replay calls with the launches its graph holds,
    moves each counter of the table by its own entry and no other."""
    for m, attr in counters.COUNTERS.values():
        monkeypatch.setattr(m, attr, 10)
    m, attr = counters.COUNTERS[name]
    at = graphs.COUNTERS.index((m, attr))
    graphs._advance(tuple(3 if i == at else 0
                          for i in range(len(graphs.COUNTERS))))
    want = dict.fromkeys(counters.COUNTERS, 10)
    want[name] = 13
    assert counters.launches() == want
