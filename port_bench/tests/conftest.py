"""Shared pieces of the benchmark's own tests: the ``cuda`` marker, the
checkout on ``sys.path``, and a cell cut to a size the CPU runs in
seconds (the port's CPU paths: the plain compositor and kNN)."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's Hopper kernels); "
        "skips without one")


TINY_SCENE = {"kind": "synthetic", "seed": 11, "views": 6, "width": 96,
              "height": 80, "lines": 3, "curves": 1}


def tiny_cell(name: str, scene=None):
    """Workload ``name`` on a 6-view 96x80 scan, 150 seeds in a capacity
    of 512 (1024 for the DTU recipe, whose seeds are drawn in the ABC
    recipe's box), every other setting the recipe's."""
    from port_bench.harness import cell as cell_mod
    c = cell_mod.load(name)
    r = copy.deepcopy(c.recipe)
    m = r["model"]
    m.update(max_num_gaussians=512, init_min_num_gaussians=150,
             tile_pair_budget=6000)
    if c.config == "dtu":
        m.update(init_random_init=True, random_init_box_size=1.1,
                 random_init_box_center=0.5, max_num_gaussians=1024)
    return c._replace(recipe=r, scene=scene or TINY_SCENE)


@pytest.fixture
def cpu():
    import torch
    torch.set_num_threads(4)
    return torch.device("cpu")
