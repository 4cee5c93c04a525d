"""Torch's intra-op threads under a parallel test run.

pytest-xdist runs the suite in several worker processes, and every worker
imports every test module while it collects.  Left at its default, torch
gives each worker as many intra-op threads as the machine has cores, so
the workers together run several busy threads per core and a port test
takes several times as long as it does alone.  Importing this module
shares the cores out among the workers instead; a run in one process
keeps torch's default.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if os.environ.get("PYTEST_XDIST_WORKER") and _WORKERS > 0:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def test_workers_share_the_cores():
    if os.environ.get("PYTEST_XDIST_WORKER") and _WORKERS > 0:
        assert torch.get_num_threads() == max(
            1, (os.cpu_count() or 1) // _WORKERS)
    else:
        assert torch.get_num_threads() >= 1
