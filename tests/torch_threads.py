"""Every test process runs torch on one intra-op thread.

``pytest.ini`` names this plugin (``-p torch_threads``), so the controller
and each xdist worker load it before any test runs.  The workers share the
host's cores: with torch's default of one thread per core in each of them,
their OpenMP threads spin against each other (two torch trainings side by
side on 8 threads each ran 20–200× slower).  The processes a test spawns
itself set their own count (the gloo ranks of ``torch_dist_worlds``).
"""


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
