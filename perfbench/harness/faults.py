"""Faults planted in the program underneath a run, for the tests that show
``correct`` coming out false (``tests/test_perfbench_runs.py``) and for
the fault readings on the card (``calibrate.py``).  A normal run plants
none: ``run.py`` has no option that reaches this module.

  state_unchanged  every Adam step returns with the parameters and the
                   optimizer's state as they were
  half_batch       the trainer's training mask keeps every other training
                   node, and the loss is the mean over those
  no_exchange      every ring hop keeps the rank's own block instead of
                   exchanging it (the halo left out)
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "plant", "planted"]

FAULTS = ("state_unchanged", "half_batch", "no_exchange")


def plant(name: str) -> None:
    if name == "state_unchanged":
        import torch

        torch.optim.Adam.step = lambda self, closure=None: None
    elif name == "half_batch":
        from graph_odenet_tpu_torch.parallel import trainer

        masks, calls = trainer._rows_mask, [0]

        def half(idx, n_pad, rows):
            calls[0] += 1
            if calls[0] % 3 == 1:  # each call of the trainer asks train, val, test in turn
                idx = idx[::2]
            return masks(idx, n_pad, rows)

        trainer._rows_mask = half
    elif name == "no_exchange":
        from graph_odenet_tpu_torch.parallel import halo

        def keep(send, recv, me, n_parts, step=-1, group=None):
            recv.copy_(send)
            return []

        halo._exchange = keep
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")


@contextlib.contextmanager
def planted(name):
    """``name`` planted inside the block (none for None), and the program as
    it was after it."""
    import torch

    from graph_odenet_tpu_torch.parallel import halo, trainer

    saved = torch.optim.Adam.step, trainer._rows_mask, halo._exchange
    if name is not None:
        plant(name)
    try:
        yield
    finally:
        torch.optim.Adam.step, trainer._rows_mask, halo._exchange = saved
