"""Loss and accuracy metrics, index-masked so padded nodes never count.

Counterpart of ``graph_odenet_tpu/utils/metrics.py``.
"""

from __future__ import annotations

import torch

__all__ = ["masked_nll", "masked_accuracy", "accuracy"]


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the index set."""
    lp = log_probs[idx]
    lb = labels[idx]
    return -lp.gather(1, lb[:, None]).mean()


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (log_probs.argmax(dim=-1) == labels).to(torch.float32).mean()


def masked_accuracy(log_probs: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return accuracy(log_probs[idx], labels[idx])
