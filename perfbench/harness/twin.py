"""A frozen copy of the port's synthetic OGBN-arxiv twin, numpy only.

It repeats ``graph_odenet_tpu_torch.data.ogbn.synthetic_ogbn_arxiv`` with
``data.planetoid._finalize`` and ``graph.from_edges`` (symmetrise,
deduplicate, self-loops, row normalisation, sort by receiver, pad) draw for
draw, so a later change to the program's generator cannot move the
benchmark's inputs.  ``tests/test_perfbench_twin.py`` holds it equal to the
port's at a small scale, array for array.

The finished arrays are cached under ``perfbench/_cache/``, named by the
generator's parameters, and written through a temporary file that is
renamed into place.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["ARXIV_N", "ARXIV_E", "ARXIV_F", "ARXIV_C", "CALIBRATED", "arxiv_twin", "load_twin"]

ARXIV_N, ARXIV_E, ARXIV_F, ARXIV_C = 169_343, 1_166_243, 128, 40
CALIBRATED = dict(feature_noise=0.8, homophily=0.5, confusion=0.235)
CACHE_DIR = Path(__file__).resolve().parent.parent / "_cache"
_VERSION = 1


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _normalised_graph(senders, receivers, n_node, node_multiple=128, edge_multiple=1024):
    """Symmetric, deduplicated, self-looped, row-normalised COO edges sorted
    by (receiver, sender), padded: sender 0, receiver ``n_pad - 1``, weight 0."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    weight = np.ones_like(senders, dtype=np.float64)
    senders, receivers = (np.concatenate([senders, receivers]),
                          np.concatenate([receivers, senders]))
    weight = np.concatenate([weight, weight])
    key = senders * n_node + receivers
    key, idx = np.unique(key, return_index=True)
    senders, receivers, weight = senders[idx], receivers[idx], weight[idx]
    loop = np.arange(n_node, dtype=np.int64)
    new = loop[~np.isin(loop, senders[senders == receivers])]
    senders = np.concatenate([senders, new])
    receivers = np.concatenate([receivers, new])
    weight = np.concatenate([weight, np.ones_like(new, dtype=np.float64)])
    deg = np.zeros(n_node, dtype=np.float64)
    np.add.at(deg, receivers, weight)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0)
    weight = weight * inv[receivers]
    order = np.lexsort((senders, receivers))
    senders, receivers, weight = senders[order], receivers[order], weight[order]
    n_edge = senders.shape[0]
    e_pad = _round_up(max(n_edge, 1), edge_multiple)
    n_pad = _round_up(max(n_node, 1), node_multiple)
    pad = e_pad - n_edge
    return dict(
        senders=np.concatenate([senders, np.zeros(pad, np.int64)]).astype(np.int32),
        receivers=np.concatenate([receivers, np.full(pad, n_pad - 1, np.int64)]).astype(np.int32),
        weight=np.concatenate([weight, np.zeros(pad)]).astype(np.float32),
        n_node=np.int64(n_node), n_edge=np.int64(n_edge), n_node_pad=np.int64(n_pad),
    )


def arxiv_twin(*, seed: int = 0, scale: float = 1.0, calibrated: bool = False,
               feature_noise: float = 0.8, homophily: float = 0.5,
               confusion: float = 0.0) -> dict:
    """The twin's arrays: ``features [n_pad, 128]`` (row-normalised, zero
    padding rows), ``labels [n_pad]`` (-1 on padding), the graph's padded
    ``senders``, ``receivers``, ``weight``, its sizes, ``n_class`` and the
    54/16/30 split as ``split = [train_end, val_end, n]``."""
    if calibrated:
        feature_noise, homophily, confusion = (CALIBRATED[k] for k in (
            "feature_noise", "homophily", "confusion"))
    n, e, c = int(ARXIV_N * scale), int(ARXIV_E * scale), ARXIV_C
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    eff = labels.copy()
    if confusion > 0.0:
        p = rng.permutation(c).astype(np.int32)
        partner = np.empty(c, np.int32)
        partner[p] = np.roll(p, -1)
        confused = rng.random(n) < confusion
        eff = np.where(confused, partner[labels], labels).astype(np.int32)
    pop = rng.zipf(1.7, size=e).astype(np.int64) % n
    src = rng.integers(0, n, size=e)
    same = rng.random(e) < homophily
    cls_nodes = [np.nonzero(eff == k)[0] for k in range(c)]
    tgt = pop.copy()
    for k in range(c):
        sel = same & (eff[src] == k)
        if sel.sum() and len(cls_nodes[k]):
            tgt[sel] = rng.choice(cls_nodes[k], size=int(sel.sum()))
    ok = src != tgt
    src, tgt = src[ok], tgt[ok]
    class_means = rng.standard_normal((c, ARXIV_F)).astype(np.float32)
    feats = class_means[eff] + feature_noise * rng.standard_normal((n, ARXIV_F)).astype(np.float32)
    feats = np.abs(feats)

    out = _normalised_graph(src, tgt, n)
    feats = feats / np.maximum(feats.sum(axis=1, keepdims=True), 1e-12)
    n_pad = int(out["n_node_pad"])
    f_pad = _round_up(ARXIV_F, 128)
    features = np.zeros((n_pad, f_pad), dtype=np.float32)
    features[:n, :ARXIV_F] = feats
    labs = np.full((n_pad,), -1, dtype=np.int64)
    labs[:n] = labels
    out.update(features=features, labels=labs, n_class=np.int64(c),
               split=np.array([int(0.54 * n), int(0.7 * n), n], dtype=np.int64))
    return out


def load_twin(params: dict) -> dict:
    """``arxiv_twin(**params)``, from the cache when it is there."""
    key = "-".join(f"{k}{params[k]}" for k in sorted(params))
    path = CACHE_DIR / f"arxiv-twin-v{_VERSION}-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    out = arxiv_twin(**params)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out
