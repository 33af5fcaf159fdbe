"""The sharded GAT-ODE (``ring_pallas``): encoder with ``heads`` heads of
``hidden``, ``4·steps`` single-head dynamics evaluations of width
``heads·hidden``, single-head readout; each an attention layer.

Model FLOPs of a layer ``(d_in → H heads of F)`` over N nodes and E edges:
the product ``2·N·d_in·HF`` forward and as much for each gradient the
backward needs; the two scores ``2·N·HF`` each forward, twice that each
backward; per edge and head ``EDGE_FWD`` forward (the logit's sum and
LeakyReLU, the max, the shift and exp, the denominator's sum) and
``EDGE_BWD`` backward; the weighted sum ``2·E·HF`` forward and ``4·E·HF``
backward (values and numerators); the division ``N·HF`` forward and
``2·N·HF`` backward.  Attention dropout, ELU, tanh and rk4's sums are not
counted, nor ``remat``'s recomputation.  An evaluation is one forward."""

from perfbench.work.buckets import b2w, ring

EDGE_FWD, EDGE_BWD = 6, 6


def _layers(cfg, shape):
    """(d_in, heads, feat, input needs a gradient) of each layer, in order."""
    h, k = cfg["hidden"], cfg["heads"]
    d = h * k
    return ([(shape["f_in"], k, h, False)] + [(d, 1, d, True)] * (4 * cfg["steps"])
            + [(d, 1, shape["n_class"], True)])


def flops(cfg, shape):
    n, e = shape["n_pad"], shape["n_edge"]
    fwd = bwd = 0
    for d_in, heads, feat, needs_dx in _layers(cfg, shape):
        hf = heads * feat
        fwd += 2 * n * d_in * hf + 4 * n * hf + EDGE_FWD * e * heads + 2 * e * hf + n * hf
        bwd += (2 * n * d_in * hf * (2 if needs_dx else 1) + 8 * n * hf + EDGE_BWD * e * heads
                + 4 * e * hf + 2 * n * hf)
    return fwd + bwd, fwd


def bucket_calls(cfg, shape, parts, rank):
    """``{"b2w": (train step calls, evaluation calls)}``: a training step
    launches each layer's forward, the dynamics' forwards again when
    ``remat`` recomputes them, and each layer's backward (which writes each
    hop's value gradient afresh)."""
    block = shape["n_pad"] // parts
    train, evaluation = [], []
    for i, (_, heads, feat, _) in enumerate(_layers(cfg, shape)):
        fwd, bwd = ring(parts, rank, shape["bucket_edges"], block,
                        lambda rows, edges, acc, h=heads, f=feat: b2w(rows, edges, h, f, acc),
                        backward_accumulates=False)
        dynamics = 0 < i <= 4 * cfg["steps"]
        train += fwd + (fwd if cfg.get("remat") and dynamics else []) + bwd
        evaluation += fwd
    return {"b2w": (train, evaluation)}
