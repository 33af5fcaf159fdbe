"""Config 4's GCN-ODE: encoder, ``4·steps`` dynamics evaluations, readout,
each one product ``h W`` and one aggregation ``Â (h W)``.

Model FLOPs: a product ``[m, k] @ [k, n]`` is ``2mkn`` forward and as much
for each gradient the backward needs (both but for the encoder, whose input
is data); an aggregation is ``2·E·F`` forward and ``2·E·F`` backward.
Biases, activations, dropout and rk4's sums are not counted.  An evaluation
is one forward without dropout."""

from perfbench.work.buckets import b2, ring


def _layers(cfg, shape):
    """(k, n, input needs a gradient) of each layer's product, in order."""
    h = cfg["hidden"]
    return ([(shape["f_in"], h, False)] + [(h, h, True)] * (4 * cfg["steps"])
            + [(h, shape["n_class"], True)])


def flops(cfg, shape):
    """``(train step, evaluation)`` model FLOPs over the whole graph."""
    n, e = shape["n_pad"], shape["n_edge"]
    fwd = bwd = 0
    for k, out, needs_dx in _layers(cfg, shape):
        fwd += 2 * n * k * out + 2 * e * out
        bwd += 2 * n * k * out * (2 if needs_dx else 1) + 2 * e * out
    return fwd + bwd, fwd


def bucket_calls(cfg, shape, parts, rank):
    """``{"b2": (train step calls, evaluation calls)}``, each a list of
    (bytes, flops) of one B2 launch on ``rank``."""
    block = shape["n_pad"] // parts
    train, evaluation = [], []
    for _, out, _ in _layers(cfg, shape):
        fwd, bwd = ring(parts, rank, shape["bucket_edges"], block,
                        lambda rows, edges, acc, f=out: b2(rows, edges, f, acc))
        train += fwd + bwd
        evaluation += fwd
    return {"b2": (train, evaluation)}
