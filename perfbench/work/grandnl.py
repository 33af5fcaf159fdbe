"""GRAND-nl (``parallel.sharded_grand``): a linear encoder to the state
width ``D = heads·hidden``, ``4·steps`` dynamics evaluations, a linear
readout.  Each evaluation recomputes the attention: the products ``Q = hW_q
+ b_q`` and ``K = hW_k + b_k``, the per-edge scores (``edge_dot`` at H =
``heads``, F = ``hidden``), the softmax a head and the head mean, then one
weighted aggregation at H = 1, F = D (B2-w).

Model FLOPs over N nodes and E edges: a product ``[N, k] @ [k, n]`` is
``2Nkn`` forward and as much for each gradient the backward needs (both
but for the encoder's, whose input is data); the scores ``2·E·D`` forward
and ``4·E·D`` backward (the gradients of Q and of K); per edge and head
``EDGE_FWD`` forward (the scale, the max, the shift and exp, the
denominator's sum, the normalisation and the mean's sum) and ``EDGE_BWD``
backward; the aggregation ``2·E·D`` forward and ``4·E·D`` backward (values
and weights).  Biases, σ(α), the β term, ReLU, dropout and rk4's sums are
not counted.  An evaluation is one forward."""

from perfbench.work.buckets import b2w, ring

EDGE_FWD, EDGE_BWD = 7, 7


def flops(cfg, shape):
    """``(train step, evaluation)`` model FLOPs over the whole graph."""
    n, e = shape["n_pad"], shape["n_edge"]
    heads = cfg["heads"]
    d = cfg["hidden"] * heads
    evals = 4 * cfg["steps"]
    products_fwd = 2 * n * d * (shape["f_in"] + shape["n_class"]) + evals * 2 * (2 * n * d * d)
    products_bwd = 2 * n * d * (shape["f_in"] + 2 * shape["n_class"]) + evals * 2 * (4 * n * d * d)
    fwd = products_fwd + evals * (2 * e * d + EDGE_FWD * e * heads + 2 * e * d)
    bwd = products_bwd + evals * (4 * e * d + EDGE_BWD * e * heads + 4 * e * d)
    return fwd + bwd, fwd


def bucket_calls(cfg, shape, parts, rank):
    """``{"b2w": (train step calls, evaluation calls)}``, each a list of
    (bytes, flops) of one B2-w launch on ``rank``: a training step launches
    each evaluation's aggregation forward and its value gradient (the
    backward ring writes each hop's gradient afresh), and the scores'
    gradients, two a bucket (Q over its CSR view, K over its CSC view, each
    written afresh at H = ``heads``, F = ``hidden``); an evaluation the
    aggregations' forwards alone."""
    block = shape["n_pad"] // parts
    heads, hidden = cfg["heads"], cfg["hidden"]
    d = heads * hidden
    fwd, bwd = ring(parts, rank, shape["bucket_edges"], block,
                    lambda rows, edges, acc: b2w(rows, edges, 1, d, acc),
                    backward_accumulates=False)
    scores = [b2w(block, int(shape["bucket_edges"][rank][b]), heads, hidden, False)
              for b in range(parts) for _ in range(2)]
    evals = 4 * cfg["steps"]
    return {"b2w": (evals * (fwd + bwd + scores), evals * fwd)}
