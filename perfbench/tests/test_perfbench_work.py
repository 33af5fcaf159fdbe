"""The FLOP and byte counts against hand counts on a toy graph."""

from perfbench.harness.peaks import bound_s
from perfbench.work import buckets, gatode, gcnode

TOY = dict(n_pad=8, n_edge=10, f_in=4, n_class=3, bucket_edges=[[10]])


def test_gcnode_flops_by_hand():
    cfg = dict(hidden=2, steps=1)
    # forward: encoder 2·8·4·2 + 2·10·2, four dynamics 2·8·2·2 + 2·10·2, readout 2·8·2·3 + 2·10·3
    fwd = (128 + 40) + 4 * (64 + 40) + (96 + 60)
    # backward: the encoder's weight gradient only, the others' input gradients too
    bwd = (128 + 40) + 4 * (2 * 64 + 40) + (2 * 96 + 60)
    assert gcnode.flops(cfg, TOY) == (fwd + bwd, fwd)


def test_gatode_flops_by_hand():
    cfg = dict(hidden=1, heads=2, steps=1)
    n, e = 8, 10

    def layer(d_in, h, f, dx):
        hf = h * f
        fwd = 2 * n * d_in * hf + 4 * n * hf + 6 * e * h + 2 * e * hf + n * hf
        bwd = 2 * n * d_in * hf * (2 if dx else 1) + 8 * n * hf + 6 * e * h + 4 * e * hf + 2 * n * hf
        return fwd, bwd

    parts = [layer(4, 2, 1, False)] + [layer(2, 1, 2, True)] * 4 + [layer(2, 1, 3, True)]
    fwd, bwd = sum(p[0] for p in parts), sum(p[1] for p in parts)
    assert gatode.flops(cfg, TOY) == (fwd + bwd, fwd)


def test_b2_bytes_by_hand():
    # x and out 8·2 f32 each, 9 int64 row pointers, 10 int32 columns and f32 weights
    assert buckets.b2(8, 10, 2, False) == (2 * 64 + 72 + 80, 40)
    assert buckets.b2(8, 10, 2, True) == (3 * 64 + 72 + 80, 40 + 16)
    # weighted: columns 4 bytes and the [L, H] numerators instead of the weights
    assert buckets.b2w(8, 10, 2, 3, False) == (2 * 8 * 6 * 4 + 72 + 40 + 80, 2 * 10 * 6)


def test_ring_calls_by_hand():
    call = lambda rows, edges, acc: (rows, edges, acc)  # noqa: E731
    fwd, bwd = buckets.ring(2, 0, [[3, 2], [4, 1]], 4, call)
    assert fwd == [(4, 3, False), (4, 2, True)]
    assert bwd == [(4, 2, False), (4, 3, True)]
    fwd, bwd = buckets.ring(2, 1, [[3, 2], [4, 1]], 4, call, backward_accumulates=False)
    assert fwd == [(4, 1, False), (4, 4, True)] and bwd == [(4, 4, False), (4, 1, False)]


def test_launch_counts_match_the_ports():
    """36 B2 launches a training step and 18 an evaluation at rk4 × 4 (config 4);
    52 and 18 B2-w launches for the GAT-ODE with remat (the port's chip_smoke counts)."""
    shape = dict(TOY, n_pad=8)
    train, evaluation = gcnode.bucket_calls(dict(hidden=2, steps=4), shape, 1, 0)["b2"]
    assert (len(train), len(evaluation)) == (36, 18)
    train, evaluation = gatode.bucket_calls(dict(hidden=1, heads=2, steps=4, remat=True), shape, 1,
                                            0)["b2w"]
    assert (len(train), len(evaluation)) == (52, 18)


def test_bound_is_the_larger_of_bytes_and_flops():
    assert bound_s(3.35e12, 0) == 1.0
    assert bound_s(0, 67e12) == 1.0
    assert bound_s(3.35e12, 2 * 67e12) == 2.0
