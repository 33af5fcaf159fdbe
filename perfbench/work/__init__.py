"""The work of each model's training step, from the configuration's shapes
alone: the model FLOPs that ``step_mfu`` counts, and each bucket-kernel call
with its bytes and FLOPs for the kernels' roofline shares.  One module per
model (``<model>.py``), each with ``flops(cfg, shape)`` and
``bucket_calls(cfg, shape, parts, rank)``.

``shape``: ``n_pad`` (padded nodes), ``n_edge`` (real edges, self-loops
included), ``f_in``, ``n_class`` and ``bucket_edges`` (``[P][P]`` real edges
of each receiver block from each sender block)."""
