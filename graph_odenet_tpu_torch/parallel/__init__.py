"""Edge-partitioned execution over ``torch.distributed``.

Counterpart of ``graph_odenet_tpu/parallel/``: one process per card, each
owning a receiver block of the graph's nodes.

  mesh.py        the rank's device, ``(n_parts, rank)`` within a process group,
                 bootstrap, ``make_mesh`` (named axes, a process group along
                 each), the sums and checks over a group that the models share
  partition.py   receiver-block edge partitioning, sender-block buckets with
                 CSR and CSC views for the CSR kernel's bucket mode (B2)
  halo.py        sharded SpMM: all-gather halo exchange, and the ring that
                 overlaps each hop with the bucket reduction, on any process
                 group, with feature-axis tensor parallelism and a leading
                 batch axis; the ring's differentiable pieces for the
                 sharded GAT
  model_parts.py Glorot weights, feature dropout and rk4 of the three models
  sharded_gcn.py the edge-parallel GCN-ODE (config 4's model)
  sharded_gat.py edge-partitioned attention (``gat_sharded``: the ring of
                 attention-weighted bucket reductions, B2-w, or the ring of
                 online-softmax updates) and the edge-parallel GAT-ODE
  sharded_grand.py
                 GRAND-nl: attention recomputed at every evaluation, scored
                 per bucket (``halo.bucket_scores``), aggregated by the same
                 ring of B2-w
  trainer.py     the trainer of the three models, one entry of its table each
"""

from graph_odenet_tpu_torch.parallel.halo import spmm_sharded  # noqa: F401
from graph_odenet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    bootstrap_distributed,
    make_mesh,
    world,
)
from graph_odenet_tpu_torch.parallel.partition import (  # noqa: F401
    PaddedBuckets,
    PartitionedGraph,
    padded_buckets,
    partition_by_receiver,
)
from graph_odenet_tpu_torch.parallel.sharded_gat import gat_sharded  # noqa: F401
from graph_odenet_tpu_torch.parallel.trainer import (  # noqa: F401
    ShardedTrainConfig,
    fit_sharded_node_classifier,
)
