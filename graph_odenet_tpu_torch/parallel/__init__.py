"""Edge-partitioned execution over ``torch.distributed``.

Counterpart of ``graph_odenet_tpu/parallel/``: one process per card, each
owning a receiver block of the graph's nodes.

  mesh.py        the rank's device, ``(n_parts, rank)``, process-group bootstrap
  partition.py   receiver-block edge partitioning, sender-block buckets with
                 CSR and CSC views for the CSR kernel's bucket mode (B2)
  halo.py        sharded SpMM: all-gather halo exchange, and the ring that
                 overlaps each hop with the bucket reduction; the ring's
                 differentiable pieces for the sharded GAT
  sharded_gcn.py the edge-parallel GCN-ODE (config 4's model)
  sharded_gat.py edge-partitioned attention (``gat_sharded``: the ring of
                 attention-weighted bucket reductions, B2-w, or the ring of
                 online-softmax updates) and the edge-parallel GAT-ODE
  trainer.py     the trainer of both models

Not ported yet: feature-axis tensor parallelism on a 2-D mesh (ROADMAP A20).
"""

from graph_odenet_tpu_torch.parallel.halo import spmm_sharded  # noqa: F401
from graph_odenet_tpu_torch.parallel.mesh import bootstrap_distributed, world  # noqa: F401
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
