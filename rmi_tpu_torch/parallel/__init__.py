"""Work spread over CUDA cards: the optimizer's and ``--param-grid``'s
device pool (sweep.py), and the data-parallel build, sharded serving and
process set-up on torch.distributed (dp_trainer.py, serve.py,
multihost.py)."""

from rmi_tpu_torch.parallel.dp_trainer import (DP_LEAF_MODELS, DP_TOP_MODELS, DPGroup,
                                               dp_train_two_layer, local_shard,
                                               trained_rmi)
from rmi_tpu_torch.parallel.multihost import (global_mesh, hybrid_mesh, initialize,
                                              run_ranks)
from rmi_tpu_torch.parallel.serve import (replicate_rmi, replicate_rmi_per_device,
                                          search_sharded, serving_mesh, shard_queries,
                                          unshard)
from rmi_tpu_torch.parallel.sweep import (device_pool, parallel_measure_rmis,
                                          parallel_train_grid)

__all__ = ["DP_LEAF_MODELS", "DP_TOP_MODELS", "DPGroup", "dp_train_two_layer",
           "local_shard", "trained_rmi", "global_mesh", "hybrid_mesh", "initialize",
           "run_ranks", "replicate_rmi", "replicate_rmi_per_device", "search_sharded",
           "serving_mesh", "shard_queries", "unshard", "device_pool",
           "parallel_measure_rmis", "parallel_train_grid"]
