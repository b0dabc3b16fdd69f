"""Multi-device training and serving over `torch.distributed`: the mesh of
ranks and process groups (`mesh`), the data-parallel steps and the sharded
render (`shard`), and a launcher of ranks for tests (`launch`)."""
from nerf_experiments_tpu_torch.parallel import mesh, shard
