"""Multi-GPU training over torch.distributed (port of arnerf_tpu/parallel):
data parallel (`make_mesh`, dp.py) and the row-sharded hash table
(`make_mesh_2d`, tp.py). `launch.py` starts one process per rank."""

from .mesh import Mesh, init_distributed, make_mesh, make_mesh_2d
from .tp import TableSharding
