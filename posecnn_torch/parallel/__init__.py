"""Data and tensor parallelism over `torch.distributed` (port of
`posecnn_tpu/parallel/`): the rank grid and its sharding rules (`mesh`),
the output-channel-parallel pair f and g (`tp`), and the launch of one
process per device (`launch`)."""

from posecnn_torch.parallel.mesh import MeshSpec, make_mesh, shard_batch, shard_model  # noqa: F401
