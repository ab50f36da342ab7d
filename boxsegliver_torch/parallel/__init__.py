"""Data parallelism of the port (port of boxsegliver_tpu/parallel): one
process per device in a torch.distributed process group, each rank taking
its rows of every global batch (see mesh.py)."""

from boxsegliver_torch.parallel.mesh import (  # noqa: F401
    Group, init_group, launch, per_device_batch_size, resolve_replicas)
