"""Distribution layer: pixel rows sharded over the ranks of a
torch.distributed group, and the gradient all-reduce (port of
`optixpathtracer_tpu/dist`)."""
from .sharding import (Mesh, gather_rows,  # noqa: F401
                       initialize_distributed, make_mesh, material_grad_step,
                       material_grads, render_rows, render_sample_sharded)
