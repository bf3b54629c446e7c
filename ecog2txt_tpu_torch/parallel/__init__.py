"""Parallel training over ``torch.distributed``: one process a device.

The port's counterpart of ``ecog2txt_tpu/parallel``: data (``mesh.py``),
expert (``expert.py``) and sequence (``sequence.py``) parallelism on a
mesh of process groups, the multi-process bootstrap (``multihost.py``,
``launch.py``) and the collectives with their adjoints (``comm.py``).
Tensor and pipeline parallelism (``shard_params_tp``, the GPipe ring,
sp×pp) are not ported yet (see ROADMAP.md, Queue 1, item 10b).
"""

from .expert import ep_spec, gather_params_ep, shard_params_ep  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_dp_train_step,
    make_mesh,
    replicate,
)
from .multihost import initialize_distributed, make_global  # noqa: F401
from .sequence import halo_steps, sequence_parallel_encode  # noqa: F401
