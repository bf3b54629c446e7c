"""Auxiliary tools: checkpoint introspection, TensorBoard summaries and
the import of the reference's TF1 checkpoints."""

from .introspect import recover_model_sizes  # noqa: F401
from .summaries import SummaryWriter, iter_events  # noqa: F401
