"""Core data types of the port: the committed batch."""

from cleisthenes_tpu_torch.core.batch import Batch, Transaction

__all__ = ["Batch", "Transaction"]
