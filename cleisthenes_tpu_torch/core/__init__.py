"""Core data types: transaction queue, membership, batches, request repos."""

from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.core.member import Address, Member, MemberMap
from cleisthenes_tpu_torch.core.queue import (
    EmptyQueueError,
    IndexBoundaryError,
    Transaction,
    TxQueue,
)
from cleisthenes_tpu_torch.core.request import (
    IncomingRequestRepository,
    RequestRepository,
)

__all__ = [
    "Batch",
    "Address",
    "Member",
    "MemberMap",
    "TxQueue",
    "Transaction",
    "EmptyQueueError",
    "IndexBoundaryError",
    "RequestRepository",
    "IncomingRequestRepository",
]
