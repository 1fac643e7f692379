"""Protocol plane of the port: the lockstep (SPMD) epoch executor and
the dealer key setup it uses."""

from cleisthenes_tpu_torch.protocol.keys import NodeKeys, setup_keys
from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

__all__ = ["LockstepCluster", "NodeKeys", "setup_keys"]
