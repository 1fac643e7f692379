"""Protocol plane: RBC, BBA (+ common coin), ACS, HoneyBadger, and the
lockstep (SPMD) epoch executor.

The asynchronous, data-dependent control flow of HBBFT lives here as
host-side message-driven state machines; all O(N^2) crypto math is
delegated to the batched ops plane (cleisthenes_tpu_torch.ops) through
the BatchCrypto seam.  ``SimulatedCluster`` runs N of them in one
process over the deterministic channel transport;
``LockstepCluster`` runs the same epoch's crypto as batched waves.
The plane's own adversary — semantic Byzantine behaviors under valid
MACs — lives in protocol.byzantine.
"""

from cleisthenes_tpu_torch.protocol.acs import ACS
from cleisthenes_tpu_torch.protocol.bba import BBA
from cleisthenes_tpu_torch.protocol.byzantine import Behavior, make_behavior
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.protocol.honeybadger import (
    HoneyBadger,
    NodeKeys,
    setup_keys,
)
from cleisthenes_tpu_torch.protocol.rbc import RBC
from cleisthenes_tpu_torch.protocol.reconfig import (
    ReconfigManager,
    encode_reconfig_tx,
)
from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

__all__ = [
    "RBC",
    "BBA",
    "ACS",
    "HoneyBadger",
    "NodeKeys",
    "setup_keys",
    "SimulatedCluster",
    "LockstepCluster",
    "Behavior",
    "make_behavior",
    "ReconfigManager",
    "encode_reconfig_tx",
]
