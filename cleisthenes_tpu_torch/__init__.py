"""cleisthenes-tpu-torch: the PyTorch/CUDA port of cleisthenes_tpu.

HoneyBadgerBFT's batched crypto plane for an NVIDIA Hopper GPU.  The
JAX package ``cleisthenes_tpu`` stays beside it as the reference; this
package imports ``torch``, numpy and the standard library only, and
mirrors the reference's layout (``config``, ``ops/``, ``core/``,
``protocol/``) so each counterpart is found by name.

It runs the asynchronous protocol plane — N ``HoneyBadger`` state
machines (RBC, BBA, ACS, threshold decryption) over the deterministic
channel transport, in one process as ``protocol.cluster.SimulatedCluster``
with a cluster-shared ``CryptoHub`` that batches each message wave's
crypto — and the lockstep epoch (``protocol.spmd.LockstepCluster``),
with every batched wave in hand-written CUDA kernels (``csrc/``): the RBC
data plane — Reed-Solomon encode (GF(2^8), or GF(2^16) past 256
validators), Merkle forest, the N^2 ECHO branch checks and the
decode/re-encode/root recheck — and the BBA coin and decryption-share
modexp (256-bit groups, and the wide families up to 2112 bits).  Its
``ops/`` layer is the reference's whole: the host ``'cpu'`` and ``'cpp'``
backends, the scalar and pooled threshold-share ops, and the GJKR DKG
(``ops/dkg.py``), whose batched checks run on the same modexp kernels.
The defaults put the work on the card (``Config.crypto_backend='cuda'``,
``Config.device='cuda'``); on a machine without a GPU they raise
instead of running on the CPU.
"""

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.core.member import Address, Member, MemberMap
from cleisthenes_tpu_torch.core.queue import (
    EmptyQueueError,
    IndexBoundaryError,
    Transaction,
    TxQueue,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Batch",
    "Address",
    "Member",
    "MemberMap",
    "TxQueue",
    "Transaction",
    "EmptyQueueError",
    "IndexBoundaryError",
    "__version__",
]
