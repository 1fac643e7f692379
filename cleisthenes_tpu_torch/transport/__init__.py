"""Communication layer: wire format, connection seam, transports.

Mirrors the reference's L2/L1 (SURVEY.md §1): the ``Connection`` /
``Broadcaster`` / ``Handler`` seam from reference conn.go:27-38,182-184
that lets protocol instances run over a real network or an in-proc
channel transport (reference test/mock/stream.go) unchanged.
"""

from cleisthenes_tpu_torch.transport.message import (
    BbaPayload,
    BbaType,
    CatchupReqPayload,
    CatchupRespPayload,
    CoinPayload,
    DecSharePayload,
    Message,
    RbcPayload,
    RbcType,
    decode_message,
    encode_message,
)
from cleisthenes_tpu_torch.transport.base import (
    Authenticator,
    Broadcaster,
    ConnectionPool,
    Handler,
    HmacAuthenticator,
    NullAuthenticator,
)
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork, ChannelConnection
from cleisthenes_tpu_torch.transport.health import (
    Backoff,
    PeerHealthTracker,
    backoff_rng,
)
from cleisthenes_tpu_torch.transport.obs_http import (
    ObsServer,
    ObsTarget,
    render_prometheus,
)
from cleisthenes_tpu_torch.transport.pb_adapter import (
    decode_pb_message,
    encode_pb_message,
)

# The gRPC transport (transport.grpc_net) and the validator host
# (transport.host) import ``grpc`` and the protocol plane: import them
# from their modules.

__all__ = [
    "Message",
    "RbcPayload",
    "BbaPayload",
    "CatchupReqPayload",
    "CatchupRespPayload",
    "CoinPayload",
    "DecSharePayload",
    "RbcType",
    "BbaType",
    "encode_message",
    "decode_message",
    "Handler",
    "Broadcaster",
    "ConnectionPool",
    "Authenticator",
    "HmacAuthenticator",
    "NullAuthenticator",
    "ChannelNetwork",
    "ChannelConnection",
    "Backoff",
    "PeerHealthTracker",
    "backoff_rng",
    "ObsServer",
    "ObsTarget",
    "render_prometheus",
    "encode_pb_message",
    "decode_pb_message",
]
