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
]
