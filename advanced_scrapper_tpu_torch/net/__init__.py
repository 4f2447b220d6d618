"""The network planes.

Only :mod:`.rpc` is ported: the length-framed RPC the index fleet rides
(``index/remote.py``, ``index/fleet.py``).  The reference's fetch
transports, lease plane and chaos sockets come with ROADMAP item 18.
"""

from advanced_scrapper_tpu_torch.net.rpc import (
    DEFAULT_MAX_FRAME,
    RpcClient,
    RpcError,
    RpcOverloaded,
    RpcRemoteError,
    RpcServer,
    RpcUnavailable,
    recv_frame,
    send_frame,
)

__all__ = [
    "DEFAULT_MAX_FRAME",
    "RpcClient",
    "RpcError",
    "RpcOverloaded",
    "RpcRemoteError",
    "RpcServer",
    "RpcUnavailable",
    "recv_frame",
    "send_frame",
]
