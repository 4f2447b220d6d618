"""The network planes.

- :mod:`.rpc`: the length-framed RPC the index fleet rides
  (``index/remote.py``, ``index/fleet.py``);
- :mod:`.transport` and :mod:`.webdriver`: the scraper's fetch transports
  and the stdlib W3C WebDriver wire client (``requests``, ``selenium`` and
  ``undetected_chromedriver`` are imported only by the transport that
  needs them);
- :mod:`.lease`: the pull-based work-lease protocol over TCP + NDJSON,
  its server parsing centrally; :mod:`.control`: the HTTP template and
  extraction service; :mod:`.pipe_pool` / :mod:`.pipe_worker`: the
  stdin/stdout subprocess worker pool; :mod:`.chaos`: seeded socket
  faults under the lease and RPC clients.
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
from advanced_scrapper_tpu_torch.net.transport import (
    FetchError,
    MockTransport,
    RequestsTransport,
    make_transport,
)

__all__ = [
    "DEFAULT_MAX_FRAME",
    "FetchError",
    "MockTransport",
    "RequestsTransport",
    "RpcClient",
    "RpcError",
    "RpcOverloaded",
    "RpcRemoteError",
    "RpcServer",
    "RpcUnavailable",
    "make_transport",
    "recv_frame",
    "send_frame",
]
