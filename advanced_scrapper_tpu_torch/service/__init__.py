"""Multi-tenant dedup-as-a-service front door.

The service layer is the last hop before callers: a framed-RPC gateway
(:mod:`.gateway`) that maps every request's tenant id to an isolated
``tenant:<id>:…`` key-space namespace on the index fleet
(:mod:`.tenancy`), stacks per-tenant token buckets on the shared
admission gate, and exports the per-tenant ``astpu_tenant_*`` series the
SLO engine and the autoscaler consume.

Layering: service/ may import net/, index/, runtime/ and obs/ — never
``pipeline``/``ops``/``parallel`` internals (held by
``tests/test_torch_boundary.py``): the front door routes and meters, it does
not dedup.
"""

from advanced_scrapper_tpu_torch.service.gateway import DedupGateway, GATED_VERBS
from advanced_scrapper_tpu_torch.service.tenancy import (
    TENANT_ID_RE,
    TenantRegistry,
    TenantSpec,
    tenant_space,
)

__all__ = [
    "DedupGateway",
    "GATED_VERBS",
    "TENANT_ID_RE",
    "TenantRegistry",
    "TenantSpec",
    "tenant_space",
]
