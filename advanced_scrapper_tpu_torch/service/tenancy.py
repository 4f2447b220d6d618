"""Tenant declarations: namespaces, quota specs and the registry.

A tenant is a name plus a quota: the name maps — via
:func:`tenant_space` — into the reserved ``tenant:`` key-space prefix
the index plane's :func:`~advanced_scrapper_tpu_torch.index.remote
.namespace_policy` table declares (auto-provisioned on first touch,
wipe-allowed for offboarding), so a tenant's band keys cannot collide
with another tenant's or with the shared ``bands``/``urls`` spaces BY
CONSTRUCTION — isolation is a property of the key space, not of any
routing code being correct.

The quota half is declarative too: :class:`TenantSpec` carries the
token-bucket rate/burst, the concurrency cap and the tenant's SLO
targets (p99 ceiling + allowed reject ratio), and
:class:`TenantRegistry` resolves ids to specs — either pre-declared
(``auto_provision=False``: an unknown tenant is refused, the closed
deployment) or stamped from a default template on first sight (the open
deployment the canary prober's auto-provisioned spaces pioneered).
"""

from __future__ import annotations

import dataclasses
import re
import threading

from advanced_scrapper_tpu_torch.index.remote import TENANT_SPACE_PREFIX

__all__ = [
    "TENANT_ID_RE",
    "TenantRegistry",
    "TenantSpec",
    "tenant_space",
]

#: tenant ids travel inside key-space names (``tenant:<id>:<sub>``) and
#: metric label values, so the charset is deliberately narrow — in
#: particular no ``:``, which would let one tenant's id parse as
#: another's id + sub-space.
TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


def tenant_space(tenant: str, sub: str = "bands") -> str:
    """The key-space name for one tenant's sub-index (default: the band
    postings).  Raises ``ValueError`` for ids outside the narrow charset
    — a malformed id must fail before it names a key space."""
    if not TENANT_ID_RE.match(tenant or ""):
        raise ValueError(f"invalid tenant id {tenant!r}")
    return f"{TENANT_SPACE_PREFIX}{tenant}:{sub}"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared quota + objectives.

    - ``rate``/``burst`` — the tenant's own token bucket (requests/s;
      0 = uncapped), stacked UNDER the gateway's shared admission gate;
    - ``max_inflight`` — the tenant's concurrency cap (0 = uncapped);
    - ``p99_slo_s`` — the per-tenant p99 latency ceiling the SLO engine
      evaluates over ``astpu_tenant_seconds{tenant=…}``;
    - ``reject_budget`` — the allowed rejected/requests ratio before the
      tenant's quota objective burns;
    - ``slo_budget`` — the violating window fraction both objectives
      tolerate (the engine's error budget).
    """

    tenant: str
    rate: float = 0.0
    burst: float | None = None
    max_inflight: int = 16
    p99_slo_s: float = 0.5
    reject_budget: float = 0.5
    slo_budget: float = 0.05

    def __post_init__(self):
        if not TENANT_ID_RE.match(self.tenant or ""):
            raise ValueError(f"invalid tenant id {self.tenant!r}")

    @classmethod
    def parse(cls, text: str) -> "TenantSpec":
        """``"name[,rate=R][,burst=B][,inflight=N][,p99=S][,rejects=F]"``
        — the CLI shape (``--tenant acme,rate=500,inflight=8``)."""
        parts = [p.strip() for p in text.split(",") if p.strip()]
        if not parts:
            raise ValueError("empty tenant spec")
        kw: dict = {"tenant": parts[0]}
        keys = {
            "rate": ("rate", float),
            "burst": ("burst", float),
            "inflight": ("max_inflight", int),
            "p99": ("p99_slo_s", float),
            "rejects": ("reject_budget", float),
            "budget": ("slo_budget", float),
        }
        for part in parts[1:]:
            k, sep, v = part.partition("=")
            if not sep or k not in keys:
                raise ValueError(f"bad tenant spec field {part!r}")
            field, conv = keys[k]
            kw[field] = conv(v)
        return cls(**kw)


class TenantRegistry:
    """Thread-safe id → :class:`TenantSpec` resolution.

    Pre-declared specs always win; unknown ids either stamp a fresh spec
    from the ``default`` template (``auto_provision=True`` — mirroring
    the namespace table's auto-provisioned ``tenant:`` prefix) or raise
    ``KeyError`` (closed deployment: the front door refuses tenants
    nobody declared)."""

    def __init__(
        self,
        specs=(),
        *,
        default: TenantSpec | None = None,
        auto_provision: bool = True,
    ):
        self._lock = threading.Lock()
        self._specs: dict[str, TenantSpec] = {}
        self.default = default or TenantSpec(tenant="default")
        self.auto_provision = bool(auto_provision)
        self._declared: set[str] = set()
        for spec in specs:
            self.register(spec)

    def register(self, spec: TenantSpec) -> TenantSpec:
        with self._lock:
            self._specs[spec.tenant] = spec
            self._declared.add(spec.tenant)
        return spec

    def get(self, tenant: str) -> TenantSpec:
        if not TENANT_ID_RE.match(tenant or ""):
            raise KeyError(f"invalid tenant id {tenant!r}")
        with self._lock:
            spec = self._specs.get(tenant)
            if spec is not None:
                return spec
            if not self.auto_provision:
                raise KeyError(f"unknown tenant {tenant!r}")
            spec = dataclasses.replace(self.default, tenant=tenant)
            self._specs[tenant] = spec
            return spec

    def known(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._specs))

    def declared(self) -> tuple[str, ...]:
        """Operator-declared ids only — auto-provisioned walk-ins are
        ``known()`` but not declared (the status surface tells the two
        apart, so an operator can spot tenants nobody budgeted for)."""
        with self._lock:
            return tuple(sorted(self._declared))
