"""Per-tenant admission: API-key auth, token-bucket rate limits, and
quota counters — enforced at the gateway BEFORE engine admission.

The engine's own admission control (bounded queues, brownout shedding)
protects the POOL; this layer protects tenants from EACH OTHER: one
tenant saturating its bucket is throttled with a typed, retriable
TenantRateLimitError (carrying the bucket's refill horizon as
retry_after_s) while every other tenant's traffic is untouched — the
over-quota-tenant-only property the gateway probe asserts.

Three gates, in order, all O(1) under one lock:

  AUTH    unknown API key -> TenantAuthError (non-retryable; counted
          under "gateway_auth_failures")
  QUOTA   absolute per-tenant request budget -> TenantQuotaError
          (non-retryable within the epoch; "_quota_rejected")
  BUCKET  token bucket (rate_per_s, burst) -> TenantRateLimitError
          with retry_after_s = time until one token refills
          ("_throttled")

Metrics per tenant: "gateway_tenant_<id>_admitted" / "_throttled" /
"_quota_rejected", plus the gauge "gateway_tenant_<id>_tokens". Time
comes from an injectable clock so the fake-clock tests drive refill
deterministically with zero real sleeps.
"""

import threading
import time

from .. import metrics
from ..errors import TenantAuthError, TenantQuotaError, TenantRateLimitError


class TokenBucket:
    """Classic token bucket: capacity `burst`, refilled continuously at
    `rate_per_s`. `take()` either consumes one token or returns the
    seconds until one is available (never consuming). rate_per_s=None
    disables rate limiting (the bucket always grants)."""

    def __init__(self, rate_per_s, burst, clock=time.monotonic):
        if rate_per_s is not None and rate_per_s <= 0:
            raise ValueError(
                "rate_per_s must be > 0 or None (got %r)" % (rate_per_s,)
            )
        if burst < 1:
            raise ValueError("burst must be >= 1 (got %r)" % (burst,))
        self.rate_per_s = rate_per_s
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._t_last = clock()

    def _refill(self, now):
        if self.rate_per_s is None:
            return
        dt = now - self._t_last
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate_per_s)
        self._t_last = now

    def take(self, now=None):
        """0.0 and one token consumed when available; otherwise the
        refill horizon in seconds (> 0) with nothing consumed."""
        if self.rate_per_s is None:
            return 0.0
        now = self.clock() if now is None else now
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate_per_s


class Tenant:
    """One provisioned tenant: identity, API key, and its admission
    budget. quota=None means unmetered; rate_per_s=None means unthrottled
    (burst is then only the bucket's initial size, irrelevant)."""

    def __init__(
        self,
        tenant_id,
        api_key,
        rate_per_s=None,
        burst=16,
        quota=None,
        clock=time.monotonic,
    ):
        self.tenant_id = tenant_id
        self.api_key = api_key
        self.quota = quota
        self.used = 0
        self.bucket = TokenBucket(rate_per_s, burst, clock=clock)


class TenantTable:
    """The gateway's tenant registry + admission gate. Thread-safe: the
    replica server admits from per-connection reader threads."""

    def __init__(self, tenants=(), clock=time.monotonic, store=None):
        self.clock = clock
        self._lock = threading.Lock()
        self._by_key = {}
        #: state.StateStore: absolute-quota `used` counters
        #: persist into the "tenant_quota" keyspace on a LAZY
        #: durability contract (fsync=False — losing the last few
        #: increments on a crash under-counts briefly, which is the
        #: safe direction for admission), so a restarted replica does
        #: not reset every tenant's quota to zero. Rate buckets are
        #: deliberately NOT persisted: they refill in seconds.
        self._store = store
        for t in tenants:
            self.add(t)

    def add(self, tenant):
        with self._lock:
            if tenant.api_key in self._by_key:
                raise ValueError(
                    "duplicate API key for tenant %r" % (tenant.tenant_id,)
                )
            if self._store is not None:
                tenant.used = max(
                    tenant.used,
                    int(
                        self._store.get(
                            "tenant_quota", tenant.tenant_id, 0
                        )
                    ),
                )
            self._by_key[tenant.api_key] = tenant
        return tenant

    def provision(self, tenant_id, api_key, **kw):
        kw.setdefault("clock", self.clock)
        return self.add(Tenant(tenant_id, api_key, **kw))

    def admit(self, api_key, program=None, now=None):
        """Admit one request for `api_key` or raise the typed refusal
        (TenantAuthError / TenantQuotaError / TenantRateLimitError).
        Returns the Tenant on admission."""
        with self._lock:
            tenant = self._by_key.get(api_key)
            if tenant is None:
                metrics.count("gateway_auth_failures")
                raise TenantAuthError(
                    "unknown API key: no provisioned tenant"
                )
            tid = tenant.tenant_id
            if tenant.quota is not None and tenant.used >= tenant.quota:
                metrics.count("gateway_tenant_%s_quota_rejected" % tid)
                raise TenantQuotaError(tid, tenant.used, tenant.quota)
            retry_after = tenant.bucket.take(
                self.clock() if now is None else now
            )
            metrics.set_gauge(
                "gateway_tenant_%s_tokens" % tid,
                round(tenant.bucket.tokens, 3),
            )
            if retry_after > 0.0:
                metrics.count("gateway_tenant_%s_throttled" % tid)
                raise TenantRateLimitError(
                    tid, retry_after, program=program
                )
            tenant.used += 1
            if self._store is not None and tenant.quota is not None:
                try:
                    self._store.put(
                        "tenant_quota", tid, tenant.used, fsync=False
                    )
                except Exception:
                    # lazy contract: a failing store write must not
                    # turn an admitted request into a refusal
                    metrics.count("gateway_tenant_store_errors")
            metrics.count("gateway_tenant_%s_admitted" % tid)
            return tenant
