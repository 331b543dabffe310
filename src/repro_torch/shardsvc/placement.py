"""Router placement: consistent hash of (tenant, group) -> shard, plus an
explicit override table for targeted rebalancing.

Groups are the unit of work (group partitions are fully independent in the
pane dataplane); tenants are contiguous group ranges (``tenant = group //
groups_per_tenant``).  The default placement is a consistent-hash ring over
*tenant* keys — a tenant's groups always colocate, so its state lives on
one shard — where every shard owns ``replicas`` pseudo-random points on a
64-bit ring and a key lands on the first shard point at or after its own
hash.  Two properties matter here:

* **Determinism** — the ring uses ``blake2b``, not Python's per-process
  salted ``hash()``, so the same (tenant, group) maps to the same shard in
  every process, every run.  The differential contract of the sharded
  service (N-shard output == 1-shard output) needs routing to be a pure
  function of the key.
* **Stability under change** — moving one hot tenant is an *override*, not
  a rehash: the table records ``group -> shard`` exceptions and bumps its
  version, leaving every other group's mapping (and therefore every other
  shard's window state) untouched.  Likewise growing the
  ring to ``n+1`` shards remaps only ~1/(n+1) of the keys.

``shard_of_groups`` is the hot-path form: vectorized over an arrival
chunk's group column with a memoized group->shard map (group-key
cardinality is small next to event counts, so the map converges after the
first few chunks).
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["PlacementTable", "ring_hash"]


def ring_hash(key: str) -> int:
    """Deterministic 64-bit ring position for ``key`` (process-stable)."""
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8)
                          .digest(), "big")


class PlacementTable:
    """(tenant, group) -> shard via consistent hashing + explicit overrides."""

    def __init__(self, n_shards: int, groups_per_tenant: int = 1,
                 replicas: int = 64):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if groups_per_tenant < 1:
            raise ValueError("groups_per_tenant must be >= 1")
        self.n_shards = int(n_shards)
        self.groups_per_tenant = int(groups_per_tenant)
        self.replicas = int(replicas)
        self.version = 0
        self._overrides: dict[int, int] = {}
        # ring: sorted point positions and the shard owning each point
        pts = [(ring_hash(f"shard:{s}:{r}"), s)
               for s in range(self.n_shards) for r in range(self.replicas)]
        pts.sort()
        self._ring_pos = np.array([p for p, _ in pts], dtype=np.uint64)
        self._ring_shard = np.array([s for _, s in pts], dtype=np.int64)
        self._cache: dict[int, int] = {}

    # ------------------------------------------------------------- lookups

    def tenant_of(self, group: int) -> int:
        return int(group) // self.groups_per_tenant

    def shard_of(self, group: int) -> int:
        g = int(group)
        s = self._cache.get(g)
        if s is None:
            s = self._cache[g] = self._resolve(g)
            return s
        return s

    def _resolve(self, group: int) -> int:
        ov = self._overrides.get(group)
        if ov is not None:
            return ov
        # hash the *tenant*, not the group: a tenant's groups colocate, so
        # per-tenant state (and any cross-group sharing within the tenant's
        # pane batches) stays on one shard
        h = ring_hash(f"tenant:{self.tenant_of(group)}")
        i = int(np.searchsorted(self._ring_pos, np.uint64(h), side="left"))
        if i == len(self._ring_pos):        # wrap around the ring
            i = 0
        return int(self._ring_shard[i])

    def shard_of_groups(self, groups: np.ndarray) -> np.ndarray:
        """Vectorized ``shard_of`` over an arrival chunk's group column."""
        out = np.empty(len(groups), dtype=np.int64)
        cache = self._cache
        for i, g in enumerate(groups.tolist()):
            s = cache.get(g)
            if s is None:
                s = cache[g] = self._resolve(g)
            out[i] = s
        return out

    def groups_on(self, shard: int, groups) -> list[int]:
        """Of ``groups`` (iterable of group keys), those placed on ``shard``."""
        return [g for g in groups if self.shard_of(g) == shard]

    # ----------------------------------------------------------- rebalance

    def override(self, group: int, shard: int) -> None:
        """Pin ``group`` to ``shard`` (a targeted rebalance).  Only this
        group's mapping changes; the table version is bumped so routers can
        detect staleness."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range")
        self._overrides[int(group)] = int(shard)
        self._cache[int(group)] = int(shard)
        self.version += 1

    def clear_override(self, group: int) -> None:
        if self._overrides.pop(int(group), None) is not None:
            self._cache.pop(int(group), None)
            self.version += 1

    @property
    def overrides(self) -> dict[int, int]:
        return dict(self._overrides)
