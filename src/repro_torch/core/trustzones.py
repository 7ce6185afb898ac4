"""Trust zones + ACLs shaping Edge-AI data flow (paper Fig. 4;
the port's copy of ``repro.core.trustzones``: pure Python).

Data items carry a zone label and an ACL; devices belong to zones and
owners.  ``allowed(data, device)`` is the single enforcement point the
orchestrator consults before moving tensors, model updates, or context
between devices ("access to sensitive data remains controlled").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

# built-in zone lattice: device zone -> data zones it may process.
# public data flows anywhere; work is an island; personal data
# additionally requires the device owner to match (see ``allowed``).
DEFAULT_FLOW = {
    "personal": {"personal", "household", "public"},
    "household": {"personal", "household", "public"},
    "work": {"work", "public"},
    "public": {"public"},
}


@dataclass(frozen=True)
class DataItem:
    name: str
    zone: str                       # sensitivity label of the data
    owner: str
    acl_allow: frozenset = frozenset()   # device names explicitly allowed
    acl_deny: frozenset = frozenset()    # device names explicitly denied


@dataclass(frozen=True)
class ZonePolicy:
    flow: dict = field(default_factory=lambda: dict(DEFAULT_FLOW))

    def zone_allows(self, data_zone: str, device_zone: str) -> bool:
        """May data labelled ``data_zone`` be processed in ``device_zone``?

        Data flows to a device zone iff the device zone is within the
        data's allowed consumers: data of zone Z may be seen by device
        zones D where Z ∈ flow[D] — e.g. 'personal' data only on
        personal devices; 'public' data anywhere.
        """
        return data_zone in self.flow.get(device_zone, set())


class AccessError(PermissionError):
    pass


def allowed(data: DataItem, device_name: str, device_zone: str,
            device_owner: str, policy: Optional[ZonePolicy] = None) -> bool:
    if device_name in data.acl_deny:
        return False
    if device_name in data.acl_allow:
        return True
    policy = policy or ZonePolicy()
    if data.zone == "personal" and device_owner != data.owner:
        return False
    return policy.zone_allows(data.zone, device_zone)


def check(data: DataItem, device_name: str, device_zone: str,
          device_owner: str, policy: Optional[ZonePolicy] = None) -> None:
    if not allowed(data, device_name, device_zone, device_owner, policy):
        raise AccessError(
            f"data {data.name!r} (zone={data.zone}, owner={data.owner}) "
            f"may not flow to device {device_name!r} "
            f"(zone={device_zone}, owner={device_owner})")


def filter_devices(data: DataItem, devices: dict[str, tuple[str, str]],
                   policy: Optional[ZonePolicy] = None) -> list[str]:
    """devices: name -> (zone, owner). Returns the permitted subset —
    e.g. the FL client set for a given training corpus."""
    return [n for n, (z, o) in devices.items()
            if allowed(data, n, z, o, policy)]
