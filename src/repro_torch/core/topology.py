# Copied from src/repro/core/topology.py; only the import paths differ.
"""Transport/topology layer: who relays, who pays, per technology.

The paper charges every logical transfer between Data Collectors according
to implicit per-technology conventions (DESIGN.md §2). Historically those
conventions lived as if-chains inside ``Ledger.unicast`` and inline loops in
``htl.py``; this module makes them a pluggable layer:

* :class:`Node` — a typed endpoint role: battery-powered SmartMule,
  mains-powered Edge Server (``is_es``), WiFi Access Point (``is_ap``).
* :class:`Transport` — maps a (src, dst) node pair to the number of
  battery-powered tx and rx events one unicast costs. Two built-ins:
  ``InfrastructureTransport`` (4G / NB-IoT / 802.15.4: one tx + one rx,
  mains-powered ES endpoints exempt) and ``ApRelayTransport`` (802.11g
  WiFi-Direct star: mule↔mule traffic relays through the AP, 2 tx + 2 rx
  unless one endpoint *is* the AP).
* :class:`Topology` — binds a technology + node set to a
  :class:`~repro.core.energy.Ledger` and exposes the collective message
  patterns the HTL algorithms use: ``unicast``, ``broadcast``, ``gather``
  and ``exchange_all``.

Transports are addressed by *spec strings* (grammar in
:mod:`repro.core.registry`, DESIGN.md §5): a flat name picks a registered
factory with its defaults (``"4g"``, ``"wifi"``, ``"ble"``), a
parameterized spec configures one (``"mesh:hops=3"``, ``"lora:sf=12"``).
New technologies plug in by registering a factory in
:data:`TRANSPORT_FACTORIES` (plus, if they carry new per-event energies, a
:class:`~repro.core.energy.Tech`) — algorithm code never needs to change.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.energy import Ledger
from repro_torch.core.registry import register_factory, resolve_spec


@dataclass(frozen=True)
class Node:
    """A Data Collector endpoint with its energy-accounting roles."""
    name: str
    is_es: bool = False     # mains-powered Edge Server: its radio is free
    is_ap: bool = False     # WiFi Access Point (one mule per window)


class Transport:
    """Battery-powered (n_tx, n_rx) cost of one unicast between two nodes."""

    def counts(self, src: Node, dst: Node) -> Tuple[int, int]:
        raise NotImplementedError


class InfrastructureTransport(Transport):
    """Cellular/LPWAN (4G, NB-IoT) and single-hop 802.15.4: one tx + one rx
    per unicast; a mains-powered ES endpoint costs nothing on its side."""

    def counts(self, src: Node, dst: Node) -> Tuple[int, int]:
        return (0 if src.is_es else 1), (0 if dst.is_es else 1)


class ApRelayTransport(Transport):
    """802.11g WiFi-Direct star: one mule acts as the Access Point. A unicast
    between two non-AP battery nodes is relayed (2 tx + 2 rx, all on
    battery); if either endpoint is the AP it is direct (1 tx + 1 rx). ES
    endpoints fall back to the infrastructure rule (the ES is reached over
    the fixed network, and its own radio is mains powered)."""

    def __init__(self):
        self._infra = InfrastructureTransport()

    def counts(self, src: Node, dst: Node) -> Tuple[int, int]:
        if src.is_es or dst.is_es:
            return self._infra.counts(src, dst)
        hops = 1 if (src.is_ap or dst.is_ap) else 2
        return hops, hops


class LoRaTransport(InfrastructureTransport):
    """LoRa star through a mains-powered gateway: infrastructure counts.
    The spreading factor steers the *energy* layer (bitrate,
    :func:`repro.core.energy.lora_bitrate_mbps`), not the relay
    structure; it is accepted (and range-checked) here so one spec string
    — ``"lora:sf=12"`` — configures both layers."""

    def __init__(self, sf: int = 7):
        super().__init__()
        from repro_torch.core.energy import lora_bitrate_mbps
        lora_bitrate_mbps(sf)          # validate 7..12
        self.sf = int(sf)


class MeshTransport(Transport):
    """Multi-hop 802.15.4 mesh: a unicast traverses ``hops`` links, each a
    battery tx + battery rx (the intermediate relays are battery mules).
    Only the *endpoint* events can be mains-exempt: an ES source skips the
    first tx, an ES destination skips the last rx — so ``hops=1`` charges
    identically to flat ``"802.15.4"`` and ``hops=3`` charges 3x the
    battery tx/rx events between mules. Per-event energy stays the
    802.15.4 Table-1 entry (:func:`repro.core.energy.resolve_tech`)."""

    def __init__(self, hops: int = 1):
        if isinstance(hops, bool) or hops != int(hops) or int(hops) < 1:
            raise ValueError(f"mesh hop count must be a positive integer, "
                             f"got {hops!r}")
        self.hops = int(hops)

    def counts(self, src: Node, dst: Node) -> Tuple[int, int]:
        return (self.hops - (1 if src.is_es else 0),
                self.hops - (1 if dst.is_es else 0))


# Factories keyed by spec *name*; spec parameters become factory kwargs
# ("mesh:hops=3" -> MeshTransport(hops=3)). BLE mirrors WiFi-Direct's star
# (one mule is the GATT central and relays peripheral<->peripheral
# traffic); LoRa is a star through a mains-powered gateway, i.e. the
# infrastructure rule (DESIGN.md §5).
TRANSPORT_FACTORIES: Dict[str, Callable[..., Transport]] = {
    "4g": InfrastructureTransport,
    "nbiot": InfrastructureTransport,
    "802.15.4": InfrastructureTransport,
    "wifi": ApRelayTransport,
    "ble": ApRelayTransport,
    "lora": LoRaTransport,
    "mesh": MeshTransport,
}

_TRANSPORT_CACHE: Dict[str, Transport] = {}


def register_transport(name: str,
                       factory: Callable[..., Transport]) -> None:
    """Register a transport factory under a spec name (idempotent for the
    same factory; raises on a conflicting re-registration)."""
    register_factory(TRANSPORT_FACTORIES, name, factory, "transport")


def get_transport(spec: str) -> Transport:
    """Resolve a transport spec string to a (cached) Transport instance.

    Raises :class:`KeyError` for unknown names or malformed specs, so
    ``Topology`` construction keeps its fail-fast contract."""
    return resolve_spec(spec, TRANSPORT_FACTORIES, _TRANSPORT_CACHE,
                        "transport")


def transfer_counts(tech: str, src: Node, dst: Node) -> Tuple[int, int]:
    """(n_tx, n_rx) one unicast costs on battery, under ``tech``'s rules."""
    return get_transport(tech).counts(src, dst)


class Topology:
    """A window's Data Collector fleet bound to a ledger and a technology.

    All HTL message patterns are expressed against this object so that the
    loop and fleet engines (and any future algorithm) share one accounting
    implementation.
    """

    def __init__(self, ledger: Ledger, tech: str,
                 nodes: Iterable[Node] = ()):
        from repro_torch.core.energy import resolve_tech
        self.transport = get_transport(tech)   # KeyError on unknown spec
        resolve_tech(tech)                     # ... or missing energy entry
        self.ledger = ledger
        self.tech = tech
        self.nodes: List[Node] = list(nodes)

    # -- node bookkeeping ---------------------------------------------------
    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    @property
    def ap(self) -> Optional[Node]:
        return next((n for n in self.nodes if n.is_ap), None)

    # -- message patterns ---------------------------------------------------
    def unicast(self, src: Node, dst: Node, nbytes: float, *,
                purpose: str = "learning", what: str = "model") -> float:
        n_tx, n_rx = self.transport.counts(src, dst)
        return self.ledger.add(self.tech, nbytes, purpose=purpose,
                               n_tx=n_tx, n_rx=n_rx, what=what,
                               src=src.name, dst=dst.name)

    def broadcast(self, src: Node, nbytes: float, *,
                  purpose: str = "learning", what: str = "model") -> float:
        """src -> every other node (as unicasts; the paper's radios have no
        free broadcast primitive at these ranges)."""
        return sum(self.unicast(src, dst, nbytes, purpose=purpose, what=what)
                   for dst in self.nodes if dst.name != src.name)

    def gather(self, dst: Node, nbytes: float, *,
               purpose: str = "learning", what: str = "model") -> float:
        """Every other node -> dst."""
        return sum(self.unicast(src, dst, nbytes, purpose=purpose, what=what)
                   for src in self.nodes if src.name != dst.name)

    def exchange_all(self, nbytes: float, *, purpose: str = "learning",
                     what: str = "model") -> float:
        """All-to-all: every ordered (src, dst) pair, src != dst."""
        return sum(self.unicast(src, dst, nbytes, purpose=purpose, what=what)
                   for src in self.nodes for dst in self.nodes
                   if src.name != dst.name)


def fleet_nodes(dcs, ap_name: Optional[str]) -> List[Node]:
    """Typed nodes for a window's DC fleet (``dcs`` from repro.core.htl)."""
    return [Node(d.name, is_es=d.is_es, is_ap=(d.name == ap_name))
            for d in dcs]
