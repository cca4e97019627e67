# Copied from src/repro/core/energy.py; only the import paths differ.
"""Energy model (paper Section 5.2, Table 1).

``E = P * t`` with ``t = S / B`` — power (mW) times transfer duration. Every
logical transfer is recorded in an event ledger, split by purpose
(collection vs learning), so the per-table breakdowns (paper Tables 2-6) come
straight out of the ledger.

Accounting conventions (the paper leaves these implicit; see DESIGN.md §2 —
the per-technology relay/mains-power rules are implemented once, in
:mod:`repro.core.topology`):

* Only battery-powered endpoints are counted. The edge server is mains
  powered: transfers to it count the device's tx only; transfers *from* it
  count the device's rx only.
* 4G/NB-IoT go through infrastructure: one tx + one rx per unicast.
* 802.11g uses a WiFi-Direct-style star topology: one mule is the Access
  Point. A unicast between two non-AP mules is relayed: 2 tx + 2 rx, all on
  battery. If the AP is an endpoint: 1 tx + 1 rx.
* Observations on the wire are 54 float64 features + 1-byte label (433 B,
  calibrated to the paper's 34 477 mJ Edge-Only benchmark); models are
  float32 (7 x 55 x 4 = 1 540 B).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.registry import resolve_spec


@dataclass(frozen=True)
class Tech:
    name: str
    tx_mw: float
    up_mbps: float
    rx_mw: float
    down_mbps: float

    def tx_mj(self, nbytes: float) -> float:
        return self.tx_mw * (nbytes * 8.0 / (self.up_mbps * 1e6))

    def rx_mj(self, nbytes: float) -> float:
        return self.rx_mw * (nbytes * 8.0 / (self.down_mbps * 1e6))


def lora_bitrate_mbps(sf: int, bw_khz: float = 125.0,
                      code_rate: float = 0.8) -> float:
    """LoRa PHY bitrate for spreading factor ``sf`` (EU868 defaults:
    125 kHz bandwidth, CR 4/5): ``sf * BW / 2**sf * CR`` — SF7 ~= 5.5 kbps,
    SF12 ~= 0.29 kbps. Higher SF buys range at a steep energy-per-byte
    cost, which is exactly the trade-off ``"lora:sf=N"`` sweeps expose."""
    if sf != int(sf) or not 7 <= int(sf) <= 12:
        raise ValueError(f"LoRa spreading factor must be an integer in "
                         f"7..12, got {sf}")
    sf = int(sf)
    return float(sf) * (bw_khz * 1e3) / (2.0 ** sf) * code_rate / 1e6


def _lora_tech(sf: int = 7) -> Tech:
    # SX127x-class transceiver at +14 dBm / 3.3 V: ~44 mA tx, ~12 mA rx
    rate = lora_bitrate_mbps(sf)
    return Tech(f"lora:sf={int(sf)}" if int(sf) != 7 else "lora",
                145.2, rate, 39.6, rate)


def _mesh_tech(hops: int = 1) -> Tech:
    """Per-event energy of a ``"mesh:hops=N"`` spec: hop count multiplies
    *event counts* (:class:`repro.core.topology.MeshTransport`), never the
    per-event energy, so every mesh depth shares the 802.15.4 entry. The
    hop count is validated here too so the direct ``Ledger.add`` path
    fails as fast as the transport registry."""
    if isinstance(hops, bool) or hops != int(hops) or int(hops) < 1:
        raise ValueError(f"mesh hop count must be a positive integer, "
                         f"got {hops!r}")
    return TECHS["802.15.4"]


# Table 1 of the paper, plus the BLE/LoRa additions (DESIGN.md §5):
# BLE 4.x connection events ~= 0.27 Mbps application throughput at
# ~10 mA tx / 9 mA rx on 3.6 V coin-cell class radios.
TECHS: Dict[str, Tech] = {
    "4g": Tech("4g", 2100.0, 75.0, 2100.0, 35.0),
    "nbiot": Tech("nbiot", 199.0, 0.2, 199.52, 0.2),
    "802.15.4": Tech("802.15.4", 3.0, 0.12, 3.0, 0.12),
    "wifi": Tech("wifi", 1080.0, 48.0, 740.0, 48.0),
    "ble": Tech("ble", 36.0, 0.27, 32.4, 0.27),
    "lora": _lora_tech(),
}


# Parameterized technologies: factories keyed by spec name, resolved (and
# cached, outside the static paper-constant TECHS table) through the same
# registry machinery as transports and collection policies.
TECH_FACTORIES: Dict[str, object] = {
    "mesh": _mesh_tech,
    "lora": _lora_tech,
}

_TECH_CACHE: Dict[str, Tech] = {}


def resolve_tech(spec: str) -> Tech:
    """Per-event energy model for a technology *spec string*.

    Flat names resolve straight from :data:`TECHS`. Parameterized specs
    resolve through :data:`TECH_FACTORIES` and the shared spec grammar
    (:mod:`repro.core.registry`): ``"lora:sf=12"`` builds (and caches)
    the SF-dependent LoRa entry, ``"mesh:hops=N"`` reuses the 802.15.4
    per-event energies — hop count multiplies *event counts*, not the
    per-event energy, and lives in
    :class:`repro.core.topology.MeshTransport`. Raises :class:`KeyError`
    for unknown technologies/parameters (matching the transport registry)
    and :class:`ValueError` for invalid parameter values."""
    tech = TECHS.get(spec)
    if tech is not None:
        return tech
    return resolve_spec(spec, TECH_FACTORIES, _TECH_CACHE, "technology")

OBS_BYTES = 54 * 8 + 1        # 433 B (calibrated, DESIGN.md §2)
MODEL_BYTES = 55 * 7 * 4      # 1 540 B linear model, float32
INDEX_BYTES = 8               # entropy index / center id messages


@dataclass
class Ledger:
    events: List[dict] = field(default_factory=list)
    # Per-node battery meter (mJ drained so far), keyed by DC name. This is
    # runtime-only feedback state for the churn model (DESIGN.md §13): it is
    # excluded from equality and never serialized — the event list stays the
    # only parity surface.
    node_mj: Dict[str, float] = field(default_factory=dict, compare=False,
                                      repr=False)

    def add(self, tech: str, nbytes: float, *, purpose: str,
            n_tx: int = 1, n_rx: int = 1, what: str = "",
            src: str = None, dst: str = None) -> float:
        """Record one transfer event. ``src``/``dst`` optionally name the
        battery-powered endpoints: the tx side of the event is attributed
        to ``src``'s battery meter and the rx side to ``dst``'s (relay
        events — AP forwarding, mesh hops — are folded into the endpoints'
        meters; the churn model cares about fleet membership, not per-hop
        physics). Attribution never changes the event itself."""
        t = resolve_tech(tech)
        tx_mj = n_tx * t.tx_mj(nbytes)
        rx_mj = n_rx * t.rx_mj(nbytes)
        mj = tx_mj + rx_mj
        self.events.append({"tech": tech, "bytes": nbytes, "purpose": purpose,
                            "n_tx": n_tx, "n_rx": n_rx, "mj": mj,
                            "what": what})
        if src is not None and tx_mj:
            self.node_mj[src] = self.node_mj.get(src, 0.0) + tx_mj
        if dst is not None and rx_mj:
            self.node_mj[dst] = self.node_mj.get(dst, 0.0) + rx_mj
        return mj

    # -- high-level events ---------------------------------------------------
    def collect_to_edge(self, n_obs: int) -> float:
        """Sensor -> edge server over NB-IoT (tx only; ES is mains powered)."""
        return self.add("nbiot", n_obs * OBS_BYTES, purpose="collection",
                        n_tx=1, n_rx=0, what="sensor->ES")

    def collect_to_mule(self, n_obs: int, name: str = "SM") -> float:
        """Sensor -> SmartMule over 802.15.4 (both endpoints on battery).
        ``name`` identifies the receiving mule so the rx side lands on its
        battery meter (the tx side is the sensor's, not a DC's)."""
        return self.add("802.15.4", n_obs * OBS_BYTES, purpose="collection",
                        n_tx=1, n_rx=1, what=f"sensor->{name}", dst=name)

    def churn(self, name: str, window: int) -> None:
        """Record a battery depletion: zero-energy bookkeeping event (the
        node's radio goes silent — nothing is transferred), so churn shows
        up in the serialized event stream exactly where it happened."""
        self.events.append({"tech": "none", "bytes": 0.0, "purpose": "churn",
                            "n_tx": 0, "n_rx": 0, "mj": 0.0,
                            "what": f"{name} depleted@w{window}"})

    def unicast(self, tech: str, nbytes: float, *, src_is_es=False,
                dst_is_es=False, src_is_ap=False, dst_is_ap=False,
                purpose="learning", what="model") -> float:
        """One unicast between Data Collectors.

        Flag-based convenience wrapper: the per-technology relay/mains-power
        rules live in :mod:`repro.core.topology` (the single source of
        truth); algorithm code should charge against a
        :class:`~repro.core.topology.Topology` directly.
        """
        from repro_torch.core.topology import Node, transfer_counts
        n_tx, n_rx = transfer_counts(
            tech, Node("src", is_es=src_is_es, is_ap=src_is_ap),
            Node("dst", is_es=dst_is_es, is_ap=dst_is_ap))
        return self.add(tech, nbytes, purpose=purpose, n_tx=n_tx, n_rx=n_rx,
                        what=what)

    # -- summaries -----------------------------------------------------------
    def total(self, purpose: str = None) -> float:
        return sum(e["mj"] for e in self.events
                   if purpose is None or e["purpose"] == purpose)

    def by_purpose(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e["purpose"]] = out.get(e["purpose"], 0.0) + e["mj"]
        return out

    def by_tech(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e["tech"]] = out.get(e["tech"], 0.0) + e["mj"]
        return out
