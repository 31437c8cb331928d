"""Reference-scale metric-domain prior, generated from a hand-authored
domain catalog.

The port's copy of ``chatts_tpu/datagen/metric_catalog.py``: the same numpy code, so a seed
gives the same bits in both packages.

The reference ships a 29,390-line ``config/metric_set.json`` (25 categories,
~500 metrics, each with clusters and per-metric attribute ranges) that drives
the diversity of LLM-assisted datagen (reference:
chatts/utils/attribute_utils.py:19-30, chatts/align/mts_shape_llm_qa.py).
That artifact is itself LLM-generated domain knowledge; rather than copying
it, this module expands an original catalog of ~20+ domains x ~15-20 metrics
into the same schema.  Each metric declares a *kind* (utilization percentage,
throughput rate, latency, error rate, physical level, price, ...) and an
optional magnitude scale; the kind profile supplies seasonal/trend/noise/
change attribute ranges that are physically sensible for that kind.

``build_metric_set()`` is deterministic (pure data expansion, no RNG), so the
prior is stable across runs and processes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# Change-type groups (names must match chatts_tpu_torch.datagen.changes registry).
_SPIKES = ["upward spike", "downward spike", "sudden increase", "sudden decrease"]
_UP_ONLY = [
    "upward spike",
    "continuous upward spike",
    "sudden increase",
    "wide upward spike",
    "decrease after upward spike",
    "rapid rise followed by slow decline",
]
_DOWN_ONLY = [
    "downward spike",
    "continuous downward spike",
    "sudden decrease",
    "wide downward spike",
    "increase after downward spike",
    "rapid decline followed by slow rise",
]
_TWO_PHASE = [
    "rapid rise followed by slow decline",
    "slow rise followed by rapid decline",
    "rapid decline followed by slow rise",
    "slow decline followed by rapid rise",
]
_WIDE = ["wide upward spike", "wide downward spike"]
_ALL_TREND = ["increase", "decrease", "keep steady", "multiple"]
_STEADYISH = ["keep steady", "multiple"]
_BOTH_NOISE = ["noisy", "almost no noise"]
_SIN = "sin periodic fluctuation"
_SQUARE = "square periodic fluctuation"
_TRIANGLE = "triangle periodic fluctuation"
_NONE = "no periodic fluctuation"


def _rng(pair) -> dict:
    # Negative scales (e.g. RSRP around -95 dBm) flip the endpoints; keep
    # min <= max so rng.uniform stays well-defined.
    lo, hi = sorted((float(pair[0]), float(pair[1])))
    return {"min": lo, "max": hi}


def _block(seasonal, s_amp, s_period, trend, t_start, t_amp, noise, change,
           c_amp, unit) -> dict:
    return {
        "unit": unit,
        "seasonal": {
            "attributes": seasonal,
            "amplitude": _rng(s_amp),
            "period": _rng(s_period),
        },
        "trend": {
            "attributes": trend,
            "start": _rng(t_start),
            "amplitude": _rng(t_amp),
        },
        "noise": {"attributes": noise},
        "change": {
            "attributes": change,
            "amplitude": _rng(c_amp),
        },
    }


def _profile(kind: str, scale: float, unit: str) -> dict:
    """Attribute ranges for one metric kind at magnitude ``scale``."""
    s = scale
    if kind == "percent":  # bounded utilization 0-100
        return _block([_SIN, _NONE], (3, 20), (24, 288), _ALL_TREND,
                      (10, 80), (5, 30), _BOTH_NOISE,
                      _SPIKES + ["continuous upward spike"], (5, 40), unit)
    if kind == "percent_steady":  # slowly-filling capacity (memory, disk)
        return _block([_NONE], (0, 0), (0, 0),
                      ["increase", "keep steady", "multiple"], (20, 70),
                      (2, 20), ["almost no noise"],
                      ["sudden increase", "sudden decrease", "wide upward spike"],
                      (5, 25), unit)
    if kind == "hit_ratio":  # high baseline, dips hurt
        return _block([_NONE], (0, 0), (0, 0), _STEADYISH, (70, 99), (1, 10),
                      ["almost no noise"], _DOWN_ONLY, (5, 40), unit)
    if kind == "rate":  # traffic-like throughput with daily cycle
        return _block([_SIN, _NONE], (0.1 * s, 0.5 * s), (24, 1440),
                      _ALL_TREND, (0.2 * s, 2 * s), (0.1 * s, s), _BOTH_NOISE,
                      _SPIKES + ["continuous upward spike",
                                 "continuous downward spike"],
                      (0.2 * s, 2 * s), unit)
    if kind == "count":  # absolute counts, step-like
        return _block([_SQUARE, _NONE], (0.1 * s, 0.5 * s), (60, 720),
                      _ALL_TREND, (0.1 * s, s), (0.05 * s, 0.5 * s),
                      _BOTH_NOISE, _SPIKES, (0.1 * s, s), unit)
    if kind == "latency":  # steady with upward anomalies
        return _block([_NONE, _SIN], (0.05 * s, 0.3 * s), (30, 300),
                      _STEADYISH, (0.1 * s, s), (0.05 * s, 0.5 * s),
                      _BOTH_NOISE, _UP_ONLY, (0.5 * s, 3 * s), unit)
    if kind == "error":  # near-zero with bursts
        return _block([_NONE], (0, 0), (0, 0), ["keep steady"],
                      (0, 0.02 * s), (0, 0.01 * s), _BOTH_NOISE,
                      ["upward spike", "continuous upward spike",
                       "sudden increase", "decrease after upward spike"],
                      (0.1 * s, s), unit)
    if kind == "queue":  # backlog: bursts that drain
        return _block([_NONE, _TRIANGLE], (0.05 * s, 0.3 * s), (30, 360),
                      _STEADYISH, (0, 0.5 * s), (0.05 * s, 0.3 * s),
                      _BOTH_NOISE,
                      _UP_ONLY + ["slow rise followed by rapid decline"],
                      (0.3 * s, 2 * s), unit)
    if kind == "level":  # physical level with daily cycle
        return _block([_SIN], (0.1 * s, 0.5 * s), (96, 1440), _ALL_TREND,
                      (0.3 * s, s), (0.05 * s, 0.4 * s), ["almost no noise"],
                      ["sudden increase", "sudden decrease"] + _WIDE,
                      (0.1 * s, 0.4 * s), unit)
    if kind == "gauge":  # large stable baseline, small relative moves
        return _block([_NONE], (0, 0), (0, 0), _STEADYISH,
                      (0.9 * s, 1.1 * s), (0.002 * s, 0.02 * s),
                      ["almost no noise"], _TWO_PHASE, (0.005 * s, 0.03 * s),
                      unit)
    if kind == "price":  # random-walk-ish market value
        return _block([_NONE], (0, 0), (0, 0), _ALL_TREND, (0.2 * s, 2 * s),
                      (0.02 * s, 0.3 * s), _BOTH_NOISE, _SPIKES + _WIDE,
                      (0.01 * s, 0.2 * s), unit)
    if kind == "volatile":  # noisy bounded signal (wind, vibration)
        return _block([_NONE], (0, 0), (0, 0), _ALL_TREND, (0, 0.5 * s),
                      (0.05 * s, 0.3 * s), ["noisy"],
                      ["shake", "upward spike", "wide upward spike"],
                      (0.1 * s, s), unit)
    raise ValueError(f"unknown metric kind: {kind}")


# Catalog format: (category, unit, {cluster: [(metric, kind[, scale]), ...]}).
# Metric names are original; domain overlap with the reference is inherent to
# naming real-world metrics.
_M = Tuple  # (name, kind) or (name, kind, scale)

CATALOG: List[Tuple[str, str, Dict[str, List[tuple]]]] = [
    ("Web Service", "minute", {
        "Load Metrics": [("CPU Usage", "percent"),
                         ("Request Rate", "rate", 1000),
                         ("Disk IO", "rate", 200),
                         ("Network Throughput", "rate", 500),
                         ("Concurrent Connections", "count", 2000),
                         ("Thread Pool Usage", "percent")],
        "Quality Metrics": [("Error Rate", "error", 30),
                            ("Response Time", "latency", 100),
                            ("P99 Latency", "latency", 400),
                            ("Timeout Count", "error", 50),
                            ("Retry Rate", "error", 20)],
        "Capacity Metrics": [("Memory Usage", "percent_steady"),
                             ("Disk Usage", "percent_steady"),
                             ("Cache Hit Ratio", "hit_ratio"),
                             ("Connection Pool Utilization", "percent"),
                             ("File Descriptor Count", "count", 5000)],
        "Runtime Metrics": [("GC Pause Time", "latency", 50),
                            ("Heap Usage", "percent_steady"),
                            ("Active Sessions", "count", 10000)],
    }),
    ("Environment", "hour", {
        "Thermal Metrics": [("Temperature", "level", 30),
                            ("Humidity", "percent"),
                            ("Dew Point", "level", 20),
                            ("Heat Index", "level", 40)],
        "Atmospheric Metrics": [("Air Pressure", "gauge", 1010),
                                ("Wind Speed", "volatile", 25),
                                ("Wind Gust", "volatile", 40),
                                ("Visibility", "level", 20),
                                ("Cloud Cover", "percent")],
        "Air Quality Metrics": [("PM2.5 Concentration", "queue", 150),
                                ("PM10 Concentration", "queue", 250),
                                ("Ozone Level", "level", 120),
                                ("CO2 Concentration", "gauge", 420),
                                ("NO2 Concentration", "queue", 80)],
        "Hydrology Metrics": [("Rainfall", "volatile", 30),
                              ("River Water Level", "level", 8),
                              ("Soil Moisture", "percent"),
                              ("Reservoir Volume", "percent_steady")],
    }),
    ("Relational Database", "minute", {
        "Query Metrics": [("Query Latency", "latency", 40),
                          ("Transactions Per Second", "rate", 3000),
                          ("Slow Query Count", "error", 40),
                          ("Rows Read Rate", "rate", 50000),
                          ("Table Scan Rate", "rate", 300)],
        "Concurrency Metrics": [("Active Connections", "count", 500),
                                ("Lock Wait Time", "latency", 80),
                                ("Deadlock Count", "error", 10),
                                ("Session Count", "count", 800)],
        "Storage Metrics": [("Buffer Cache Hit Ratio", "hit_ratio"),
                            ("WAL Write Rate", "rate", 100),
                            ("Checkpoint Duration", "latency", 2000),
                            ("Temp File Usage", "queue", 500),
                            ("Tablespace Usage", "percent_steady")],
        "Replication Metrics": [("Replication Lag", "queue", 300),
                                ("Standby Apply Rate", "rate", 2000)],
    }),
    ("Key-Value Store", "minute", {
        "Throughput Metrics": [("Get Operations Rate", "rate", 50000),
                               ("Set Operations Rate", "rate", 20000),
                               ("Eviction Rate", "error", 500),
                               ("Expired Keys Rate", "rate", 1000)],
        "Memory Metrics": [("Memory Fragmentation Ratio", "gauge", 1.2),
                           ("Used Memory", "percent_steady"),
                           ("Key Count", "count", 1000000),
                           ("Dataset Size", "percent_steady")],
        "Latency Metrics": [("Command Latency", "latency", 2),
                            ("Slowlog Entry Count", "error", 20),
                            ("Blocked Clients", "error", 30)],
        "Persistence Metrics": [("Snapshot Duration", "latency", 5000),
                                ("AOF Rewrite Backlog", "queue", 2000),
                                ("Sync Lag", "queue", 100)],
    }),
    ("Message Queue", "minute", {
        "Producer Metrics": [("Publish Rate", "rate", 10000),
                             ("Publish Latency", "latency", 20),
                             ("Producer Error Count", "error", 25)],
        "Consumer Metrics": [("Consume Rate", "rate", 10000),
                             ("Consumer Lag", "queue", 50000),
                             ("Acknowledgement Latency", "latency", 30),
                             ("Redelivery Count", "error", 100)],
        "Broker Metrics": [("Queue Depth", "queue", 100000),
                           ("Partition Count", "count", 200),
                           ("In-Flight Messages", "queue", 5000),
                           ("Broker Disk Usage", "percent_steady"),
                           ("ISR Shrink Events", "error", 8)],
    }),
    ("Container Platform", "minute", {
        "Cluster Metrics": [("Node CPU Utilization", "percent"),
                            ("Node Memory Utilization", "percent_steady"),
                            ("Running Pod Count", "count", 800),
                            ("Pending Pod Count", "queue", 60),
                            ("Node Count", "count", 50)],
        "Scheduling Metrics": [("Scheduling Latency", "latency", 500),
                               ("Pod Restart Count", "error", 15),
                               ("OOM Kill Count", "error", 10),
                               ("Image Pull Duration", "latency", 8000)],
        "Control Plane Metrics": [("API Server Request Rate", "rate", 2000),
                                  ("API Server Latency", "latency", 100),
                                  ("etcd Commit Latency", "latency", 25),
                                  ("Watch Event Rate", "rate", 5000),
                                  ("Controller Queue Depth", "queue", 300)],
        "Autoscaling Metrics": [("Replica Count", "count", 100),
                                ("Scale-Up Events", "error", 10)],
    }),
    ("Microservice Mesh", "minute", {
        "Traffic Metrics": [("Inbound Request Rate", "rate", 5000),
                            ("Outbound Request Rate", "rate", 5000),
                            ("gRPC Stream Count", "count", 1000),
                            ("Circuit Breaker Open Count", "error", 12)],
        "Latency Metrics": [("Service Latency", "latency", 60),
                            ("Upstream Latency", "latency", 50),
                            ("Sidecar Overhead", "latency", 5),
                            ("Retry Latency Penalty", "latency", 80)],
        "Reliability Metrics": [("HTTP 5xx Rate", "error", 40),
                                ("HTTP 4xx Rate", "error", 80),
                                ("Connection Failure Rate", "error", 25),
                                ("Success Rate", "hit_ratio"),
                                ("Outlier Ejection Count", "error", 10)],
    }),
    ("Network Infrastructure", "minute", {
        "Traffic Metrics": [("Interface Throughput", "rate", 8000),
                            ("Packets Per Second", "rate", 500000),
                            ("Broadcast Rate", "rate", 2000),
                            ("Multicast Rate", "rate", 1000)],
        "Quality Metrics": [("Packet Loss Rate", "error", 5),
                            ("Round Trip Time", "latency", 80),
                            ("Jitter", "volatile", 20),
                            ("Retransmission Rate", "error", 8),
                            ("CRC Error Count", "error", 15)],
        "Device Metrics": [("Switch CPU Utilization", "percent"),
                           ("Switch Memory Utilization", "percent_steady"),
                           ("Interface Utilization", "percent"),
                           ("BGP Session Flaps", "error", 6),
                           ("Firewall Session Count", "count", 100000)],
    }),
    ("Content Delivery", "minute", {
        "Edge Metrics": [("Edge Request Rate", "rate", 20000),
                         ("Edge Cache Hit Ratio", "hit_ratio"),
                         ("Origin Fetch Rate", "rate", 2000),
                         ("Edge Bandwidth", "rate", 10000)],
        "Performance Metrics": [("Time To First Byte", "latency", 150),
                                ("Download Speed", "rate", 100),
                                ("SSL Handshake Time", "latency", 60),
                                ("DNS Resolution Time", "latency", 30)],
        "Reliability Metrics": [("Edge Error Rate", "error", 20),
                                ("Origin Error Rate", "error", 15),
                                ("Stale Serve Count", "error", 40)],
    }),
    ("Mobile Application", "hour", {
        "Engagement Metrics": [("Daily Active Users", "count", 500000),
                               ("Session Duration", "latency", 900),
                               ("Screen View Rate", "rate", 100000),
                               ("Push Open Rate", "percent")],
        "Performance Metrics": [("App Launch Time", "latency", 2000),
                                ("Frame Drop Rate", "error", 10),
                                ("ANR Count", "error", 20),
                                ("Crash Count", "error", 50),
                                ("API Call Latency", "latency", 300)],
        "Resource Metrics": [("Battery Drain Rate", "percent"),
                             ("App Memory Footprint", "percent_steady"),
                             ("Cellular Data Usage", "rate", 50)],
    }),
    ("E-commerce", "hour", {
        "Sales Metrics": [("Order Volume", "rate", 3000),
                          ("Gross Merchandise Value", "rate", 100000),
                          ("Average Order Value", "gauge", 80),
                          ("Refund Count", "error", 60),
                          ("Coupon Redemption Rate", "percent")],
        "Funnel Metrics": [("Page Views", "rate", 200000),
                           ("Cart Addition Rate", "rate", 10000),
                           ("Checkout Conversion Rate", "percent"),
                           ("Cart Abandonment Rate", "percent"),
                           ("Search Query Volume", "rate", 50000)],
        "Inventory Metrics": [("Stock Level", "percent_steady"),
                              ("Out-of-Stock Count", "error", 100),
                              ("Warehouse Pick Rate", "rate", 2000),
                              ("Fulfillment Delay", "queue", 500)],
    }),
    ("Finance", "day", {
        "Price Metrics": [("Stock Price", "price", 200),
                          ("Exchange Rate", "price", 5),
                          ("Commodity Price", "price", 800),
                          ("Cryptocurrency Price", "price", 40000),
                          ("Bond Yield", "price", 4)],
        "Activity Metrics": [("Trading Volume", "rate", 5000000),
                             ("Order Book Depth", "count", 100000),
                             ("Trade Count", "rate", 100000),
                             ("Open Interest", "count", 500000)],
        "Risk Metrics": [("Volatility Index", "volatile", 40),
                         ("Credit Spread", "price", 2),
                         ("Margin Utilization", "percent"),
                         ("Value at Risk", "queue", 1000000),
                         ("Default Rate", "error", 3)],
    }),
    ("Manufacturing", "minute", {
        "Production Metrics": [("Units Produced", "rate", 1000),
                               ("Production Line Speed", "rate", 120),
                               ("Cycle Time", "latency", 90),
                               ("Changeover Duration", "latency", 1800),
                               ("Yield Rate", "hit_ratio")],
        "Equipment Metrics": [("Spindle Vibration", "volatile", 8),
                              ("Motor Temperature", "level", 80),
                              ("Hydraulic Pressure", "gauge", 200),
                              ("Tool Wear Index", "percent_steady"),
                              ("Machine Utilization", "percent")],
        "Quality Metrics": [("Defect Count", "error", 50),
                            ("Rework Rate", "error", 20),
                            ("Scrap Weight", "error", 100),
                            ("First Pass Yield", "hit_ratio")],
    }),
    ("Power Grid", "minute", {
        "Generation Metrics": [("Generation Output", "rate", 500),
                               ("Solar Generation", "level", 300),
                               ("Wind Generation", "volatile", 200),
                               ("Hydro Reservoir Level", "percent_steady"),
                               ("Spinning Reserve", "percent")],
        "Demand Metrics": [("System Load", "rate", 2000),
                           ("Peak Demand", "rate", 2500),
                           ("Load Factor", "percent"),
                           ("Demand Response Capacity", "count", 300)],
        "Stability Metrics": [("Grid Frequency", "gauge", 50),
                              ("Bus Voltage", "gauge", 230),
                              ("Line Loading", "percent"),
                              ("Power Factor", "gauge", 0.95),
                              ("Transformer Temperature", "level", 70)],
    }),
    ("Healthcare Monitoring", "hour", {
        "Vital Signs": [("Heart Rate", "level", 75),
                        ("Blood Pressure Systolic", "gauge", 120),
                        ("Respiratory Rate", "level", 16),
                        ("Body Temperature", "gauge", 37),
                        ("Oxygen Saturation", "hit_ratio")],
        "Facility Metrics": [("Bed Occupancy Rate", "percent"),
                             ("Emergency Admissions", "rate", 50),
                             ("Average Wait Time", "latency", 120),
                             ("Surgery Schedule Utilization", "percent"),
                             ("Discharge Count", "rate", 40)],
        "Operations Metrics": [("Medication Dispense Rate", "rate", 300),
                               ("Lab Turnaround Time", "latency", 180),
                               ("Staff-to-Patient Ratio", "gauge", 0.25)],
    }),
    ("Transportation", "hour", {
        "Traffic Metrics": [("Vehicle Count", "rate", 2000),
                            ("Average Speed", "level", 60),
                            ("Congestion Index", "percent"),
                            ("Intersection Queue Length", "queue", 50),
                            ("Travel Time", "latency", 45)],
        "Transit Metrics": [("Passenger Volume", "rate", 10000),
                            ("On-Time Performance", "hit_ratio"),
                            ("Headway Deviation", "volatile", 5),
                            ("Fleet Availability", "percent")],
        "Safety Metrics": [("Incident Count", "error", 10),
                           ("Hard Braking Events", "error", 30),
                           ("Signal Fault Count", "error", 5)],
    }),
    ("Agriculture", "hour", {
        "Field Metrics": [("Soil Temperature", "level", 22),
                          ("Field Soil Moisture", "percent"),
                          ("Leaf Wetness", "percent"),
                          ("Canopy Temperature", "level", 28),
                          ("Evapotranspiration Rate", "level", 5)],
        "Irrigation Metrics": [("Irrigation Flow Rate", "rate", 100),
                               ("Water Tank Level", "percent_steady"),
                               ("Pump Pressure", "gauge", 4),
                               ("Drip Line Pressure", "gauge", 1.5)],
        "Livestock Metrics": [("Barn Temperature", "level", 24),
                              ("Feed Consumption", "rate", 500),
                              ("Milk Yield", "rate", 1200),
                              ("Activity Index", "percent")],
    }),
    ("Smart Building", "minute", {
        "HVAC Metrics": [("Zone Temperature", "level", 23),
                         ("Supply Air Flow", "rate", 2000),
                         ("Chiller Load", "percent"),
                         ("Boiler Pressure", "gauge", 3),
                         ("Filter Differential Pressure", "percent_steady")],
        "Energy Metrics": [("Building Power Draw", "rate", 400),
                           ("Lighting Energy", "rate", 80),
                           ("Elevator Energy", "rate", 40),
                           ("Solar Panel Output", "level", 100)],
        "Occupancy Metrics": [("Occupancy Count", "count", 800),
                              ("Badge-In Rate", "rate", 200),
                              ("Meeting Room Utilization", "percent"),
                              ("Indoor CO2 Level", "queue", 1200)],
    }),
    ("Telecommunications", "minute", {
        "Radio Metrics": [("Cell Throughput", "rate", 800),
                          ("PRB Utilization", "percent"),
                          ("RSRP Level", "gauge", -95),
                          ("SINR", "level", 15),
                          ("Active UE Count", "count", 400)],
        "Core Metrics": [("Session Establishment Rate", "rate", 3000),
                         ("Paging Success Rate", "hit_ratio"),
                         ("Handover Success Rate", "hit_ratio"),
                         ("Registration Failures", "error", 50),
                         ("Bearer Setup Latency", "latency", 60)],
        "Voice Metrics": [("Call Setup Time", "latency", 3000),
                          ("Call Drop Rate", "error", 5),
                          ("Voice Quality Score", "gauge", 4.2),
                          ("Concurrent Calls", "count", 5000)],
    }),
    ("Logistics", "hour", {
        "Delivery Metrics": [("Shipments Dispatched", "rate", 5000),
                             ("On-Time Delivery Rate", "hit_ratio"),
                             ("Average Delivery Time", "latency", 2880),
                             ("Failed Delivery Count", "error", 100),
                             ("Returns Volume", "error", 200)],
        "Warehouse Metrics": [("Inbound Pallet Rate", "rate", 300),
                              ("Outbound Pallet Rate", "rate", 300),
                              ("Storage Utilization", "percent_steady"),
                              ("Dock Door Occupancy", "percent"),
                              ("Picking Accuracy", "hit_ratio")],
        "Fleet Metrics": [("Fleet Fuel Consumption", "rate", 2000),
                          ("Vehicle Idle Time", "queue", 120),
                          ("Route Deviation Count", "error", 30)],
    }),
    ("Online Gaming", "minute", {
        "Player Metrics": [("Concurrent Players", "count", 100000),
                           ("Matchmaking Queue Time", "queue", 90),
                           ("New Session Rate", "rate", 5000),
                           ("Churn Events", "error", 200)],
        "Server Metrics": [("Server Tick Rate", "gauge", 60),
                           ("Game Server CPU", "percent"),
                           ("Instance Count", "count", 500),
                           ("World State Size", "percent_steady")],
        "Experience Metrics": [("Player Ping", "latency", 60),
                               ("Packet Loss Events", "error", 20),
                               ("Disconnect Rate", "error", 15),
                               ("Cheat Detection Flags", "error", 10)],
    }),
    ("Streaming Media", "minute", {
        "Playback Metrics": [("Concurrent Streams", "count", 200000),
                             ("Playback Start Time", "latency", 1500),
                             ("Rebuffer Ratio", "error", 5),
                             ("Average Bitrate", "level", 6000),
                             ("Bitrate Switch Count", "error", 40)],
        "Delivery Metrics": [("Stream Request Rate", "rate", 50000),
                             ("Manifest Fetch Latency", "latency", 80),
                             ("Segment Error Rate", "error", 10),
                             ("Origin Egress", "rate", 20000)],
        "Engagement Metrics": [("Watch Time", "rate", 500000),
                               ("Completion Rate", "percent"),
                               ("Concurrent Live Viewers", "count", 500000)],
    }),
    ("Social Platform", "hour", {
        "Activity Metrics": [("Posts Created", "rate", 100000),
                             ("Comments Rate", "rate", 300000),
                             ("Likes Rate", "rate", 1000000),
                             ("Share Rate", "rate", 50000),
                             ("Active User Count", "count", 2000000)],
        "Moderation Metrics": [("Reported Content Count", "error", 500),
                               ("Moderation Queue Depth", "queue", 2000),
                               ("Auto-Removal Rate", "error", 300),
                               ("Appeal Volume", "error", 100)],
        "Growth Metrics": [("Signup Rate", "rate", 5000),
                           ("Retention Rate", "percent"),
                           ("Feed Load Latency", "latency", 250)],
    }),
    ("Industrial IoT", "minute", {
        "Sensor Metrics": [("Bearing Vibration RMS", "volatile", 6),
                           ("Acoustic Emission Level", "volatile", 70),
                           ("Shaft Rotation Speed", "gauge", 1800),
                           ("Coolant Flow Rate", "rate", 60),
                           ("Lubricant Particle Count", "queue", 500),
                           ("Sensor Battery Level", "percent_steady")],
        "Process Metrics": [("Furnace Temperature", "level", 950),
                            ("Reactor Pressure", "gauge", 12),
                            ("Conveyor Load", "percent"),
                            ("Valve Open Position", "percent"),
                            ("Steam Flow", "rate", 40)],
        "Connectivity Metrics": [("Gateway Uplink Rate", "rate", 200),
                                 ("Telemetry Drop Count", "error", 30),
                                 ("Device Heartbeat Misses", "error", 15),
                                 ("OTA Update Failures", "error", 8),
                                 ("Edge Buffer Backlog", "queue", 2000),
                                 ("Packet Retry Ratio", "error", 10)],
    }),
    ("Oil & Gas", "minute", {
        "Production Metrics": [("Wellhead Pressure", "gauge", 250),
                               ("Oil Flow Rate", "rate", 800),
                               ("Gas Flow Rate", "rate", 1500),
                               ("Water Cut", "percent"),
                               ("Choke Valve Opening", "percent")],
        "Pipeline Metrics": [("Pipeline Pressure", "gauge", 70),
                             ("Pipeline Flow", "rate", 2000),
                             ("Pump Station Power", "rate", 900),
                             ("Leak Detection Alarms", "error", 5),
                             ("Pig Run Duration", "latency", 7200)],
        "Refinery Metrics": [("Distillation Column Temperature", "level", 350),
                             ("Catalyst Activity Index", "percent_steady"),
                             ("Flare Gas Volume", "error", 300),
                             ("Throughput Barrels", "rate", 5000),
                             ("Sulfur Content", "gauge", 0.5)],
    }),
    ("Water Treatment", "hour", {
        "Intake Metrics": [("Raw Water Turbidity", "queue", 40),
                           ("Intake Flow Rate", "rate", 1200),
                           ("Reservoir Level", "percent_steady"),
                           ("Raw Water pH", "gauge", 7.2)],
        "Process Metrics": [("Chlorine Dosage", "level", 2),
                            ("Filter Head Loss", "percent_steady"),
                            ("Membrane Differential Pressure", "percent_steady"),
                            ("Backwash Frequency", "error", 6),
                            ("Coagulant Feed Rate", "rate", 50),
                            ("UV Transmittance", "hit_ratio"),
                            ("Ozone Generator Output", "level", 3)],
        "Distribution Metrics": [("Distribution Pressure", "gauge", 5),
                                 ("Pump Energy Use", "rate", 300),
                                 ("Main Break Events", "error", 3),
                                 ("Residual Chlorine", "gauge", 0.8),
                                 ("Non-Revenue Water Ratio", "percent")],
    }),
    ("Renewable Energy Plant", "minute", {
        "Solar Metrics": [("Array Irradiance", "level", 900),
                          ("Inverter Output Power", "level", 2000),
                          ("Panel Temperature", "level", 45),
                          ("Inverter Efficiency", "hit_ratio"),
                          ("String Current Imbalance", "error", 10)],
        "Wind Metrics": [("Turbine Power Output", "volatile", 3000),
                         ("Rotor Speed", "volatile", 15),
                         ("Blade Pitch Angle", "level", 20),
                         ("Gearbox Oil Temperature", "level", 65),
                         ("Nacelle Vibration", "volatile", 4)],
        "Storage Metrics": [("Battery State of Charge", "percent_steady"),
                            ("Charge Rate", "rate", 500),
                            ("Discharge Rate", "rate", 500),
                            ("Cell Temperature Spread", "volatile", 6),
                            ("Round-Trip Efficiency", "hit_ratio")],
    }),
    ("Data Center Facility", "minute", {
        "Power Metrics": [("Total Facility Power", "rate", 4000),
                          ("IT Load Power", "rate", 2800),
                          ("PUE", "gauge", 1.4),
                          ("UPS Battery Charge", "percent_steady"),
                          ("Generator Fuel Level", "percent_steady")],
        "Cooling Metrics": [("Cold Aisle Temperature", "level", 22),
                            ("Hot Aisle Temperature", "level", 35),
                            ("CRAC Fan Speed", "percent"),
                            ("Chilled Water Supply Temperature", "level", 8),
                            ("Humidity Level", "percent")],
        "Capacity Metrics": [("Rack Space Utilization", "percent_steady"),
                             ("Power Circuit Utilization", "percent"),
                             ("Cross-Connect Count", "count", 2000),
                             ("Thermal Alarm Count", "error", 8),
                             ("Water Usage Effectiveness", "gauge", 1.8)],
    }),
    ("Rail Operations", "hour", {
        "Service Metrics": [("Trains In Service", "count", 200),
                            ("Schedule Adherence", "hit_ratio"),
                            ("Average Dwell Time", "latency", 90),
                            ("Passenger Load Factor", "percent"),
                            ("Station Throughput", "rate", 20000)],
        "Infrastructure Metrics": [("Track Circuit Failures", "error", 4),
                                   ("Switch Machine Faults", "error", 3),
                                   ("Catenary Voltage", "gauge", 25000),
                                   ("Rail Temperature", "level", 35),
                                   ("Signal System Availability", "hit_ratio")],
        "Rolling Stock Metrics": [("Traction Energy Use", "rate", 1500),
                                  ("Brake Pad Wear Index", "percent_steady"),
                                  ("Door Fault Count", "error", 10),
                                  ("HVAC Faults Per Fleet", "error", 6)],
    }),
    ("Aviation Operations", "hour", {
        "Flight Metrics": [("Departures Per Hour", "rate", 60),
                           ("Arrival Delay", "queue", 45),
                           ("Gate Turnaround Time", "latency", 50),
                           ("Load Factor", "percent"),
                           ("Fuel Uplift Volume", "rate", 80000)],
        "Airport Metrics": [("Security Queue Length", "queue", 300),
                            ("Baggage Mishandle Count", "error", 25),
                            ("Runway Occupancy Rate", "percent"),
                            ("Stand Availability", "percent"),
                            ("De-icing Queue", "queue", 12)],
        "Maintenance Metrics": [("AOG Event Count", "error", 3),
                                ("Unscheduled Removals", "error", 5),
                                ("Engine EGT Margin", "percent_steady"),
                                ("MEL Deferral Count", "queue", 20)],
    }),
    ("Maritime Shipping", "day", {
        "Voyage Metrics": [("Vessel Speed", "level", 18),
                           ("Fuel Consumption", "rate", 40),
                           ("ETA Deviation", "queue", 12),
                           ("Cargo Utilization", "percent"),
                           ("Weather Routing Deviations", "error", 4)],
        "Port Metrics": [("Berth Occupancy", "percent"),
                         ("Container Moves Per Hour", "rate", 120),
                         ("Yard Utilization", "percent_steady"),
                         ("Gate Truck Queue", "queue", 80),
                         ("Crane Availability", "percent")],
        "Engine Metrics": [("Main Engine RPM", "gauge", 90),
                           ("Cylinder Exhaust Temperature", "level", 380),
                           ("Turbocharger Speed", "gauge", 12000),
                           ("Lube Oil Pressure", "gauge", 4.5),
                           ("Shaft Power", "rate", 15000),
                           ("SFOC", "gauge", 180)],
    }),
    ("CI/CD Platform", "minute", {
        "Pipeline Metrics": [("Builds Triggered", "rate", 300),
                             ("Build Duration", "latency", 600),
                             ("Queue Wait Time", "queue", 300),
                             ("Build Failure Count", "error", 40),
                             ("Flaky Test Detections", "error", 25)],
        "Artifact Metrics": [("Artifact Upload Rate", "rate", 100),
                             ("Registry Storage Used", "percent_steady"),
                             ("Cache Hit Ratio", "hit_ratio"),
                             ("Artifact Pull Latency", "latency", 400)],
        "Runner Metrics": [("Active Runners", "count", 400),
                           ("Runner CPU Saturation", "percent"),
                           ("Provisioning Latency", "latency", 90000),
                           ("Spot Instance Evictions", "error", 12),
                           ("Deploy Rollback Count", "error", 5),
                           ("Concurrent Jobs", "count", 1000)],
    }),
]


def build_metric_set() -> List[dict]:
    """Expand the catalog into the reference metric_set.json schema."""
    out: List[dict] = []
    for category, unit, clusters in CATALOG:
        metrics: List[str] = []
        attrs: Dict[str, dict] = {}
        cluster_map: Dict[str, List[str]] = {}
        for cname, members in clusters.items():
            names = []
            for member in members:
                name, kind = member[0], member[1]
                scale = float(member[2]) if len(member) > 2 else 100.0
                names.append(name)
                metrics.append(name)
                attrs[name] = _profile(kind, scale, unit)
            cluster_map[cname] = names
        out.append({
            "category": category,
            "metrics": metrics,
            "cluster": cluster_map,
            "attributes": attrs,
        })
    return out


if __name__ == "__main__":  # export: python -m chatts_tpu_torch.datagen.metric_catalog out.json
    import json
    import sys

    data = build_metric_set()
    n_metrics = sum(len(c["metrics"]) for c in data)
    text = json.dumps(data, indent=2, ensure_ascii=False)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(text)
    print(f"{len(data)} categories, {n_metrics} metrics, "
          f"{len(text.splitlines())} JSON lines")
