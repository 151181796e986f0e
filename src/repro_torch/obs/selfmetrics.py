"""Monitor self-telemetry: the session pipeline mirrored into a
`MetricRegistry` (port of `repro/obs/selfmetrics.py`; only the imports
differ: the shape-bucket accounting read at scrape time is the port's
`repro_torch.detect.SHAPE_CACHE`).

The monitor watches the fleet; this module watches the monitor. Every
component on the hot path already keeps cumulative accounting (the columnar
ring counts appends/overwrites/name clips, agents count flush bytes and
wire-encode time, the aggregator counts ingest/loss and per-node recency,
the online detector counts refits, the incident engine holds pending flags)
— `SessionObs` registers one collector callback that mirrors those stats
into counters/gauges/histograms *at scrape time*, so being observable adds
nothing to the per-event cost.

Node freshness classifies each fleet node by how far its last ingested
event trails the fleet clock (``t_latest``): ``healthy`` within
``degraded_after_s``, ``degraded`` within ``stale_after_s``, ``stale``
beyond — a node whose agent stops flushing flips to stale while the rest of
the fleet keeps the clock moving.

`METRIC_NAMES` is the closed catalogue of self-metric families; the docs
gate (`tools/check_docs.py`) fails when `docs/observability.md` misses one.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricRegistry

NODE_STATES = ("healthy", "degraded", "stale")
STATE_CODE = {s: i for i, s in enumerate(NODE_STATES)}

# detection sweeps: ~0.1 ms no-op ticks to multi-second cold refits
DETECT_MS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                     1000.0, 2500.0, 5000.0)

# The self-metric catalogue: every family SessionObs registers, in render
# order. tools/check_docs.py requires each name in docs/observability.md.
METRIC_NAMES = (
    # per-node event ring (EventTable) + probe suite
    "eacgm_ring_events_appended_total",
    "eacgm_ring_events_dropped_total",
    "eacgm_ring_names_truncated_total",
    "eacgm_ring_occupancy",
    "eacgm_ring_capacity",
    "eacgm_probe_events_emitted_total",
    # per-node agent (wire transport + backpressure governor)
    "eacgm_agent_flushes_total",
    "eacgm_agent_events_shipped_total",
    "eacgm_agent_events_shed_total",
    "eacgm_agent_bytes_shipped_total",
    "eacgm_agent_encode_seconds_total",
    "eacgm_governor_budget_events",
    # fleet aggregation + per-node freshness
    "eacgm_fleet_nodes",
    "eacgm_fleet_events_ingested_total",
    "eacgm_fleet_events_dropped_at_source_total",
    "eacgm_fleet_events_shed_total",
    "eacgm_fleet_lost_batches_total",
    "eacgm_fleet_ingest_events_per_s",
    # hierarchical plane: group tier (repro.fleet)
    "eacgm_fleet_groups",
    "eacgm_fleet_group_nodes",
    "eacgm_fleet_group_events_ingested_total",
    "eacgm_fleet_group_freshness_seconds",
    "eacgm_fleet_group_state",
    "eacgm_window_occupancy",
    "eacgm_window_evicted_total",
    "eacgm_window_names_truncated_total",
    "eacgm_node_freshness_seconds",
    "eacgm_node_state",
    # detection
    "eacgm_detector_warm_refits_total",
    "eacgm_detector_cold_refits_total",
    "eacgm_detector_log_delta",
    "eacgm_detector_flag_rate",
    "eacgm_detect_ticks_total",
    "eacgm_detect_ms",
    # async detection plane (repro.detect): executor + staleness + compile
    # cache accounting
    "eacgm_detect_sweeps_submitted_total",
    "eacgm_detect_sweeps_completed_total",
    "eacgm_detect_sweeps_coalesced_total",
    "eacgm_detect_sweep_errors_total",
    "eacgm_detect_queue_depth",
    "eacgm_detect_busy_seconds_total",
    "eacgm_detect_lag_seconds",
    "eacgm_detect_lag_steps",
    "eacgm_detect_compile_cache_hits_total",
    "eacgm_detect_compile_cache_misses_total",
    # incidents, diagnoses, governor actions
    "eacgm_incident_pending_flags",
    "eacgm_incidents_total",
    "eacgm_diagnoses_total",
    "eacgm_actions_total",
    # request plane (continuous-batching serve engine + SLO monitor)
    "eacgm_serve_requests_total",
    "eacgm_serve_tokens_total",
    "eacgm_serve_queue_wait_seconds_mean",
    "eacgm_serve_ttft_seconds_mean",
    "eacgm_serve_tpot_seconds_mean",
    "eacgm_serve_client_stall_seconds_total",
    "eacgm_serve_queue_depth",
    "eacgm_serve_occupancy",
    "eacgm_serve_slo_breaches_total",
    "eacgm_serve_slo_breach_incidents_total",
    # the observability layer itself
    "eacgm_monitor_uptime_seconds",
    "eacgm_obs_scrapes_total",
    "eacgm_obs_labels_dropped_total",
)


class SessionObs:
    """Self-telemetry of one monitoring `Session`.

    Owned by the session (created when any live sink binds); the
    ``prometheus`` and ``board`` sinks share it, so the endpoint, the
    exposition file, and the status board all read one registry.
    """

    def __init__(self, session, degraded_after_s: float = 5.0,
                 stale_after_s: float = 15.0, max_label_sets: int = 64):
        self.session = session
        self.degraded_after_s = float(degraded_after_s)
        self.stale_after_s = float(stale_after_s)
        self.registry = MetricRegistry(max_label_sets=max_label_sets)
        self._t0 = time.time()
        self._seen_ticks = 0
        self._seen_detect_s = 0.0
        self._last_ingest = (0, self._t0)  # (events_ingested, wall clock)
        self._build_metrics()
        self.registry.add_collector(self._collect)

    # -- metric families ------------------------------------------------------
    def _build_metrics(self) -> None:
        r = self.registry
        self.ring_appended = r.counter(
            "eacgm_ring_events_appended_total",
            "Rows appended to the node's columnar event ring (lifetime)",
            labels=("node",))
        self.ring_dropped = r.counter(
            "eacgm_ring_events_dropped_total",
            "Ring overflow: oldest rows overwritten before being drained",
            labels=("node",))
        self.ring_truncated = r.counter(
            "eacgm_ring_names_truncated_total",
            "Event names clipped to the fixed column width on append",
            labels=("node",))
        self.ring_occupancy = r.gauge(
            "eacgm_ring_occupancy",
            "Rows currently buffered in the node's event ring",
            labels=("node",))
        self.ring_capacity = r.gauge(
            "eacgm_ring_capacity", "Event ring capacity (rows)",
            labels=("node",))
        self.probe_emitted = r.counter(
            "eacgm_probe_events_emitted_total",
            "Events emitted per probe (lifetime)",
            labels=("node", "probe"))
        self.agent_flushes = r.counter(
            "eacgm_agent_flushes_total",
            "Wire flushes performed by the node agent",
            labels=("node",))
        self.agent_events = r.counter(
            "eacgm_agent_events_shipped_total",
            "Events shipped onto the wire by the node agent",
            labels=("node",))
        self.agent_shed = r.counter(
            "eacgm_agent_events_shed_total",
            "Events sampled out by the node's backpressure governor "
            "before encoding (stratified per-layer shedding)",
            labels=("node",))
        self.agent_bytes = r.counter(
            "eacgm_agent_bytes_shipped_total",
            "Wire bytes shipped by the node agent",
            labels=("node",))
        self.agent_encode_s = r.counter(
            "eacgm_agent_encode_seconds_total",
            "Cumulative wall time spent wire-encoding flushes",
            labels=("node",))
        self.gov_budget = r.gauge(
            "eacgm_governor_budget_events",
            "Current AIMD admission budget (events per flush) of the "
            "node's backpressure governor", labels=("node",))
        self.fleet_nodes = r.gauge(
            "eacgm_fleet_nodes", "Nodes the fleet aggregator has seen")
        self.fleet_ingested = r.counter(
            "eacgm_fleet_events_ingested_total",
            "Events merged into the per-layer sliding windows")
        self.fleet_dropped_src = r.counter(
            "eacgm_fleet_events_dropped_at_source_total",
            "Events reported dropped at the source rings (per-batch counts)")
        self.fleet_shed = r.counter(
            "eacgm_fleet_events_shed_total",
            "Events reported shed by agent governors (per-batch counts) — "
            "the receiver-side mirror of eacgm_agent_events_shed_total")
        self.fleet_lost = r.counter(
            "eacgm_fleet_lost_batches_total",
            "Wire batches missing from per-node sequence numbers")
        self.fleet_rate = r.gauge(
            "eacgm_fleet_ingest_events_per_s",
            "Ingest rate since the previous collection")
        self.fleet_groups = r.gauge(
            "eacgm_fleet_groups",
            "Group aggregators in the hierarchical tree (0 = flat monitor)")
        self.group_nodes = r.gauge(
            "eacgm_fleet_group_nodes",
            "Nodes aggregated by the group", labels=("group",))
        self.group_ingested = r.counter(
            "eacgm_fleet_group_events_ingested_total",
            "Events merged into the group's sliding windows",
            labels=("group",))
        self.group_freshness = r.gauge(
            "eacgm_fleet_group_freshness_seconds",
            "Fleet-clock seconds the group's newest event trails the fleet",
            labels=("group",))
        self.group_state = r.gauge(
            "eacgm_fleet_group_state",
            "Group freshness state: 0=healthy 1=degraded 2=stale",
            labels=("group",))
        self.window_occupancy = r.gauge(
            "eacgm_window_occupancy",
            "Rows in the layer's sliding window", labels=("layer",))
        self.window_evicted = r.counter(
            "eacgm_window_evicted_total",
            "Rows evicted from the layer window (horizon or overflow)",
            labels=("layer",))
        self.window_truncated = r.counter(
            "eacgm_window_names_truncated_total",
            "Names clipped to the fixed width on window ingest",
            labels=("layer",))
        self.node_freshness = r.gauge(
            "eacgm_node_freshness_seconds",
            "Fleet-clock seconds since the node's last ingested event",
            labels=("node",))
        self.node_state = r.gauge(
            "eacgm_node_state",
            "Node freshness state: 0=healthy 1=degraded 2=stale",
            labels=("node",))
        self.det_warm = r.counter(
            "eacgm_detector_warm_refits_total",
            "Warm-started EM refits per layer", labels=("layer",))
        self.det_cold = r.counter(
            "eacgm_detector_cold_refits_total",
            "Drift-triggered cold refits per layer", labels=("layer",))
        self.det_delta = r.gauge(
            "eacgm_detector_log_delta",
            "Current anomaly threshold (nats) per layer", labels=("layer",))
        self.det_flag_rate = r.gauge(
            "eacgm_detector_flag_rate",
            "Anomaly rate of the most recent detection per layer",
            labels=("layer",))
        self.det_ticks = r.counter(
            "eacgm_detect_ticks_total", "Detection sweeps/ticks run")
        self.detect_ms = r.histogram(
            "eacgm_detect_ms", "Per-sweep detection wall time (ms)",
            buckets=DETECT_MS_BUCKETS)
        self.sweeps_submitted = r.counter(
            "eacgm_detect_sweeps_submitted_total",
            "Detection sweeps handed to the async executor")
        self.sweeps_completed = r.counter(
            "eacgm_detect_sweeps_completed_total",
            "Detection sweeps the executor finished (including errors)")
        self.sweeps_coalesced = r.counter(
            "eacgm_detect_sweeps_coalesced_total",
            "Queued sweeps replaced by a newer snapshot before starting "
            "(backpressure: the plane is slower than the cadence)")
        self.sweep_errors = r.counter(
            "eacgm_detect_sweep_errors_total",
            "Sweeps that raised on the executor worker")
        self.detect_queue_depth = r.gauge(
            "eacgm_detect_queue_depth",
            "Sweeps queued or running on the executor right now")
        self.detect_busy_s = r.counter(
            "eacgm_detect_busy_seconds_total",
            "Cumulative wall time the executor worker spent inside sweeps")
        self.detect_lag_s = r.gauge(
            "eacgm_detect_lag_seconds",
            "Submit-to-finish latency of the most recently admitted sweep "
            "(staleness of the published detections, wall clock)")
        self.detect_lag_steps = r.gauge(
            "eacgm_detect_lag_steps",
            "Cadence points between the most recently admitted sweep's "
            "snapshot and its publication (0 = same step / inline)")
        self.compile_hits = r.counter(
            "eacgm_detect_compile_cache_hits_total",
            "Detection kernel calls that reused an already-compiled "
            "shape-bucket signature")
        self.compile_misses = r.counter(
            "eacgm_detect_compile_cache_misses_total",
            "Detection kernel calls whose shape-bucket signature compiled "
            "for the first time this process")
        self.incident_pending = r.gauge(
            "eacgm_incident_pending_flags",
            "Flag rows pending in open (not yet finalised) incident "
            "clusters")
        self.incidents_total = r.counter(
            "eacgm_incidents_total",
            "Finalised incidents by suspect layer", labels=("layer",))
        self.diagnoses_total = r.counter(
            "eacgm_diagnoses_total",
            "Root-cause diagnoses emitted, by blamed fault kind",
            labels=("kind",))
        self.actions_total = r.counter(
            "eacgm_actions_total",
            "Governor actions recommended, by action kind",
            labels=("kind",))
        self.serve_requests = r.counter(
            "eacgm_serve_requests_total",
            "Requests finished by the monitored serve engine")
        self.serve_tokens = r.counter(
            "eacgm_serve_tokens_total",
            "Tokens generated by the monitored serve engine")
        self.serve_queue_wait = r.gauge(
            "eacgm_serve_queue_wait_seconds_mean",
            "Mean enqueue-to-admission wait over finished requests")
        self.serve_ttft = r.gauge(
            "eacgm_serve_ttft_seconds_mean",
            "Mean time-to-first-token (queue wait included) over "
            "finished requests")
        self.serve_tpot = r.gauge(
            "eacgm_serve_tpot_seconds_mean",
            "Mean inter-token delivery time over finished requests")
        self.serve_stall = r.counter(
            "eacgm_serve_client_stall_seconds_total",
            "Cumulative client-side delivery stall folded into requests")
        self.serve_queue_depth = r.gauge(
            "eacgm_serve_queue_depth",
            "Admission-queue depth at the last engine sample")
        self.serve_occupancy = r.gauge(
            "eacgm_serve_occupancy",
            "Slot occupancy (0..1) at the last engine sample")
        self.serve_breaches = r.counter(
            "eacgm_serve_slo_breaches_total",
            "Request rows that exceeded their SLO target")
        self.serve_breach_incidents = r.counter(
            "eacgm_serve_slo_breach_incidents_total",
            "Closed SLO-breach incidents (request plane)")
        self.uptime = r.gauge(
            "eacgm_monitor_uptime_seconds",
            "Seconds since the session's observability layer came up")
        self.scrapes = r.counter(
            "eacgm_obs_scrapes_total",
            "Exposition renders served (endpoint scrapes + file writes)")

    # -- collection -----------------------------------------------------------
    def _collect(self) -> None:
        s = self.session
        self.uptime.set(time.time() - self._t0)
        for nid, handle in list(s._nodes.items()):
            buf = handle.collector.buffer
            node = str(nid)
            self.ring_appended.set_total(buf.pushed, node=node)
            self.ring_dropped.set_total(buf.dropped, node=node)
            self.ring_truncated.set_total(buf.names_truncated, node=node)
            self.ring_occupancy.set(len(buf), node=node)
            self.ring_capacity.set(buf.capacity, node=node)
            for p in handle.collector.probes:
                self.probe_emitted.set_total(p.emitted, node=node,
                                             probe=p.name)
        backend = s._backend
        if s.spec.mode == "stream" and backend is not None:
            self._collect_stream(backend.monitor)
        elif backend is not None:
            for layer, det in list(backend.flags().items()):
                self.det_flag_rate.set(det.anomaly_rate, layer=layer.value)
                self.det_delta.set(float(det.log_delta), layer=layer.value)
        executor = getattr(s, "_executor", None)
        if executor is not None:
            st = executor.stats()
            self.sweeps_submitted.set_total(st["submitted"])
            self.sweeps_completed.set_total(st["completed"])
            self.sweeps_coalesced.set_total(st["coalesced"])
            self.sweep_errors.set_total(st["errors"])
            self.detect_queue_depth.set(st["queue_depth"])
            self.detect_busy_s.set_total(st["busy_seconds"])
            self.detect_lag_s.set(s.async_lag_seconds)
            self.detect_lag_steps.set(s.async_lag_steps)
        from repro_torch.detect import SHAPE_CACHE

        cache = SHAPE_CACHE.stats()
        self.compile_hits.set_total(cache["hits"])
        self.compile_misses.set_total(cache["misses"])
        serve = s.serve_stats()
        if serve:
            self.serve_requests.set_total(serve.get("requests_total", 0.0))
            self.serve_tokens.set_total(serve.get("tokens_total", 0.0))
            self.serve_queue_wait.set(serve.get("queue_wait_mean_s", 0.0))
            self.serve_ttft.set(serve.get("ttft_mean_s", 0.0))
            self.serve_tpot.set(serve.get("tpot_mean_s", 0.0))
            self.serve_stall.set_total(
                serve.get("client_stall_total_s", 0.0))
            self.serve_queue_depth.set(serve.get("queue_depth", 0.0))
            self.serve_occupancy.set(serve.get("occupancy", 0.0))
            self.serve_breaches.set_total(
                serve.get("slo_breaches_total", 0.0))
            self.serve_breach_incidents.set_total(
                serve.get("slo_breach_incidents_total", 0.0))
        # incidents / diagnoses / actions accumulate on the session
        for layer, n in s.incident_counts().items():
            self.incidents_total.set_total(n, layer=layer)
        for kind, n in s.diagnosis_counts().items():
            self.diagnoses_total.set_total(n, kind=kind)
        for kind, n in s.action_counts().items():
            self.actions_total.set_total(n, kind=kind)

    def _collect_stream(self, monitor) -> None:
        agg = monitor.aggregator
        hierarchical = hasattr(monitor, "groups")
        for nid, agent in list(monitor.agents.items()):
            node = str(nid)
            self.agent_flushes.set_total(agent.seq, node=node)
            self.agent_events.set_total(agent.events_shipped, node=node)
            self.agent_shed.set_total(agent.events_shed, node=node)
            self.agent_bytes.set_total(agent.bytes_shipped, node=node)
            self.agent_encode_s.set_total(agent.encode_seconds, node=node)
            if agent.governor is not None:
                self.gov_budget.set(agent.governor.budget, node=node)
        self.fleet_nodes.set(len(agg.nodes_seen))
        self.fleet_ingested.set_total(agg.events_ingested)
        self.fleet_dropped_src.set_total(agg.events_dropped_at_source)
        self.fleet_shed.set_total(
            getattr(agg, "events_shed_at_source", 0))
        self.fleet_lost.set_total(agg.lost_batches)
        self.fleet_groups.set(
            len(monitor.groups) if hierarchical else 0)
        if hierarchical:
            for gid, g in list(monitor.groups.items()):
                group = str(gid)
                self.group_nodes.set(len(g.agg.nodes_seen), group=group)
                self.group_ingested.set_total(g.agg.events_ingested,
                                              group=group)
            for gid, state, freshness in self.group_states():
                group = str(gid)
                self.group_freshness.set(freshness, group=group)
                self.group_state.set(STATE_CODE[state], group=group)
        now = time.time()
        last_events, last_t = self._last_ingest
        dt = now - last_t
        if dt > 0:
            self.fleet_rate.set(
                max(0, agg.events_ingested - last_events) / dt)
        self._last_ingest = (agg.events_ingested, now)
        for layer, w in list(agg.windows.items()):
            self.window_occupancy.set(len(w), layer=layer.value)
            self.window_evicted.set_total(w.evicted, layer=layer.value)
            self.window_truncated.set_total(w.names_truncated,
                                            layer=layer.value)
        for nid, state, freshness in self.node_states():
            self.node_freshness.set(freshness, node=str(nid))
            self.node_state.set(STATE_CODE[state], node=str(nid))
        if hierarchical:
            # per-layer summary across group detectors: refit counts sum,
            # thresholds average — per-group detail would multiply label
            # cardinality by the group count for no operator benefit
            for layer_name, st in monitor.detector_stats().items():
                self.det_warm.set_total(st["warm_refits"], layer=layer_name)
                self.det_cold.set_total(st["cold_refits"], layer=layer_name)
                self.det_delta.set(st["log_delta"], layer=layer_name)
        else:
            for layer, st in list(monitor.detector.states.items()):
                self.det_warm.set_total(st.warm_refits, layer=layer.value)
                self.det_cold.set_total(st.cold_refits, layer=layer.value)
                self.det_delta.set(st.log_delta, layer=layer.value)
        for layer, d in list(monitor.last_detections.items()):
            self.det_flag_rate.set(d.anomaly_rate, layer=layer.value)
        self.det_ticks.set_total(monitor.ticks)
        new_ticks = monitor.ticks - self._seen_ticks
        if new_ticks > 0:
            mean_ms = (1e3 * (monitor.detect_seconds - self._seen_detect_s)
                       / new_ticks)
            for _ in range(new_ticks):
                self.detect_ms.observe(mean_ms)
            self._seen_ticks = monitor.ticks
            self._seen_detect_s = monitor.detect_seconds
        self.incident_pending.set(monitor.engine.n_pending_flags)

    # -- freshness ------------------------------------------------------------
    def node_states(self) -> List[tuple]:
        """(node_id, state, freshness_s) per fleet node; stream mode only
        (batch sessions have no wire transport to go stale)."""
        s = self.session
        if s.spec.mode != "stream" or s._backend is None:
            return []
        agg = s._backend.monitor.aggregator
        out = []
        for nid in sorted(agg.nodes_seen):
            last = agg.node_last_ts.get(nid)
            freshness = (agg.t_latest - last) if last is not None \
                else float("inf")
            if freshness <= self.degraded_after_s:
                state = "healthy"
            elif freshness <= self.stale_after_s:
                state = "degraded"
            else:
                state = "stale"
            out.append((nid, state, freshness))
        return out

    def group_states(self) -> List[tuple]:
        """(group_id, state, freshness_s) per group aggregator; empty for
        flat or non-stream sessions. Freshness is how far the group's
        newest ingested event trails the FLEET clock — a whole group going
        quiet (its host died, its uplink broke) flips to stale here even
        when per-node cardinality is capped out of the node metrics."""
        s = self.session
        if s.spec.mode != "stream" or s._backend is None:
            return []
        monitor = s._backend.monitor
        if not hasattr(monitor, "groups"):
            return []
        t_fleet = monitor.aggregator.t_latest
        out = []
        for gid, g in sorted(monitor.groups.items()):
            freshness = (t_fleet - g.agg.t_latest if g.agg.node_last_ts
                         else float("inf"))
            if freshness <= self.degraded_after_s:
                state = "healthy"
            elif freshness <= self.stale_after_s:
                state = "degraded"
            else:
                state = "stale"
            out.append((gid, state, freshness))
        return out

    # -- rendering ------------------------------------------------------------
    def scrape(self) -> str:
        """One exposition document (counts itself as a scrape)."""
        self.scrapes.inc()
        return self.registry.render()

    def finalize_from_report(self, report) -> None:
        """Sync the incident/diagnosis counters from the final report —
        batch mode forms its incidents only at finalise, after the last
        mid-run collection."""
        by_layer: Dict[str, int] = {}
        for inc in getattr(report, "incidents", []):
            key = inc.suspect_layer.value
            by_layer[key] = by_layer.get(key, 0) + 1
        for layer, n in by_layer.items():
            self.incidents_total.set_total(n, layer=layer)
        by_kind: Dict[str, int] = {}
        for d in getattr(report, "diagnoses", []):
            by_kind[d.fault_kind] = by_kind.get(d.fault_kind, 0) + 1
        for kind, n in by_kind.items():
            self.diagnoses_total.set_total(n, kind=kind)

    def health(self) -> Dict[str, object]:
        """Detail payload for the /healthz endpoint."""
        states = {str(nid): state for nid, state, _ in self.node_states()}
        payload: Dict[str, object] = {
            "mode": self.session.spec.mode,
            "nodes": len(self.session._nodes),
        }
        if states:
            payload["node_states"] = states
            if any(v == "stale" for v in states.values()):
                payload["status"] = "degraded"
        group_states = {str(gid): state
                        for gid, state, _ in self.group_states()}
        if group_states:
            payload["group_states"] = group_states
            if any(v == "stale" for v in group_states.values()):
                payload["status"] = "degraded"
        return payload
