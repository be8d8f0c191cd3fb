"""Central registry of every monitor/telemetry event name in the stack
(the port's copy of ``deepspeed_tpu/telemetry/event_registry.py``).

The entries, the dynamic prefix families and :func:`render_event_table`
are the JAX package's, so the generated table (its markers name the JAX
file and ``docs/OBSERVABILITY.md``, which the table documents) is the same
text from either package.  Every event-name literal the port emits
(``events.emit``, ``metrics.counter/gauge/histogram``, monitor
``write_events`` tuples) must be registered here;
``tests/test_torch_event_registry.py`` walks the port's sources and holds
each literal, and the head of each f-string name, to this registry.

Deliberately stdlib-only with no package-relative imports, so it also
runs directly by path.

``kind`` vocabulary: ``event`` (a monitor ``write_events`` tuple),
``counter``/``gauge``/``histogram`` (MetricsRegistry instruments — note
histograms additionally fan out over the ``telemetry/`` bridge as
``_p50/_p95/_p99/_count``), and ``span``/``track`` (flight-recorder span
names and track names: not monitor events, but the same one-namespace
discipline applies).
"""

import re

#: static event names: one entry per literal an emitter uses
EVENTS = {
    # ---- resilience bus (resilience/events.py -> monitor forward)
    "resilience/fault_injected": ("event", "resilience/fault_injection.py",
                                  "a planned fault fired at a site"),
    "resilience/retry": ("event", "resilience/retry.py",
                         "transient failure absorbed; backing off"),
    "resilience/retry_exhausted": ("event", "resilience/retry.py",
                                   "retry budget/schedule spent; re-raising"),
    "resilience/admission_retry": ("event", "resilience/retry.py",
                                   "serving admission backoff probe"),
    "resilience/watchdog_hang": ("event", "resilience/watchdog.py",
                                 "step exceeded the hang threshold"),
    "resilience/rendezvous": ("event", "elasticity/elastic_agent.py",
                              "elastic agent re-rendezvous after a loss"),
    "resilience/device_loss": ("event", "elasticity/elastic_agent.py",
                               "DEVICE_LOST-class failure classified"),
    "resilience/ckpt_published": ("event", "checkpoint/engine.py",
                                  "'latest' atomically points at a new tag"),
    "resilience/ckpt_invalid_tag": ("event", "checkpoint/engine.py",
                                    "requested tag failed validation"),
    "resilience/ckpt_fallback": ("event", "checkpoint/engine.py",
                                 "auto-fallback to the newest valid tag"),
    "resilience/ckpt_retention_delete": ("event", "checkpoint/engine.py",
                                         "keep-last-K pruned a tag"),
    "resilience/host_opt_reject": ("event",
                                   "runtime/swap_tensor/host_streamed_optimizer.py",
                                   "host-tier npz failed manifest/crc checks"),
    # ---- serving frontend (serving/engine.py)
    "serving/rejected": ("event+counter", "serving/engine.py",
                         "admission rejected a request"),
    "serving/preempted": ("event", "serving/engine.py",
                          "KV pressure evicted + requeued a request"),
    "serving/e2e_latency": ("event", "serving/engine.py",
                            "terminal request end-to-end seconds"),
    "serving/preemptions": ("event+counter", "serving/engine.py",
                            "preemption count of a terminal request"),
    "serving/ttft": ("event", "serving/engine.py", "time to first token"),
    "serving/tpot": ("event", "serving/engine.py", "time per output token"),
    "serving/queue_wait": ("event", "serving/engine.py",
                           "admission-queue wait of a DONE request"),
    "serving/deadline_met": ("event", "serving/engine.py",
                             "1/0: DONE request met its SLA deadline"),
    "serving/timed_out": ("event", "serving/engine.py",
                          "request expired its deadline"),
    "serving/submitted": ("counter", "serving/engine.py",
                          "requests entering submit()"),
    "serving/e2e_s": ("histogram", "serving/engine.py",
                      "end-to-end seconds, all terminal requests"),
    "serving/ttft_s": ("histogram", "serving/engine.py",
                       "time to first token, DONE requests"),
    "serving/tpot_s": ("histogram", "serving/engine.py",
                       "time per output token, DONE requests"),
    "serving/queue_wait_s": ("histogram", "serving/engine.py",
                             "admission-queue wait, DONE requests"),
    # ---- speculative decoding (serving/engine.py folding
    #      inference/v2/engine_v2.py last_spec_round)
    "spec/proposed": ("counter", "serving/engine.py",
                      "draft tokens fed to verify dispatches"),
    "spec/accepted": ("counter", "serving/engine.py",
                      "draft tokens the verify argmax confirmed"),
    "spec/rollback_pages": ("counter", "serving/engine.py",
                            "KV pages released rolling back rejected drafts"),
    "spec/acceptance_rate": ("histogram", "serving/engine.py",
                             "per-verify-round accepted/proposed ratio"),
    # ---- KV migration (serving/kvtransfer/ via serving/engine.py)
    "serving/migrated": ("event+counter", "serving/engine.py",
                         "request handed off to another replica with its KV"),
    "migration/kv_imports": ("counter", "serving/engine.py",
                             "KV-import fast-path resumes (no prompt recompute)"),
    "migration/import_fallback": ("counter", "serving/engine.py",
                                  "snapshot rejected at import -> "
                                  "recompute-on-resume"),
    # ---- fleet prefix directory (serving/fleet/prefix_directory.py +
    #      router.py + serving/engine.py)
    "prefix/publish": ("counter", "serving/fleet/prefix_directory.py",
                       "replica published a prefix-chain digest to the "
                       "fleet directory"),
    "prefix/evict": ("counter", "serving/fleet/prefix_directory.py",
                     "replica retracted a digest (cache eviction) from "
                     "the directory"),
    "prefix/import": ("counter", "serving/engine.py",
                      "hot-prefix KV pages adopted into this replica's "
                      "cache (cold-replica warm-up fast path)"),
    "prefix/import_fallback": ("counter", "serving/fleet/router.py",
                               "prefix import rejected/failed -> cold "
                               "dispatch, prefill recomputes"),
    "fleet/prefix_import": ("event", "serving/fleet/router.py",
                            "cold-replica prefix KV import completed "
                            "before dispatch (value = target rid)"),
    "fleet/prefix_import_fallback": ("event", "serving/fleet/router.py",
                                     "prefix import abandoned; the "
                                     "dispatch proceeds cold"),
    "fleet/prefix_directory_entries": ("gauge", "serving/fleet/router.py",
                                       "(rid, digest) entries resident in "
                                       "the fleet prefix directory, "
                                       "sampled once per fleet round"),
    # ---- fleet router (serving/fleet/)
    "fleet/dispatch": ("event", "serving/fleet/router.py",
                       "request placed on a replica (value = rid)"),
    "fleet/session_park": ("event", "serving/fleet/router.py",
                           "session turn parked mid-generation for a tool "
                           "stall (KV demoted host-side, serving/sessions)"),
    "fleet/session_resume": ("event", "serving/fleet/router.py",
                             "parked session turn resumed in place (tool "
                             "result arrived; staged KV promotes back)"),
    "fleet/replica_dead": ("event", "serving/fleet/router.py",
                           "replica declared dead (value = rid)"),
    "fleet/failover_requeued": ("event", "serving/fleet/router.py",
                                "in-flight requests displaced to survivors"),
    "fleet/migration_start": ("event", "serving/fleet/router.py",
                              "KV export began on a prefill replica "
                              "(value = source rid)"),
    "fleet/migration_complete": ("event", "serving/fleet/router.py",
                                 "snapshot handed off to a decode replica "
                                 "(value = source rid)"),
    "fleet/migration_fallback": ("event", "serving/fleet/router.py",
                                 "migration abandoned; recompute/in-place "
                                 "decode owns the request"),
    # ---- control-plane transport (serving/fleet/transport.py +
    #      health.py + router.py) — docs/SERVING.md "Control-plane
    #      transport"; the per-counter transport/* family is DYNAMIC
    "fleet/lease_suspect": ("event", "serving/fleet/health.py",
                            "heartbeat silence passed suspect_after; no "
                            "new dispatches (value = rid)"),
    "fleet/lease_expired": ("event", "serving/fleet/health.py",
                            "lease expired: fleet-declared death, work "
                            "re-dispatched, dispatch epoch bumped "
                            "(value = rid)"),
    "fleet/lease_renewed": ("event", "serving/fleet/health.py",
                            "heartbeats resumed (SUSPECT healed, or a "
                            "fenced replica rejoined) (value = rid)"),
    "fleet/fenced_replica": ("event", "serving/fleet/router.py",
                             "a fleet-dead replica heartbeated again; a "
                             "FENCE is in flight (value = rid)"),
    "fleet/fenced_request": ("event", "serving/fleet/router.py",
                             "in-flight zombie requests cancelled by a "
                             "fence (value = count)"),
    "fleet/fenced_completion": ("event", "serving/fleet/router.py",
                                "late zombie completions discarded by "
                                "fencing — never double-served "
                                "(value = count)"),
    "prefix/publish_gap": ("event", "serving/fleet/router.py",
                           "a sequence gap in a replica's prefix-publish "
                           "stream was declared lost (value = rid)"),
    "prefix/resync": ("event", "serving/fleet/router.py",
                      "full-digest directory resync applied for a replica "
                      "(value = rid)"),
    "fleet/prefix_warmup": ("event", "serving/fleet/router.py",
                            "directory-driven warm-up pre-imported hot "
                            "chains onto a recovering replica "
                            "(value = rid)"),
    "fleet/lease_resize": ("event", "serving/fleet/health.py",
                           "adaptive lease sizing widened/tightened a "
                           "replica's lease band from observed link "
                           "quality (value = rid)"),
    "fleet/lifecycle_cmd": ("event", "serving/fleet/router.py",
                            "a typed lifecycle command (recover/drain/"
                            "park/restart/role_change/mig_complete) was "
                            "issued over the control transport "
                            "(value = target rid)"),
    "fleet/role_change": ("event", "serving/fleet/router.py",
                          "a drained replica's serving role was "
                          "reassigned (prefill/decode/mixed) "
                          "(value = rid)"),
    # ---- overload control plane (serving/fleet/autoscale.py + router.py)
    "fleet/scale_up": ("event", "serving/fleet/autoscale.py",
                       "autoscaler provisioned a replica through "
                       "RECOVERING (value = rid)"),
    "fleet/scale_drain": ("event", "serving/fleet/autoscale.py",
                          "scale-down drain began; no new dispatches "
                          "(value = rid)"),
    "fleet/scale_down": ("event", "serving/fleet/autoscale.py",
                         "drained replica parked idle — nothing in "
                         "flight was killed (value = rid)"),
    "fleet/overload_step_up": ("event", "serving/fleet/autoscale.py",
                               "degradation ladder stepped up "
                               "(value = new rung)"),
    "fleet/overload_step_down": ("event", "serving/fleet/autoscale.py",
                                 "degradation ladder stepped down "
                                 "(value = new rung)"),
    "fleet/overload_shed": ("event", "serving/fleet/router.py",
                            "best-effort admission shed with a "
                            "retry-after hint (value = rung)"),
    "fleet/kv_quota_reject": ("event", "serving/fleet/router.py",
                              "admission or prefix-import rejected "
                              "against a tenant's KV page quota "
                              "(value = projected pages)"),
    "fleet/serving_replicas": ("gauge", "serving/fleet/router.py",
                               "replicas in a serving state, sampled "
                               "once per fleet round"),
    "fleet/overload_rung": ("gauge", "serving/fleet/router.py",
                            "current degradation-ladder rung (0 = "
                            "normal service)"),
    # ---- flight recorder (telemetry/flight_recorder.py, driven by
    #      serving/fleet/router.py; docs/OBSERVABILITY.md "Flight recorder")
    "recorder/dump": ("event", "serving/fleet/router.py",
                      "crash-scoped flight-recorder trace dumped (replica "
                      "death / lease expiry / fencing / divergence; value = "
                      "cumulative dump count)"),
    # ---- control-plane flight-recorder spans/tracks: names the recorder
    #      rings use (causal message spans ride the DYNAMIC ctrl/ family)
    "ctrl/drop": ("span", "serving/fleet/transport.py",
                  "recorder instant: the fabric ate a control message "
                  "(attrs: kind, seq, mid, cause = loss|partition|"
                  "send_fault|deliver_fault)"),
    "ctrl/fence": ("span", "serving/engine.py",
                   "recorder instant: a FENCE executed on a replica "
                   "frontend (attrs: cancelled queued/active counts)"),
    "ctrl/lease_resize": ("span", "serving/fleet/health.py",
                          "recorder instant: an adaptive lease resize on "
                          "the replica's lease track (attrs: direction, "
                          "scale, gap_ewma, loss)"),
    "ctrl/lifecycle": ("span", "serving/fleet/router.py",
                       "recorder instant: a lifecycle command was issued "
                       "(attrs: rid, op, seq, epoch)"),
    "ctrl/autoscale": ("track", "serving/fleet/autoscale.py",
                       "flight-recorder track of autoscaler decision "
                       "instants (ctrl/autoscale/<action>)"),
    "ctrl/overload": ("track", "serving/fleet/autoscale.py",
                      "flight-recorder track of brownout-rung occupancy "
                      "intervals (ctrl/overload/<rung>)"),
    # ---- control-plane transport health gauges (serving/fleet/router.py,
    #      exported once per fleet round; the per-rid link gauges are the
    #      DYNAMIC transport/ gauge family)
    "transport/retransmit_depth": ("gauge", "serving/fleet/router.py",
                                   "reliable-stream sends currently "
                                   "awaiting an ack (unacked fences + "
                                   "migration chunks + directory "
                                   "resyncs), sampled once per fleet "
                                   "round"),
    # ---- step anatomy (telemetry/step_anatomy.py, folded by
    #      serving/engine.py; docs/OBSERVABILITY.md "Step anatomy")
    "engine/recompiles": ("counter", "serving/engine.py",
                          "JIT cache misses folded from the step-anatomy "
                          "compile tracker (warm-up included)"),
    "engine/recompile_steady_state": ("event+counter", "serving/engine.py",
                                      "a step program compiled AFTER the "
                                      "warm-up boundary — the AOT "
                                      "serving-step regression guard"),
    "anatomy/step": ("span", "serving/engine.py",
                     "flight-recorder span: one engine step's anatomy "
                     "(attrs: shape, host/device/gap seconds, compiles) "
                     "on the anatomy/<frontend> track"),
    "anatomy/device": ("span", "telemetry/step_anatomy.py",
                       "device-compute child of an emit_spans "
                       "anatomy/step (host segments ride as "
                       "anatomy/<segment> via the DYNAMIC family)"),
    # ---- engine-step tracer spans (runtime/engine.py set_telemetry)
    "engine/step": ("span", "runtime/engine.py",
                    "one train_batch trace root on the engine track"),
    "engine/fwd_bwd": ("span", "runtime/engine.py",
                       "forward+backward child of engine/step"),
    "engine/optim": ("span", "runtime/engine.py",
                     "optimizer child of engine/step (nvme/host tiers)"),
    "engine/fused_step": ("span", "runtime/engine.py",
                          "fused fwd+bwd+optim child of engine/step"),
    # ---- KV-arena occupancy (serving/engine.py export_kv_gauges; the
    #      per-rid / per-tenant variants are the DYNAMIC kv/ family)
    "kv/pages_in_use": ("gauge", "serving/engine.py",
                        "arena pages held by sequences and/or the prefix "
                        "cache"),
    "kv/pages_free": ("gauge", "serving/engine.py",
                      "arena pages on the free list"),
    "kv/page_occupancy": ("gauge", "serving/engine.py",
                          "in-use fraction of the usable arena"),
    "kv/free_run_fragmentation": ("gauge", "serving/engine.py",
                                  "1 - longest contiguous free page-id "
                                  "run / free pages (allocation churn)"),
    "kv/prefix_cache_pages": ("gauge", "serving/engine.py",
                              "pages pinned by prefix-cache entries"),
    "kv/prefix_cache_share": ("gauge", "serving/engine.py",
                              "prefix-cache share of in-use pages"),
    # ---- tiered KV (serving/kvtier — docs/SERVING.md "Tiered KV")
    "kv/demote": ("counter", "serving/kvtier/tier.py",
                  "sequence or prefix page staged d2h into the host tier"),
    "kv/promote": ("counter", "serving/kvtier/tier.py",
                   "host-tier pages promoted h2d (resume claim or "
                   "prefix-chain promote)"),
    "kv/park": ("event+counter", "serving/engine.py",
                "idle session demoted + parked (DECODE -> PARKED, zero "
                "device pages held)"),
    "kv/resume": ("event+counter", "serving/engine.py",
                  "parked session re-enqueued (PARKED -> QUEUED, promote "
                  "prefetch issued)"),
    "kv/watermark_demote": ("counter", "serving/kvtier/tier.py",
                            "pages moved by watermark enforcement (device "
                            "high-water prefix demotion + host LRU drops)"),
    "kv/host_pages": ("gauge", "serving/engine.py",
                      "host-tier pages held (demoted sequences + "
                      "warm-on-host prefix pages)"),
    "kv/tier_prefetch_hidden_frac": ("gauge", "serving/engine.py",
                                     "fraction of promote transfer "
                                     "seconds hidden under prior device "
                                     "windows by issued-ahead prefetch"),
    # ---- arrival-rate telemetry (serving/fleet/router.py, exported once
    #      per fleet round — ROADMAP's predictive-scale-up input)
    "fleet/arrival_rate_ewma": ("gauge", "serving/fleet/router.py",
                                "EWMA (alpha=0.2) of fleet request "
                                "arrivals per clock second"),
    "fleet/arrival_rate_slope": ("gauge", "serving/fleet/router.py",
                                 "per-round derivative of the arrival "
                                 "EWMA (scale BEFORE the queue grows)"),
    # ---- monitor surface (monitor/monitor.py)
    "monitor/dropped_events": ("event", "monitor/monitor.py",
                               "cumulative events shed by the max_events cap"),
    # ---- flops profiler gauges (profiling/flops_profiler/profiler.py)
    "profiler/flops_per_step": ("gauge", "profiling/flops_profiler/profiler.py",
                                "model FLOPs of the profiled step"),
    "profiler/macs_per_step": ("gauge", "profiling/flops_profiler/profiler.py",
                               "model MACs of the profiled step"),
    "profiler/params": ("gauge", "profiling/flops_profiler/profiler.py",
                        "parameter count"),
    "profiler/bytes_per_step": ("gauge", "profiling/flops_profiler/profiler.py",
                                "activation+weight bytes moved per step"),
    "profiler/step_duration_s": ("gauge", "profiling/flops_profiler/profiler.py",
                                 "measured wall duration of the profiled step"),
}

#: dynamic name families built with f-strings; ``prefix`` legitimizes the
#: emitter's literal head, ``expansions`` documents the closed value set
#: ("..." marks an open family)
DYNAMIC = [
    {"prefix": "serving/", "template": "serving/<terminal-state>",
     "kind": "counter", "source": "serving/engine.py",
     "expansions": ["serving/done", "serving/timed_out", "serving/migrated"],
     "doc": "terminal-state counter per finished request"},
    {"prefix": "fleet/", "template": "fleet/<terminal-state>",
     "kind": "event", "source": "serving/fleet/router.py",
     "expansions": ["fleet/done", "fleet/timed_out", "fleet/rejected"],
     "doc": "terminal-state event per finished fleet request"},
    {"prefix": "fleet/replica_", "template": "fleet/replica_<stat>/<rid>",
     "kind": "gauge", "source": "serving/fleet/router.py",
     "expansions": ["fleet/replica_queue_depth/<rid>",
                    "fleet/replica_free_kv_pages/<rid>",
                    "fleet/replica_outstanding_tokens/<rid>",
                    "fleet/replica_active/<rid>"],
     "doc": "per-replica load_stats snapshot exported once per fleet round"},
    {"prefix": "fleet/health/", "template": "fleet/health/<state>",
     "kind": "event", "source": "serving/fleet/health.py",
     "expansions": ["fleet/health/healthy", "fleet/health/degraded",
                    "fleet/health/draining", "fleet/health/dead",
                    "fleet/health/recovering"],
     "doc": "replica health transition (value = rid)"},
    {"prefix": "transport/", "template": "transport/<counter>",
     "kind": "counter", "source": "serving/fleet/transport.py",
     "expansions": ["transport/sent", "transport/delivered",
                    "transport/dropped", "transport/partition_dropped",
                    "transport/duplicated", "transport/reordered",
                    "transport/delayed", "transport/send_faults",
                    "transport/deliver_faults", "transport/retransmits"],
     "doc": "control-plane fabric accounting, one counter per fate a "
            "message can meet (docs/SERVING.md 'Control-plane transport')"},
    {"prefix": "telemetry/", "template": "telemetry/<metric>[_p50|_p95|_p99|_count]",
     "kind": "event", "source": "telemetry/metrics.py",
     "expansions": ["..."],
     "doc": "MetricsRegistry.flush_to_monitor bridge of every registered "
            "metric (histograms fan out quantiles + count)"},
    {"prefix": "ctrl/", "template": "ctrl/<name>",
     "kind": "span", "source": "serving/fleet/transport.py (+health.py, "
     "autoscale.py, telemetry/slo.py)",
     "expansions": ["ctrl/<message-kind> (send->deliver causal span, per "
                    "ctrl/link/<src>-<dst> track)",
                    "ctrl/lease/<state> (lease-lifecycle interval per "
                    "ctrl/lease/replica/<rid> track)",
                    "ctrl/overload/<rung>", "ctrl/autoscale/<action>",
                    "ctrl/slo/<tenant> (alert-window interval track)"],
     "doc": "flight-recorder control-plane span names: causal transport "
            "message pairs, lease/rung/alert intervals, autoscaler "
            "instants (docs/OBSERVABILITY.md 'Flight recorder')"},
    {"prefix": "slo/", "template": "slo/<signal>/<tenant>",
     "kind": "event+gauge", "source": "telemetry/slo.py",
     "expansions": ["slo/alert_fired/<tenant>", "slo/alert_cleared/<tenant>",
                    "slo/burn_fast/<tenant>", "slo/burn_slow/<tenant>"],
     "doc": "multi-window SLO burn-rate monitoring over per-tenant "
            "TenantSpec.ttft_slo: hysteresis-gated alert events + the "
            "fast/slow burn gauges, bit-reproducible under VirtualClock"},
    {"prefix": "transport/", "template": "transport/<link-gauge>/<rid>",
     "kind": "gauge", "source": "serving/fleet/router.py",
     "expansions": ["transport/link_loss_ewma/<rid>",
                    "transport/feed_gap_age/<rid>"],
     "doc": "per-link control-plane health, sampled once per fleet round "
            "— the adaptive-lease-sizing input signal (ROADMAP)"},
    {"prefix": "kv/", "template": "kv/<stat>/<rid-or-tenant>",
     "kind": "gauge", "source": "serving/fleet/router.py",
     "expansions": ["kv/page_occupancy/<rid>",
                    "kv/free_run_fragmentation/<rid>",
                    "kv/prefix_cache_share/<rid>",
                    "kv/tenant_pages/<tenant>"],
     "doc": "per-replica KV-arena occupancy + per-tenant page tallies "
            "(tenant tallies sum to the fleet's pages in use — the "
            "per-tenant KV-quota input), exported once per fleet round"},
    {"prefix": "anatomy/", "template": "anatomy/<name>",
     "kind": "gauge+span+track", "source": "serving/fleet/router.py "
     "(+serving/engine.py, telemetry/step_anatomy.py)",
     "expansions": ["anatomy/host_gap_fraction/<rid> (gauge)",
                    "anatomy/<frontend> (flight-recorder track of "
                    "anatomy/step spans, e.g. anatomy/replica0)"],
     "doc": "step-anatomy surfaces: per-replica host-gap-fraction gauges "
            "once per fleet round + per-step recorder tracks "
            "(docs/OBSERVABILITY.md 'Step anatomy')"},
]

BEGIN_MARK = ("<!-- BEGIN EVENT TABLE (generated from "
              "deepspeed_tpu/telemetry/event_registry.py — edit there, then "
              "`python deepspeed_tpu/telemetry/event_registry.py --sync "
              "docs/OBSERVABILITY.md`) -->")
END_MARK = "<!-- END EVENT TABLE -->"


def registered_names():
    return frozenset(EVENTS)


def dynamic_prefixes():
    return tuple(d["prefix"] for d in DYNAMIC)


def _cell(text: str) -> str:
    # GFM splits table cells on '|' even inside code spans
    return text.replace("|", "\\|")


def render_event_table() -> str:
    """The markdown block committed between the OBSERVABILITY.md markers.
    Deterministic: sorted rows, no timestamps."""
    lines = [BEGIN_MARK, "",
             "| event | kind | emitted by | meaning |",
             "|---|---|---|---|"]
    for name in sorted(EVENTS):
        kind, source, doc = EVENTS[name]
        lines.append(f"| `{_cell(name)}` | {_cell(kind)} | `{_cell(source)}` "
                     f"| {_cell(doc)} |")
    for d in sorted(DYNAMIC, key=lambda d: d["template"]):
        exp = ", ".join(f"`{_cell(e)}`" for e in d["expansions"])
        lines.append(f"| `{_cell(d['template'])}` | {_cell(d['kind'])} | "
                     f"`{_cell(d['source'])}` | "
                     f"{_cell(d['doc'])} — expands to: {exp} |")
    lines += ["", END_MARK]
    return "\n".join(lines)


def extract_doc_block(doc_text: str):
    """The committed table block (markers included), or None."""
    m = re.search(re.escape(BEGIN_MARK) + r".*?" + re.escape(END_MARK),
                  doc_text, re.DOTALL)
    return m.group(0) if m else None


def sync_doc(doc_path: str) -> bool:
    """Rewrite the generated block in ``doc_path``; returns True when the
    file changed.  The block must already exist (markers committed)."""
    with open(doc_path, "r", encoding="utf-8") as f:
        text = f.read()
    old = extract_doc_block(text)
    if old is None:
        raise SystemExit(f"{doc_path}: event-table markers not found — add\n"
                         f"{BEGIN_MARK}\n{END_MARK}")
    new = render_event_table()
    if old == new:
        return False
    with open(doc_path, "w", encoding="utf-8") as f:  # atomic-ok: doc regeneration, not a durability artifact
        f.write(text.replace(old, new))
    return True


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sync", metavar="DOC",
                    help="rewrite the generated event table in DOC")
    args = ap.parse_args()
    if args.sync:
        changed = sync_doc(args.sync)
        print(f"{args.sync}: {'updated' if changed else 'already in sync'}")
    else:
        print(render_event_table())
