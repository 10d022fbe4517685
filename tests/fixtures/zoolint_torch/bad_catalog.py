"""Seeded catalog-drift violations: a zoo_* metric and a ZOO_* env var
that docs/observability.md does not document. Never imported."""

import os


def register_bogus(registry):
    c = registry.counter("zoo_fixture_bogus_total",
                         "not in docs")  # VIOLATION metric-undocumented
    flag = os.getenv("ZOO_FIXTURE_BOGUS")  # VIOLATION envvar-undocumented
    # an autotune-family name the catalog does NOT list: proves the drift
    # check covers newly added zoo_autotune_* metrics, not a stale prefix
    g = registry.gauge("zoo_autotune_bogus_ms",
                       "not in docs")  # VIOLATION metric-undocumented
    knob = os.getenv("ZOO_AUTOTUNE_BOGUS")  # VIOLATION envvar-undocumented
    # a serving-delivery family the catalog does NOT list: the drift
    # check must flag new zoo_serving_* names (the redelivery counters
    # landed with the multi-replica contract; a typo'd sibling like this
    # one must not slide through as "close enough")
    r = registry.counter("zoo_serving_redelivered_bogus_total",
                         "not in docs")  # VIOLATION metric-undocumented
    lease = os.getenv("ZOO_SERVING_BOGUS_MS")  # VIOLATION envvar-undocumented
    # a per-lane scheduling family the catalog does NOT list: the drift
    # check must flag new lane/admission metrics (the priority-lane
    # counters landed with the SLO-aware scheduler; an undeclared
    # sibling must fire, not coast on the zoo_serving_lane_* prefix)
    d = registry.gauge("zoo_serving_lane_depth_bogus",
                       "not in docs")  # VIOLATION metric-undocumented
    wait = os.getenv(
        "ZOO_SERVING_MAX_WAIT_BOGUS_MS")  # VIOLATION envvar-undocumented
    # sharded-executor families the catalog does NOT list: the drift
    # check must flag new per-shard / decode metrics (zoo_shard_hbm_bytes
    # and the decode counters landed with the sharded seam; undeclared
    # siblings must fire, not coast on the prefix)
    s = registry.gauge("zoo_shard_hbm_bogus_bytes", ("shard",),
                      )  # VIOLATION metric-undocumented
    t = registry.counter("zoo_decode_steps_bogus_total",
                         "not in docs")  # VIOLATION metric-undocumented
    seq = os.getenv(
        "ZOO_SERVING_DECODE_BOGUS_SEQ")  # VIOLATION envvar-undocumented
    # history-store families the catalog does NOT list: the drift check
    # must flag new zoo_ts_* self-metrics and ZOO_TS_* knobs (the history
    # store landed with its own catalog rows; an undeclared sibling must
    # fire, not coast on the prefix)
    h = registry.gauge("zoo_ts_points_bogus",
                       "not in docs")  # VIOLATION metric-undocumented
    tick = os.getenv("ZOO_TS_BOGUS_TICK_S")  # VIOLATION envvar-undocumented
    # paged-attention / KV-quantization families the catalog does NOT
    # list: the drift check must flag new zoo_paged_attn_* / zoo_kv_quant_*
    # names and ZOO_KV_* knobs (the paged decode kernel + int8 pool landed
    # with their own rows; undeclared siblings must fire, not coast on the
    # prefix)
    p = registry.counter("zoo_paged_attn_bogus_total",
                         "not in docs")  # VIOLATION metric-undocumented
    q = registry.gauge("zoo_kv_quant_bogus_bytes",
                       "not in docs")  # VIOLATION metric-undocumented
    kvd = os.getenv("ZOO_KV_BOGUS_DTYPE")  # VIOLATION envvar-undocumented
    return c, flag, g, knob, r, lease, d, wait, s, t, seq, h, tick, p, q, kvd
