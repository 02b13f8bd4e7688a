"""GL005 fixture: knob names that both packages' catalogs hold, a family
member, prefix mentions, and two names neither holds.  Parsed by
tests/test_torch_analysis.py, never imported."""

RUN_ID = "POLYAXON_TPU_RUN_ID"
WARMUP = "POLYAXON_TPU_SERVING_WARMUP"
STALL = f"POLYAXON_TPU_STALL_AFTER_S={1.5}"
FAMILY_MEMBER = "POLYAXON_TPU_ALERT_RUN_STALLED_ENABLED"
WILDCARD = "tune via POLYAXON_TPU_ROUTER_* and POLYAXON_TPU_WATCHDOG_*"
TYPO = "POLYAXON_TPU_SERVING_WARMPU"
PHANTOM = "POLYAXON_TPU_DOES_NOT_EXIST"
