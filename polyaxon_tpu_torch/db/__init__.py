"""The port's copies of the registry's vocabulary (``polyaxon_tpu.db``).

Only the constants the serving fleet writes are here; the registry itself
(runs, statuses, remediation rows) is not ported yet (ROADMAP Queue 1
item 5).
"""
