"""The port's copies of the registry's vocabulary (``polyaxon_tpu.db``).

Only the constants the serving fleet writes are here; the registry itself
(runs, statuses, remediation rows) is the control plane's, which ingests a
port process's report file (``tracking/reporter.py``); the fleet's registry
runs wait for the port's worker (ROADMAP Queue 1 item 7).
"""
