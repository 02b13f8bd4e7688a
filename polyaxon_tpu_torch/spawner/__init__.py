"""Process launching of the port (counterpart of ``polyaxon_tpu.spawner``):
the local transport the serving fleet starts its replicas with.  Gangs, the
SSH transport and reattaching to processes of an earlier control plane are
not ported yet (ROADMAP Queue 1 item 7)."""
