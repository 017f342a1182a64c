"""ms a picture of the engine's host work (models/pipeline.py: host_pack,
upload, residual, meta_schedule), both layers added, from one decode of
a session with `TorchEngine(sync_timers=True)` (every stage
synchronised, so host and device do not overlap)."""

STAGES = ("host_pack", "upload", "residual", "meta_schedule")


def read(r):
    return r.stages(STAGES)
