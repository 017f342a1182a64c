"""ms a picture of delivery: the engine's crop and pack of the output
(models/pipeline.py crop_pack) plus the fetch of its planes to the host
(`TorchPlanes.get()`, host clock), from the synchronised decode that
`host_prep_ms.live` reads, each picture fetched as decode() returns it."""


def read(r):
    crop = r.stages(("crop_pack",))
    if crop is None or r.fetch_ms is None:
        return None
    return crop + r.fetch_ms
