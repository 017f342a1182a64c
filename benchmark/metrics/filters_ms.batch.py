"""ms a picture of the in-loop filters on the device (ops/filters.py:
deblock and SAO), from the synchronised decode that `host_prep_ms.batch`
reads. None where no picture is filtered."""

STAGES = ("deblock", "sao")


def read(r):
    return r.stages(STAGES)
