"""ms a picture of motion compensation (ops/mc.py: stage 1, stage 2 and
the combine), both layers added, from the synchronised decode that
`host_prep_ms.batch` reads. None where no picture has inter blocks."""

STAGES = ("mc_stage1", "mc_stage2", "combine")


def read(r):
    return r.stages(STAGES)
