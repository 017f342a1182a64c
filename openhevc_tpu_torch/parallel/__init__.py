"""Multi-picture / multi-device decode runtime.

Two axes of parallelism over the reference's frame-threading model
(pthread_frame.c:325-513), the counterpart of the JAX package's
parallel/:

- frames.py: dependency-aware wave scheduling: consecutive pictures
  whose reference sets are disjoint from the wave batch together (all
  intra pictures; same-level hierarchical-B pictures).
- mesh.py:   reconstruction of a wave over a `DeviceMesh` of torch
  devices: members over the `frame` axis, HEVC tiles of a picture over
  the optional `tile` axis, with band-sharded in-loop filters.

The Decoder drives both: `Decoder(mesh=DeviceMesh(...))`.
"""
from .frames import WaveScheduler
from .mesh import DeviceMesh, MeshFrameDecoder

__all__ = ["WaveScheduler", "MeshFrameDecoder", "DeviceMesh"]
