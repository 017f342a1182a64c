"""openhevc_tpu_torch: the HEVC decoder's PyTorch + CUDA port.

The host half (NAL/parameter-set/slice parsing, the native C++ CABAC
core, POC/RPS/DPB control) is this package's own copy of the JAX
package's host code; the device half (models/pipeline.py, ops/) is
PyTorch with hand-written CUDA kernels (csrc/). Entry points:
`openhevc_tpu_torch.decoder.Decoder(device="cuda")` and, for two-layer
SHVC streams, `openhevc_tpu_torch.decoder.ShvcDecoder(device="cuda")`.
"""
