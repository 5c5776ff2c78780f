"""PyTorch/CUDA port of ddsp_svc_tpu for an NVIDIA H100 (Hopper, sm_90a).

The JAX package `ddsp_svc_tpu/` is the reference this package is held
against; nothing here imports it, JAX or flax. The layout mirrors it:

    ops/    DSP functions on tensors, and the four hand-written CUDA kernels
            that replace the JAX package's Pallas kernels (ops/kernels.py,
            sources in csrc/, built by ops/build.py)
    nn/     network modules (layers, PCmer, Unit2Control, NSF-HiFiGAN)
    models/ the CombSubFast synthesizer and the model factory
    infer/  the enhancer front end and the offline segment loop
    data/   the silence slicer (numpy)
    utils/  config, device policy, the flax -> torch weight bridge

Entry points run on CUDA unless the caller passes device="cpu"; with no GPU
and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
