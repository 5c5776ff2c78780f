"""PyTorch/CUDA port of ddsp_svc_tpu for an NVIDIA H100 (Hopper, sm_90a).

The JAX package `ddsp_svc_tpu/` is the reference this package is held
against; nothing here imports it, JAX or flax. The layout mirrors it:

    ops/    DSP functions on tensors, and the hand-written CUDA kernels
            that replace the JAX package's Pallas kernels (ops/kernels.py,
            sources in csrc/, built by ops/build.py)
    nn/     network modules (layers, PCmer, Unit2Control, NSF-HiFiGAN,
            HuBERT, CREPE)
    models/ the three synthesizers (causal, and CombSubFast with the
            frame-local prenet norm, too), the model factory, load_model,
            the bucketed synths (one segment, or a batch of them) and the
            exact incremental engine (incremental.py)
    infer/  the enhancer front end, the offline segment loop,
            run_inference, batched conversion (run_inference_batch), the
            CLI (python -m ddsp_svc_tpu_torch.infer, a wav or a
            directory), SOLA streaming (streaming.py: SvcCore,
            StreamingSession; stream_config.py: the settings profiles) and
            the incremental real-time session (realtime.py)
    stream  the streaming entry (python -m ddsp_svc_tpu_torch.stream, the
            root gui.py's counterpart: a wav block by block, or live)
    data/   the silence slicer, wav I/O, the training loaders, the feature
            front end (f0, volume, units) and preprocessing (python -m
            ddsp_svc_tpu_torch.preprocess)
    native/ the C++ NCCF f0 and volume host library, built with g++ at
            first use
    train/  the trainer (python -m ddsp_svc_tpu_torch.train)
    utils/  config, device policy, the flax -> torch weight bridge, the
            flax-msgpack reader

Entry points run on CUDA unless the caller passes device="cpu"; with no GPU
and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
