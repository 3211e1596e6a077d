"""mertools_tpu_torch — the PyTorch/CUDA port of ``mertools_tpu``.

Runs the system on an NVIDIA H100. The JAX package ``mertools_tpu`` stays
the reference that every ported module is held against; this package
imports ``torch`` and never ``jax``. Module names mirror the JAX package:

- ``core``     : dataset path registry, profiling.
- ``ops``      : hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions, and the nvcc build that loads them.
- ``encoders`` : wav2vec2 / HuBERT / data2vec / WavLM audio encoders and
                 Whisper, with HF state-dict key names.
- ``features`` : bucketed, batched audio feature extraction; Whisper
                 decoder-stub features.
- ``asr``      : KV-cached greedy Whisper decoding and the batched
                 transcript pipeline.
- ``cli``      : ``extract_audio`` and ``main_asr`` with the JAX CLIs' flags.

The framework-free ``mertools_tpu.io.wav`` is shared as it is.
"""

__version__ = "0.1.0"
