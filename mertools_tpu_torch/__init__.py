"""mertools_tpu_torch — the PyTorch/CUDA port of ``mertools_tpu``.

Runs the system on an NVIDIA H100. The JAX package ``mertools_tpu`` stays
the reference that every ported module is held against; this package
imports ``torch`` and never ``jax``. Module names mirror the JAX package:

- ``core``     : dataset path registry, YAML configs, device set-up,
                 profiling.
- ``io``       : WAV reading and 16 kHz resampling (the repository's
                 ``native/libmeraudio.so``, numpy fallback).
- ``ops``      : hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions, and the nvcc build that loads them.
- ``encoders`` : wav2vec2 / HuBERT / data2vec / WavLM audio encoders and
                 Whisper, with HF state-dict key names.
- ``features`` : bucketed, batched audio feature extraction; Whisper
                 decoder-stub features.
- ``asr``      : KV-cached greedy Whisper decoding and the batched
                 transcript pipeline.
- ``mllm``     : the AffectGPT-equivalent MLLM (LoRA LLM, Q-Formers,
                 stream splicing), its training data and Runner.
- ``cli``      : ``extract_audio``, ``main_asr`` and ``train_mllm`` with the
                 JAX CLIs' flags.

It imports nothing of the JAX package: what it needs from framework-free
modules there is copied (``io/wav.py``, ``mllm/data.py``).
"""

__version__ = "0.1.0"
