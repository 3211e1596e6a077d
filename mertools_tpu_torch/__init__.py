"""mertools_tpu_torch — the PyTorch/CUDA port of ``mertools_tpu``.

Runs the system on an NVIDIA H100. The JAX package ``mertools_tpu`` stays
the reference that every ported module is held against; this package
imports ``torch`` and never ``jax``. Module names mirror the JAX package:

- ``core``     : dataset path registry, YAML configs, the CLI namespace,
                 the name registry, MER label maps, device set-up,
                 profiling.
- ``io``       : WAV reading and 16 kHz resampling (the repository's
                 ``native/libmeraudio.so``, numpy fallback).
- ``ops``      : hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions, and the nvcc build that loads them;
                 the trainer's losses, metrics and host alignment.
- ``data``     : the ``.npy`` feature store, label archives, CV folds,
                 ``FeatureDataset`` and the per-dataset loaders.
- ``models``   : the attention fusion model and its Flax-weight bridge.
- ``train``    : the fusion trainer's epochs and 5-fold CV loop.
- ``encoders`` : wav2vec2 / HuBERT / data2vec / WavLM audio encoders and
                 Whisper, with HF state-dict key names.
- ``features`` : bucketed, batched audio feature extraction; Whisper
                 decoder-stub features.
- ``asr``      : KV-cached greedy Whisper decoding and the batched
                 transcript pipeline.
- ``mllm``     : the AffectGPT-equivalent MLLM (LoRA LLM, Q-Formers,
                 stream splicing), its training data and Runner.
- ``cli``      : ``extract_audio``, ``main_asr``, ``train_mllm`` and
                 ``main_release`` with the JAX CLIs' flags.

It imports nothing of the JAX package: what it needs from framework-free
modules there is copied (``io/wav.py``, ``mllm/data.py``, ``data/``,
``core/registry.py``, ``core/globals_mer.py``).
"""

__version__ = "0.1.0"
