"""Audio feature-extraction CLI (``extract_audio_huggingface.py`` equivalent)
— port of ``mertools_tpu/cli/extract_audio.py``.

    python -m mertools_tpu_torch.cli.extract_audio --model_name=chinese-hubert-large \
        --audio_dir=.../audio --save_dir=.../features --feature_level=UTTERANCE \
        --pretrain_dir=/path/to/hf/checkpoints

Loads the HF checkpoint from ``{pretrain_dir}/{model_name}`` (or builds a
seeded random encoder with ``--random_init``), reads wavs through the native
frontend, and runs the bucketed batched pipeline on ``--device`` (default
``cuda``, card index ``--gpu``). Output layout matches the reference:
``{save_dir}/{model_name}-{UTT|FRA}/{clip}.npy``. The wav2vec2 / HuBERT /
data2vec / WavLM family is ported; the other encoders exit with the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# model-name fragment -> the ROADMAP item that ports its extractor
_NOT_PORTED = (
    ("whisper", "A8, the Whisper feature and ASR slice"),
    ("vggish", "A9, the remaining encoder zoo"),
    ("emotion2vec", "A9, the remaining encoder zoo"),
    ("imagebind", "A9, the remaining encoder zoo"),
)


def _not_ported(lname: str) -> str | None:
    if lname.startswith("wav2vec") and not lname.startswith("wav2vec2"):
        return "A9, the remaining encoder zoo (wav2vec-1.0)"
    for frag, item in _NOT_PORTED:
        if frag in lname:
            return item
    return None


def load_encoder(model_name: str, pretrain_dir: str | None, random_init: bool,
                 size: str = "large"):
    """Returns (cfg, state dict). random_init builds a seeded random encoder
    of the given size (for smoke tests / benchmarks without checkpoints)."""
    import torch

    from ..encoders.wav2vec2 import Wav2Vec2Config, init_params, load_hf_state_dict

    if random_init:
        if size == "tiny":  # smoke: 2 conv layers, 4 transformer layers
            cfg = Wav2Vec2Config(hidden_size=64, num_hidden_layers=4,
                                 num_attention_heads=2, intermediate_size=128,
                                 conv_dim=(32, 32), conv_kernel=(10, 3),
                                 conv_stride=(5, 2),
                                 num_conv_pos_embeddings=16,
                                 num_conv_pos_embedding_groups=2)
        else:
            cfg = (Wav2Vec2Config.large() if size == "large"
                   else Wav2Vec2Config.base())
        return cfg, init_params(cfg, torch.Generator().manual_seed(0))

    from transformers import AutoModel

    path = os.path.join(pretrain_dir, model_name) if pretrain_dir else model_name
    model = AutoModel.from_pretrained(path)
    return (Wav2Vec2Config.from_hf(model.config),
            load_hf_state_dict(model.state_dict()))


def main(argv=None):
    from ..core.config import resolve_dataset_args
    from ..core.profiling import trace
    from ..features.audio import AudioExtractor
    from mertools_tpu.io import wav as wav_io

    p = argparse.ArgumentParser("extract_audio")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--dataset", type=str, default=None,
                   help="resolve dirs from the path registry (run.sh style)")
    p.add_argument("--audio_dir", type=str, default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--feature_level", type=str, default="UTTERANCE",
                   choices=["UTTERANCE", "FRAME"])
    p.add_argument("--pretrain_dir", type=str, default=None)
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights (smoke/bench without checkpoints)")
    p.add_argument("--encoder_size", type=str, default="large",
                   choices=["tiny", "base", "large"])
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "bf16", "int8"],
                   help="bf16: params and activations in bfloat16; int8 is not "
                        "ported yet; default fp32 (TF32 off) for parity")
    p.add_argument("--transfer_dtype", type=str, default="f32",
                   choices=["f32", "int16"],
                   help="int16: ship PCM16 to the device (half the bytes; "
                        "exact for 16 kHz PCM16 sources) and normalize there")
    p.add_argument("--batch_budget_sec", type=int, default=80,
                   help="audio seconds per device batch")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace to this dir")
    p.add_argument("--finetuned_ckpt", type=str, default=None,
                   help="orbax dir of a fine-tuned backbone (not ported yet)")
    args = p.parse_args(argv)

    item = _not_ported(args.model_name.lower())
    if item is not None:
        raise SystemExit(f"{args.model_name}: this extractor is not ported to "
                         f"mertools_tpu_torch yet (ROADMAP {item}); use "
                         f"python -m mertools_tpu.cli.extract_audio")
    if args.finetuned_ckpt:
        raise SystemExit("--finetuned_ckpt restores an orbax checkpoint of the "
                         "JAX trainer, which is not ported yet (ROADMAP A17)")
    resolve_dataset_args(args, audio_dir="audio", save_dir="features")

    level = "UTT" if args.feature_level == "UTTERANCE" else "FRA"
    out_dir = os.path.join(args.save_dir, f"{args.model_name}-{level}")
    os.makedirs(out_dir, exist_ok=True)

    cfg, params = load_encoder(args.model_name, args.pretrain_dir,
                               args.random_init, args.encoder_size)
    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    ex = AudioExtractor(cfg, params,
                        sample_budget=args.batch_budget_sec * 16000,
                        compute_dtype=args.compute_dtype,
                        transfer_dtype=args.transfer_dtype, device=device)

    files = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
    print(f"extracting {len(files)} wavs -> {out_dir}")
    t0 = time.time()
    # stream in chunks to bound host memory; a prefetch thread reads chunk
    # i+1 from disk while the device works on chunk i
    chunk = 256

    def read_chunk(batch_files):
        wavs = {}
        for f in batch_files:
            name = os.path.splitext(os.path.basename(f))[0]
            if os.path.exists(os.path.join(out_dir, name + ".npy")):
                continue  # idempotent skip (reference behavior)
            wavs[name] = wav_io.read_wav_16k(f)
        return wavs

    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    done = 0
    with prof, ThreadPoolExecutor(max_workers=1) as pool:
        chunks = [files[i: i + chunk] for i in range(0, len(files), chunk)]
        nxt = pool.submit(read_chunk, chunks[0]) if chunks else None
        for ci in range(len(chunks)):
            wavs = nxt.result()
            nxt = (pool.submit(read_chunk, chunks[ci + 1])
                   if ci + 1 < len(chunks) else None)
            if not wavs:
                continue
            feats = ex.extract(wavs, level=level)
            for name, feat in feats.items():
                np.save(os.path.join(out_dir, name + ".npy"), feat)
            done += len(wavs)
            rate = done / (time.time() - t0)
            print(f"  {done} clips, {rate:.2f} clips/sec")
    print(f"Total time used: {time.time() - t0:.1f}s.")


if __name__ == "__main__":
    main()
