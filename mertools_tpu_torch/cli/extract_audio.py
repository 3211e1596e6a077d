"""Audio feature-extraction CLI (``extract_audio_huggingface.py`` equivalent)
— port of ``mertools_tpu/cli/extract_audio.py``.

    python -m mertools_tpu_torch.cli.extract_audio --model_name=chinese-hubert-large \
        --audio_dir=.../audio --save_dir=.../features --feature_level=UTTERANCE \
        --pretrain_dir=/path/to/hf/checkpoints

Loads the HF checkpoint from ``{pretrain_dir}/{model_name}`` without
``transformers`` (or builds a seeded random encoder with ``--random_init``),
reads wavs through the native frontend, and runs the bucketed batched
pipeline on ``--device`` (default ``cuda``, card index ``--gpu``). Output
layout matches the reference:
``{save_dir}/{model_name}-{UTT|FRA}/{clip}.npy``. Every model family of the
JAX CLI runs: the wav2vec2 / HuBERT / data2vec / WavLM family, Whisper,
VGGish (a torchvggish ``.pt``), fairseq wav2vec 1.0 (a ``.pt``; its z and c
features go to ``{model_name}-z-{level}`` and ``{model_name}-c-{level}``),
funasr emotion2vec (a ``.pt``) and ImageBind audio (``imagebind_huge.pth``).
For the wav2vec2 family,
``--finetuned_ckpt DIR`` replaces the loaded weights with a fine-tuned
backbone (``main_release --model=e2e_model --savemodel`` writes
``model/fold{i}_backbone``), held to the selected architecture's keys and
shapes, and ``--compute_dtype int8`` runs the transformer layers' products
as dynamic w8a8 (``ops/quant.int8_dot_general``).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.checkpoint import (read_finetuned, read_hf_config, read_hf_weights,
                               select_keys)


def load_whisper(model_name: str, pretrain_dir: str | None, random_init: bool):
    """Returns (WhisperConfig, state dict). random_init builds the JAX CLI's
    tiny seeded Whisper (d_model 64, 2 + 2 layers) for smoke runs."""
    import torch

    from ..encoders.whisper import WhisperConfig, init_params, load_hf_state_dict

    if random_init:
        cfg = WhisperConfig(d_model=64, encoder_layers=2, decoder_layers=2,
                            num_heads=4, ffn_dim=128, vocab_size=128,
                            decoder_start_token_id=120, eos_token_id=121)
        return cfg, init_params(cfg, torch.Generator().manual_seed(0))
    path = os.path.join(pretrain_dir, model_name) if pretrain_dir else model_name
    return (WhisperConfig.from_config_json(read_hf_config(path)),
            load_hf_state_dict(read_hf_weights(path)))


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

    path = os.path.join(pretrain_dir, model_name) if pretrain_dir else model_name
    return (Wav2Vec2Config.from_config_json(read_hf_config(path)),
            load_hf_state_dict(read_hf_weights(path)))


def zoo_family(lname: str) -> str | None:
    """The audio-zoo family a lower-cased model name selects, as the JAX
    CLI dispatches: "vggish", "wav2vec1" (a ``wav2vec`` name that is not
    ``wav2vec2``), "emotion2vec", "imagebind", or None (Whisper and the
    wav2vec2 family)."""
    if "whisper" in lname:
        return None
    if "vggish" in lname:
        return "vggish"
    if lname.startswith("wav2vec") and not lname.startswith("wav2vec2"):
        return "wav2vec1"
    return next((f for f in ("emotion2vec", "imagebind") if f in lname), None)


def _checkpoint_path(model_name: str, pretrain_dir: str | None, suffixes: tuple) -> str:
    path = os.path.join(pretrain_dir, model_name) if pretrain_dir else model_name
    return path if path.endswith(suffixes) else path + suffixes[0]


def load_zoo(family: str, model_name: str, pretrain_dir: str | None,
             random_init: bool, device: str):
    """The extractor of an audio-zoo family: weights from the reference's
    checkpoint file ``{pretrain_dir}/{model_name}`` (a torchvggish ``.pt``
    or ``.pth``, a fairseq wav2vec 1.0 ``.pt``, a funasr emotion2vec ``.pt``,
    ``imagebind_huge.pth``; the suffix is added when missing, as the JAX
    CLI adds it), or with ``random_init`` seeded ones at the JAX CLI's
    sizes. fairseq and funasr checkpoints carry pickled args, so they are
    read with ``weights_only=False``, as the JAX CLI reads them."""
    import torch

    from ..encoders import audio_zoo as z
    from ..encoders import emotion2vec as e2v
    from ..encoders import imagebind as ib
    from ..features import audio as fa

    gen = torch.Generator().manual_seed(0)
    if family == "vggish":
        if random_init:
            sd = z.vggish_init_params(gen)
        else:
            sd = torch.load(_checkpoint_path(model_name, pretrain_dir, (".pt", ".pth")),
                            map_location="cpu", weights_only=True)
            with torch.device("meta"):
                sd = select_keys(dict(sd), z.VGGish().state_dict(), "vggish")
        return fa.VGGishExtractor(sd, device=device)
    if family == "wav2vec1":
        if random_init:
            cfg = z.Wav2Vec1Config(enc_layers=((32, 10, 5), (32, 8, 4)),
                                   ctx_layers=((32, 3), (32, 3)))
            sd = z.wav2vec1_init_params(cfg, gen)
        else:
            ckpt = torch.load(_checkpoint_path(model_name, pretrain_dir, (".pt",)),
                              map_location="cpu", weights_only=False)
            sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
            cfg = z.Wav2Vec1Config()
            with torch.device("meta"):
                sd = select_keys(dict(sd), z.Wav2Vec1(cfg).state_dict(), "wav2vec 1.0")
        return fa.Wav2Vec1Extractor(sd, cfg, device=device)
    if family == "emotion2vec":
        if random_init:
            cfg = e2v.Emotion2VecConfig(
                conv_layers=((32, 10, 5), (32, 8, 4)), hidden_size=32, prenet_depth=1,
                depth=1, num_heads=4, conv_pos_depth=2, conv_pos_width=10,
                conv_pos_groups=4)
            sd = e2v.init_params(cfg, gen)
        else:
            cfg, sd = e2v.load_funasr_checkpoint(
                _checkpoint_path(model_name, pretrain_dir, (".pt",)))
        return fa.Emotion2VecExtractor(sd, cfg, device=device)
    if random_init:
        cfg = ib.ImageBindAudioConfig(embed_dim=32, num_blocks=2, num_heads=4,
                                      out_embed_dim=48)
        sd = ib.init_params(cfg, gen)
    else:
        sd = torch.load(_checkpoint_path(model_name, pretrain_dir, (".pth",)),
                        map_location="cpu", weights_only=True)
        cfg, sd = ib.from_imagebind_checkpoint(dict(sd))
    return fa.ImageBindAudioExtractor(cfg, sd, device=device)


def main(argv=None):
    from ..core.config import resolve_dataset_args
    from ..core.profiling import trace
    from ..features.audio import AudioExtractor, WhisperAudioExtractor
    from ..io import wav as wav_io

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
                   help="bf16: params and activations in bfloat16; int8: bf16 "
                        "with w8a8 products in the transformer layers; default "
                        "fp32 (TF32 off) for parity")
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
                   help="checkpoint dir of a fine-tuned backbone "
                        "(main_release --savemodel's model/fold{i}_backbone)")
    args = p.parse_args(argv)

    lname = args.model_name.lower()
    whisper, family = "whisper" in lname, zoo_family(lname)
    if (whisper or family) and args.finetuned_ckpt:
        raise SystemExit("--finetuned_ckpt reads a fine-tuned wav2vec2-family "
                         "backbone; e2e_model fine-tunes no "
                         f"{'Whisper' if whisper else family} encoder")
    resolve_dataset_args(args, audio_dir="audio", save_dir="features")

    level = "UTT" if args.feature_level == "UTTERANCE" else "FRA"
    if family == "wav2vec1":
        # the reference writes the feature-encoder and context features to
        # two stores (extract_wav2vec_embedding.py:36-43)
        out_dir = os.path.join(args.save_dir, f"{args.model_name}-z-{level}")
        out_dir_c = os.path.join(args.save_dir, f"{args.model_name}-c-{level}")
        os.makedirs(out_dir_c, exist_ok=True)
    else:
        out_dir = os.path.join(args.save_dir, f"{args.model_name}-{level}")
        out_dir_c = None
    os.makedirs(out_dir, exist_ok=True)

    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    if family:
        for flag, value, default in (("compute_dtype", args.compute_dtype, None),
                                     ("transfer_dtype", args.transfer_dtype, "f32")):
            if value != default:
                print(f"--{flag} {value} is ignored: the {family} extractor "
                      f"runs in fp32 on f32 samples, as the JAX package's does")
        ex = load_zoo(family, args.model_name, args.pretrain_dir, args.random_init,
                      device)
    elif whisper:
        if args.compute_dtype is not None:
            print(f"--compute_dtype {args.compute_dtype} is ignored: the "
                  f"Whisper extractor runs in fp32, as the JAX package's does")
        cfg, params = load_whisper(args.model_name, args.pretrain_dir,
                                   args.random_init)
        ex = WhisperAudioExtractor(cfg, params,
                                   transfer_dtype=args.transfer_dtype,
                                   device=device)
    else:
        cfg, params = load_encoder(args.model_name, args.pretrain_dir,
                                   args.random_init, args.encoder_size)
        if args.finetuned_ckpt:
            from ..encoders.wav2vec2 import load_hf_state_dict

            params = read_finetuned(args.finetuned_ckpt, params, load_hf_state_dict)
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
            # idempotent skip (reference behavior); the two-store run skips a
            # clip only when both stores hold it (an interrupted run may have
            # written z and not c)
            if all(os.path.exists(os.path.join(d, name + ".npy"))
                   for d in (out_dir, out_dir_c) if d is not None):
                continue
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
            if out_dir_c is not None:
                zs, cs = ex.extract_zc(wavs, level=level)
                for name in zs:
                    np.save(os.path.join(out_dir, name + ".npy"), zs[name])
                    np.save(os.path.join(out_dir_c, name + ".npy"), cs[name])
            else:
                for name, feat in ex.extract(wavs, level=level).items():
                    np.save(os.path.join(out_dir, name + ".npy"), feat)
            done += len(wavs)
            rate = done / (time.time() - t0)
            print(f"  {done} clips, {rate:.2f} clips/sec")
    print(f"Total time used: {time.time() - t0:.1f}s.")


if __name__ == "__main__":
    main()
