"""MER label maps and feature-store directory names (the port's copy of
what it uses from ``mertools_tpu/core/globals_mer.py``).

Values are part of the MER challenge protocol (reference
``MERBench/toolkit/globals.py:2-5``), with the encoder names that the
unimodal rankings of top-N fusion use (``globals.py:11-136,199-215``) and
the per-modality name lists by which ``e2e_model`` picks its modality.
"""

from __future__ import annotations

EMOS_MER = ["neutral", "angry", "happy", "sad", "worried", "surprise"]
EMO2IDX_MER = {emo: idx for idx, emo in enumerate(EMOS_MER)}

# Sentinel used for missing valence labels
# (reference: MERBench/toolkit/dataloader/mer2023.py:97-101)
MISSING_VAL = -10.0

# -- encoder names the rankings use (reference globals.py:11-136) --
HUBERT_BASE = "chinese-hubert-base"
HUBERT_LARGE = "chinese-hubert-large"
WAV2VEC2_BASE = "chinese-wav2vec2-base"
WAV2VEC2_LARGE = "chinese-wav2vec2-large"
WAVLM_BASE = "wavlm-base"
WAVLM_LARGE = "wavlm-large"
DATA2VEC_AUDIO_BASE = "data2vec-audio-base-960h"
WHISPER_BASE = "whisper-base"
WHISPER_LARGE = "whisper-large-v2"
VGGISH = "vggish"
EMOTION2VEC = "emotion2vec"

BERT_BASE = "bert-base-chinese"
MACBERT_BASE = "chinese-macbert-base"
MACBERT_LARGE = "chinese-macbert-large"
ROBERTA_BASE = "chinese-roberta-wwm-ext"
ROBERTA_LARGE = "chinese-roberta-wwm-ext-large"
XLM_ROBERTA_LARGE = "xlm-roberta-large"
ELECTRA_BASE = "chinese-electra-180g-base"
DEBERTA_LARGE = "deberta-chinese-large"
LLAMA2_7B = "llama-2-7b"
BAICHUAN2_7B = "baichuan2-7b-base"
QWEN_7B = "qwen-7b"

CLIP_VIT_BASE = "clip-vit-base-patch32"
CLIP_VIT_LARGE = "clip-vit-large-patch14"
EVA02_BASE = "eva02-base-patch14-224"
DATA2VEC_VISION_BASE = "data2vec-vision-base"
DINOV2_LARGE = "dinov2-large"
VIDEOMAE_BASE = "videomae-base"
VIDEOMAE_LARGE = "videomae-large"
MANET = "manet"
EMONET = "emonet"
RESNET50_FERPLUS = "resnet50-ferplus-dag"
SENET50_FERPLUS = "senet50-ferplus-dag"
RESNET_MSCELEB = "resnet-msceleb"
RESNET_IMAGENET = "resnet-imagenet"

# -- every encoder of a modality (reference globals.py:11-136) --
WHOLE_AUDIO = [
    HUBERT_BASE, HUBERT_LARGE, WAV2VEC2_BASE, WAV2VEC2_LARGE,
    WAVLM_BASE, WAVLM_LARGE, DATA2VEC_AUDIO_BASE,
    WHISPER_BASE, WHISPER_LARGE, VGGISH, EMOTION2VEC,
]
WHOLE_TEXT = [
    BERT_BASE, MACBERT_BASE, MACBERT_LARGE, ROBERTA_BASE, ROBERTA_LARGE,
    XLM_ROBERTA_LARGE, ELECTRA_BASE, DEBERTA_LARGE,
    LLAMA2_7B, BAICHUAN2_7B, QWEN_7B,
]
WHOLE_IMAGE = [
    CLIP_VIT_BASE, CLIP_VIT_LARGE, EVA02_BASE, DATA2VEC_VISION_BASE,
    DINOV2_LARGE, VIDEOMAE_BASE, VIDEOMAE_LARGE,
    MANET, EMONET, RESNET50_FERPLUS, SENET50_FERPLUS,
    RESNET_MSCELEB, RESNET_IMAGENET,
]

# -- unimodal quality rankings (low -> high) used by top-N fusion
# (reference globals.py:199-215 / MER2024 top-N fusion) --
AUDIO_RANK_LOW2HIGH = [
    VGGISH, WAV2VEC2_BASE, WAVLM_BASE, WHISPER_BASE,
    WAV2VEC2_LARGE, WAVLM_LARGE, WHISPER_LARGE, HUBERT_BASE, HUBERT_LARGE,
]
TEXT_RANK_LOW2HIGH = [
    ELECTRA_BASE, BERT_BASE, XLM_ROBERTA_LARGE, ROBERTA_BASE,
    MACBERT_BASE, MACBERT_LARGE, ROBERTA_LARGE, BAICHUAN2_7B,
]
IMAGE_RANK_LOW2HIGH = [
    RESNET_IMAGENET, DATA2VEC_VISION_BASE, VIDEOMAE_BASE, EVA02_BASE,
    MANET, RESNET_MSCELEB, DINOV2_LARGE, CLIP_VIT_BASE, CLIP_VIT_LARGE,
]


def feature_dir_name(model_name: str, level: str) -> str:
    """Feature-store directory name for (encoder, level).

    level: "UTT" (one vector per clip) or "FRA" (frame/token sequence).
    """
    if level not in ("UTT", "FRA"):
        raise ValueError(f"level must be UTT or FRA, got {level!r}")
    return f"{model_name}-{level}"
