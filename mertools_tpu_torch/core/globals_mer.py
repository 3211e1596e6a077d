"""MER label maps and feature-store directory names (the port's copy of
what it uses from ``mertools_tpu/core/globals_mer.py``).

Values are part of the MER challenge protocol (reference
``MERBench/toolkit/globals.py:2-5``), with the encoder names that the
unimodal rankings of top-N fusion use (``globals.py:11-136,199-215``).
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
WHISPER_BASE = "whisper-base"
WHISPER_LARGE = "whisper-large-v2"
VGGISH = "vggish"

BERT_BASE = "bert-base-chinese"
MACBERT_BASE = "chinese-macbert-base"
MACBERT_LARGE = "chinese-macbert-large"
ROBERTA_BASE = "chinese-roberta-wwm-ext"
ROBERTA_LARGE = "chinese-roberta-wwm-ext-large"
XLM_ROBERTA_LARGE = "xlm-roberta-large"
ELECTRA_BASE = "chinese-electra-180g-base"
BAICHUAN2_7B = "baichuan2-7b-base"

CLIP_VIT_BASE = "clip-vit-base-patch32"
CLIP_VIT_LARGE = "clip-vit-large-patch14"
EVA02_BASE = "eva02-base-patch14-224"
DATA2VEC_VISION_BASE = "data2vec-vision-base"
DINOV2_LARGE = "dinov2-large"
VIDEOMAE_BASE = "videomae-base"
MANET = "manet"
RESNET_MSCELEB = "resnet-msceleb"
RESNET_IMAGENET = "resnet-imagenet"

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
