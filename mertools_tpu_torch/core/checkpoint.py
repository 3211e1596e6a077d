"""Read an HF checkpoint directory without ``transformers``: its
``config.json`` and its weights (``*.safetensors``, else
``pytorch_model*.bin``), shards merged. The extraction and training CLIs
load every checkpoint through :func:`read_hf_config` and
:func:`read_hf_weights`; each encoder's config fills the keys a file lacks
from ``transformers``' class defaults (:func:`with_class_defaults`), and
its ``load_hf_state_dict`` maps the raw keys onto its module.
``transformers`` is needed only for a tokenizer (:func:`load_tokenizer`)."""

from __future__ import annotations

import glob
import json
import os


def read_hf_config(path: str) -> dict:
    """``config.json`` of the HF checkpoint directory ``path`` as a dict."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise SystemExit(f"{path}: no config.json (an HF checkpoint "
                         f"directory is expected)")
    with open(cfg_path) as f:
        return json.load(f)


def with_class_defaults(raw: dict, defaults: dict) -> dict:
    """``raw`` (a ``config.json`` dict) with every key it lacks taken from
    ``defaults[raw["model_type"]]``: the values ``transformers``' config
    class of that model type starts from, which ``from_pretrained`` keeps
    for a key the file omits (an older save, or one written by hand).
    Exits on a model type that ``defaults`` does not name."""
    model_type = raw.get("model_type")
    if model_type not in defaults:
        raise SystemExit(f"config.json: model_type {model_type!r} is not one "
                         f"of {sorted(defaults)}")
    return {**defaults[model_type], **raw}


def read_hf_weights(path: str) -> dict:
    """The raw state dict (on the CPU) of the HF checkpoint directory
    ``path``, every shard merged."""
    import torch

    sd = {}
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if files:
        from safetensors.torch import load_file

        for fn in files:
            sd.update(load_file(fn))
    else:
        for fn in sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))):
            sd.update(torch.load(fn, map_location="cpu", weights_only=True))
    if not sd:
        raise SystemExit(f"{path}: no *.safetensors or pytorch_model*.bin")
    return sd


def load_tokenizer(path: str):
    """``transformers.AutoTokenizer`` of the checkpoint directory ``path``:
    the one place the port imports ``transformers``."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        raise SystemExit(f"{path}: its tokenizer needs the `transformers` "
                         f"package, which is not installed")
    return AutoTokenizer.from_pretrained(path)
