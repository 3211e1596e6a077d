"""Read an HF checkpoint directory without ``transformers``: its
``config.json`` and its weights (``*.safetensors``, else
``pytorch_model*.bin``), shards merged. The extraction and training CLIs
load every checkpoint through :func:`read_hf_config` and
:func:`read_hf_weights`; each encoder's config fills the keys a file lacks
from ``transformers``' class defaults (:func:`with_class_defaults`), and
its ``load_hf_state_dict`` maps the raw keys onto its module.
``transformers`` is needed only for a tokenizer (:func:`load_tokenizer`).

:func:`write_hf_checkpoint` writes the same layout (``config.json`` +
``pytorch_model.bin``): ``main_release --savemodel`` saves a fine-tuned
e2e backbone so, and the extraction CLIs' ``--finetuned_ckpt`` reads it
back through :func:`read_finetuned`."""

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


def write_hf_checkpoint(path: str, config: dict, state_dict: dict) -> str:
    """Write the checkpoint directory ``path``: ``config.json`` (an HF
    config dict) and ``pytorch_model.bin`` (``torch.save`` of the state
    dict, on the CPU). Returns ``path``."""
    import torch

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, "pytorch_model.bin"))
    return path


def read_finetuned(path: str, reference: dict, load_hf_state_dict) -> dict:
    """``--finetuned_ckpt``: the weights of the checkpoint directory
    ``path`` (e.g. ``model/fold0_backbone`` of ``main_release
    --savemodel``) through the encoder's ``load_hf_state_dict``, held to
    ``reference`` (the selected architecture's state dict): the same keys
    and shapes, else ValueError naming the mismatch."""
    from .trees import check_tree_like

    restored = load_hf_state_dict(read_hf_weights(path))
    check_tree_like(restored, reference, "--finetuned_ckpt")
    print(f"loaded fine-tuned backbone from {path}")
    return restored


def load_tokenizer(path: str):
    """``transformers.AutoTokenizer`` of the checkpoint directory ``path``:
    the one place the port imports ``transformers``."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        raise SystemExit(f"{path}: its tokenizer needs the `transformers` "
                         f"package, which is not installed")
    return AutoTokenizer.from_pretrained(path)
