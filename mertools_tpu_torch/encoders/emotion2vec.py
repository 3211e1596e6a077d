"""emotion2vec audio encoder (data2vec 2.0 architecture) in PyTorch — port
of ``mertools_tpu/encoders/emotion2vec.py``.

The reference extracts emotion2vec features through funasr
(``MER2024/run-mer2024.sh:46``), whose checkpoint is a fairseq
*data2vec-multi* audio model: a conv local encoder, a linear feature
projection, a grouped-conv relative positional encoder, ``prenet_depth``
transformer blocks inside the modality encoder plus ``depth`` main blocks
(fused-qkv ViT-style, pre-norm), and a final LayerNorm. funasr's extraction
applies a per-utterance layer_norm to the raw wav and keeps the last hidden
state (frame level) or its mean (utterance level).

The module carries the funasr key layout, so a converted checkpoint is a
subset of the funasr state dict::

    modality_encoders.AUDIO.local_encoder.conv_layers.N.{0,2.1}.*
    modality_encoders.AUDIO.project_features.*   (or .1 LayerNorm + .2 Linear)
    modality_encoders.AUDIO.relative_positional_encoder.N.0.*
    modality_encoders.AUDIO.context_encoder.blocks.M.{norm1,attn.qkv,
        attn.proj,norm2,mlp.fc1,mlp.fc2}.*
    blocks.K.{...same...}
    norm.*

EMA teacher and decoder keys are left out (the inference path only). The
norms are masked as in the JAX package, so a right-padded batch gives each
clip what it gets alone. The attention is a dense product with a ``-1e30``
key bias, as JAX's einsum (it has no flash route).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import select_keys
from ..core.flax_init import init_flax_style

CONV_LAYERS_BASE = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                    (512, 3, 2), (512, 2, 2), (512, 2, 2))
A = "modality_encoders.AUDIO."


@dataclass(frozen=True)
class Emotion2VecConfig:
    conv_layers: tuple = CONV_LAYERS_BASE
    hidden_size: int = 768
    prenet_depth: int = 4        # modality_encoders.AUDIO.context_encoder
    depth: int = 8               # main blocks
    num_heads: int = 12
    mlp_ratio: int = 4
    conv_pos_depth: int = 5
    conv_pos_width: int = 95     # kernel per layer = max(3, width//depth)
    conv_pos_groups: int = 16
    conv_bias: bool = False
    project_ln: bool = False     # LayerNorm before project_features (some
                                 # fairseq builds nest LN+Linear in the
                                 # project_features Sequential)
    ln_eps: float = 1e-5

    @property
    def conv_pos_kernel(self) -> int:
        return max(3, self.conv_pos_width // self.conv_pos_depth)


def out_lengths(n: np.ndarray, cfg: Emotion2VecConfig) -> np.ndarray:
    n = np.asarray(n)
    for _, k, s in cfg.conv_layers:
        n = (n - k) // s + 1
    return n


class _TransposedLN(nn.Sequential):
    """fairseq's ``Sequential(TransposeLast, LayerNorm, TransposeLast)``:
    its LayerNorm sits at index 1 (the ``2.1`` of the conv layers' keys)."""

    def __init__(self, dim: int, eps: float):
        super().__init__(nn.Identity(), nn.LayerNorm(dim, eps=eps))


class _LocalEncoder(nn.Module):
    """fairseq ConvFeatureExtractionModel, mode='layer_norm'."""

    def __init__(self, cfg: Emotion2VecConfig):
        super().__init__()
        layers, c_in = [], 1
        for dim, k, s in cfg.conv_layers:
            layers.append(nn.Sequential(
                nn.Conv1d(c_in, dim, k, stride=s, bias=cfg.conv_bias), nn.Identity(),
                _TransposedLN(dim, cfg.ln_eps)))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        # x (B, T) raw wav, mask (B, T) valid samples
        h, m = x[:, None], mask                             # (B, 1, T) NCW
        for (_, k, s), layer in zip(self.cfg.conv_layers, self.conv_layers):
            h = layer[0](h)
            # a frame is valid iff its receptive field lies inside the clip:
            # the conv length recurrence on the mask
            n_valid = torch.div(m.sum(-1) - k, s, rounding_mode="floor") + 1
            m = (torch.arange(h.shape[2], device=h.device)[None, :]
                 < torch.clamp_min(n_valid, 0)[:, None])
            h = layer[2][1](h.transpose(1, 2)).transpose(1, 2)
            h = torch.where(m[:, None, :], F.gelu(h), 0.0)
        return h.transpose(1, 2), m                         # (B, T', C)


class _Attention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.qkv = nn.Linear(H, 3 * H)
        self.proj = nn.Linear(H, H)


class _Mlp(nn.Module):
    def __init__(self, H: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(H, hidden)
        self.fc2 = nn.Linear(hidden, H)


class _Block(nn.Module):
    """Pre-norm block: dense attention with an additive key bias, exact
    GELU MLP."""

    def __init__(self, cfg: Emotion2VecConfig):
        super().__init__()
        H = cfg.hidden_size
        self.norm1 = nn.LayerNorm(H, eps=cfg.ln_eps)
        self.attn = _Attention(H)
        self.norm2 = nn.LayerNorm(H, eps=cfg.ln_eps)
        self.mlp = _Mlp(H, cfg.mlp_ratio * H)
        self.nh = cfg.num_heads

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        hd = H // self.nh
        q, k, v = self.attn.qkv(self.norm1(x)).view(B, T, 3, self.nh, hd).unbind(2)
        logits = torch.einsum("bqnd,bknd->bnqk", q * hd ** -0.5, k) + attn_bias
        o = torch.einsum("bnqk,bknd->bqnd", logits.softmax(-1), v).reshape(B, T, H)
        x = x + self.attn.proj(o)
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class _AudioEncoder(nn.Module):
    def __init__(self, cfg: Emotion2VecConfig):
        super().__init__()
        H, k = cfg.hidden_size, cfg.conv_pos_kernel
        self.local_encoder = _LocalEncoder(cfg)
        c_out = cfg.conv_layers[-1][0]
        if cfg.project_ln:
            self.project_features = nn.Sequential(
                nn.Identity(), nn.LayerNorm(c_out, eps=cfg.ln_eps), nn.Linear(c_out, H))
        else:
            self.project_features = nn.Linear(c_out, H)
        self.relative_positional_encoder = nn.ModuleList(
            nn.Sequential(nn.Conv1d(H, H, k, padding=k // 2, groups=cfg.conv_pos_groups))
            for _ in range(cfg.conv_pos_depth))
        self.context_encoder = nn.Module()
        self.context_encoder.blocks = nn.ModuleList(
            _Block(cfg) for _ in range(cfg.prenet_depth))
        self.cfg = cfg

    def conv_pos(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """depth x (grouped conv k, SamePad, LayerNorm without affine, GELU),
        masked."""
        keep = mask[:, :, None]
        h = torch.where(keep, x, 0.0).transpose(1, 2)          # (B, H, T)
        for layer in self.relative_positional_encoder:
            h = layer[0](h)
            if self.cfg.conv_pos_kernel % 2 == 0:               # SamePad trims one
                h = h[:, :, :-1]
            h = F.layer_norm(h.transpose(1, 2), (h.shape[1],), eps=self.cfg.ln_eps)
            h = torch.where(keep, F.gelu(h), 0.0).transpose(1, 2)
        return h.transpose(1, 2)


class Emotion2Vec(nn.Module):
    """(B, T) wav + (B,) lengths -> (B, T', H) frames + (B, T') mask."""

    def __init__(self, cfg: Emotion2VecConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or Emotion2VecConfig()
        self.modality_encoders = nn.ModuleDict({"AUDIO": _AudioEncoder(cfg)})
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor):
        audio = self.modality_encoders["AUDIO"]
        T = wav.shape[1]
        smask = torch.arange(T, device=wav.device)[None, :] < lengths[:, None]
        # funasr: F.layer_norm(source, source.shape) per utterance, masked
        # so a padded batch equals per-clip execution
        sm = smask.to(wav.dtype)
        n = torch.clamp_min(sm.sum(-1, keepdim=True), 1.0)
        mu = (wav * sm).sum(-1, keepdim=True) / n
        var = ((wav - mu) * sm).square().sum(-1, keepdim=True) / n
        x = (wav - mu) * torch.rsqrt(var + 1e-5) * sm

        h, fmask = audio.local_encoder(x, smask)
        h = audio.project_features(h)
        h = h + audio.conv_pos(h, fmask)
        bias = torch.where(fmask[:, None, None, :], 0.0, -1e30).to(h.dtype)
        for blk in [*audio.context_encoder.blocks, *self.blocks]:
            h = blk(h, bias)
        return torch.where(fmask[..., None], self.norm(h), 0.0), fmask


def init_params(cfg: Emotion2VecConfig, generator: torch.Generator) -> dict:
    """Seeded weights with Flax's default initialisers, as the JAX CLI's
    ``--random_init`` draws emotion2vec."""
    with torch.device("meta"):
        model = Emotion2Vec(cfg)
    return init_flax_style(model.to_empty(device=generator.device), generator).state_dict()


# ---------------------------------------------------------------------------
# funasr / fairseq state dicts
# ---------------------------------------------------------------------------


def config_from_state(sd: dict, conv_strides: tuple | None = None,
                      num_heads: int = 12) -> Emotion2VecConfig:
    """The configuration the weights imply, inferred as the JAX package's
    ``convert_funasr_state`` infers it: conv strides (not recoverable from
    weights) follow the wav2vec2 schedule ``(5,2,2,2,2,2,2)`` unless
    ``conv_strides`` overrides, and ``num_heads`` defaults to the base
    model's 12."""
    n_conv = len([k for k in sd if k.startswith(A + "local_encoder.conv_layers")
                  and k.endswith(".0.weight")])
    n_pre = 1 + max([int(k[len(A + "context_encoder.blocks."):].split(".")[0])
                     for k in sd if k.startswith(A + "context_encoder.blocks.")] or [-1])
    n_main = 1 + max([int(k.split(".")[1]) for k in sd if k.startswith("blocks.")]
                     or [-1])
    if conv_strides is None:
        conv_strides = tuple(s for _, _, s in CONV_LAYERS_BASE)[:n_conv]
    conv_layers = []
    for i in range(n_conv):
        w = sd[A + f"local_encoder.conv_layers.{i}.0.weight"]   # (out, in, k)
        conv_layers.append((w.shape[0], w.shape[2], conv_strides[i]))
    proj_nested = (A + "project_features.2.weight") in sd
    H = sd[A + ("project_features.2.weight" if proj_nested
                else "project_features.weight")].shape[0]
    fc1 = sd["blocks.0.mlp.fc1.weight" if n_main
             else A + "context_encoder.blocks.0.mlp.fc1.weight"]
    pos_keys = sorted(k for k in sd if k.startswith(A + "relative_positional_encoder.")
                      and k.endswith(".0.weight"))
    wpos = sd[pos_keys[0]]
    return Emotion2VecConfig(
        conv_layers=tuple(conv_layers), hidden_size=H, prenet_depth=n_pre,
        depth=n_main, project_ln=proj_nested, num_heads=num_heads,
        mlp_ratio=fc1.shape[0] // H, conv_pos_depth=len(pos_keys),
        conv_pos_width=wpos.shape[2] * len(pos_keys),
        conv_pos_groups=H // wpos.shape[1],
        conv_bias=(A + "local_encoder.conv_layers.0.0.bias") in sd)


def convert_funasr_state(sd: dict, cfg: Emotion2VecConfig | None = None,
                         conv_strides: tuple | None = None, num_heads: int = 12
                         ) -> tuple[Emotion2VecConfig, dict]:
    """A fairseq data2vec-multi (emotion2vec) state dict -> (config, this
    module's state dict): ``_ema``/``decoder`` keys (teacher and
    pretraining only) and every other key the module lacks are left out."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()
          if not (k.startswith("_ema") or ".decoder." in k or k.startswith("decoder."))}
    cfg = cfg or config_from_state(sd, conv_strides, num_heads)
    with torch.device("meta"):
        keys = Emotion2Vec(cfg).state_dict().keys()
    return cfg, select_keys(sd, keys, "emotion2vec")


def load_funasr_checkpoint(path: str) -> tuple[Emotion2VecConfig, dict]:
    """Load a funasr emotion2vec ``.pt`` (fairseq checkpoints carry pickled
    args, so it is read with ``weights_only=False``, as the JAX package
    reads it) and convert."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model", blob.get("state_dict", blob))
    return convert_funasr_state(sd)


def state_dict_from_flax(cfg: Emotion2VecConfig, params) -> dict:
    """The JAX package's Emotion2Vec param tree -> this module's (funasr)
    state dict; the inverse of ``convert_funasr_state``
    (``emotion2vec.py:190-288``)."""
    sd: dict = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def dense(key, p):
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T)
        sd[f"{key}.bias"] = t(p["bias"])

    def ln(key, p):
        sd[f"{key}.weight"] = t(p["scale"])
        sd[f"{key}.bias"] = t(p["bias"])

    for i in range(len(cfg.conv_layers)):
        p, key = params["local"][f"conv{i}"], A + f"local_encoder.conv_layers.{i}"
        sd[f"{key}.0.weight"] = t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        if cfg.conv_bias:
            sd[f"{key}.0.bias"] = t(p["bias"])
        ln(f"{key}.2.1", params["local"][f"ln{i}"])
    if cfg.project_ln:
        ln(A + "project_features.1", params["project_ln"])
        dense(A + "project_features.2", params["project_features"])
    else:
        dense(A + "project_features", params["project_features"])
    for i in range(cfg.conv_pos_depth):
        p = params["pos_conv"][f"pos{i}"]
        sd[A + f"relative_positional_encoder.{i}.0.weight"] = t(
            np.asarray(p["kernel"]).transpose(2, 1, 0))
        sd[A + f"relative_positional_encoder.{i}.0.bias"] = t(p["bias"])

    def block(prefix, p):
        ln(f"{prefix}.norm1", p["norm1"])
        ln(f"{prefix}.norm2", p["norm2"])
        dense(f"{prefix}.attn.qkv", p["qkv"])
        dense(f"{prefix}.attn.proj", p["proj"])
        dense(f"{prefix}.mlp.fc1", p["fc1"])
        dense(f"{prefix}.mlp.fc2", p["fc2"])

    for i in range(cfg.prenet_depth):
        block(A + f"context_encoder.blocks.{i}", params[f"pre{i}"])
    for i in range(cfg.depth):
        block(f"blocks.{i}", params[f"blk{i}"])
    ln("norm", params["norm"])
    return sd
