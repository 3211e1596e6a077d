"""The port's ``extract_vision`` on the ViT vision zoo against the JAX
package's CLI, on tiny checkpoints written in the real layouts
(``save_pretrained`` of ``VideoMAEModel``, ``Dinov2Model``,
``Data2VecVisionModel`` and ``SiglipVisionModel``; BLIP-2's
``eva-clip-g.pth`` timm keys): the stores agree within 2e-4 of max (fp32,
``--device cpu``), with ``--tome_r`` and ``--max_frames``; VideoMAE's
``--finetuned_ckpt`` in the HF layout; an ``eva02-*`` name takes the CLIP
route, as in the JAX CLI; ``--compute_dtype int8`` runs the ViT families in
fp32, as the JAX CLI does."""

import os

import numpy as np
import pytest
import torch

from mertools_tpu_torch.cli import extract_vision as tev
from test_torch_audio_zoo import close
from test_torch_vit_loaders import _eva_state_dict

torch.set_num_threads(1)

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A pretrain dir with one tiny checkpoint a family, and a face dir of
    three clips (70 frames, so DINOv2 resamples; 3, so VideoMAE pads)."""
    import transformers as tr

    root = tmp_path_factory.mktemp("zoo")
    ckpt = root / "ckpt"
    torch.manual_seed(0)
    models = {
        "videomae-tiny": tr.VideoMAEModel(tr.VideoMAEConfig(
            **TINY, intermediate_size=48, image_size=32, patch_size=16, num_frames=4)),
        "dinov2-tiny": tr.Dinov2Model(tr.Dinov2Config(**TINY, mlp_ratio=2, image_size=28,
                                                      patch_size=14)),
        "data2vec-vision-tiny": tr.Data2VecVisionModel(tr.Data2VecVisionConfig(
            **TINY, intermediate_size=48, image_size=32, patch_size=16,
            use_relative_position_bias=True)),
        "siglip-tiny": tr.SiglipVisionModel(tr.SiglipVisionConfig(
            **TINY, intermediate_size=48, image_size=28, patch_size=7)),
        "eva02-tiny": tr.CLIPVisionModelWithProjection(tr.CLIPVisionConfig(
            **TINY, intermediate_size=48, image_size=28, patch_size=14, projection_dim=24)),
    }
    for name, m in models.items():
        with torch.no_grad():   # draw what HF initialises to zero
            for k, v in m.named_parameters():
                if k.endswith(("q_bias", "v_bias", "relative_position_bias_table")):
                    v.normal_(0.0, 0.5)
        m.save_pretrained(str(ckpt / name))
    torch.save(_eva_state_dict(np.random.default_rng(1)), ckpt / "eva-clip-g.pth")
    faces = root / "faces"
    faces.mkdir()
    rng = np.random.default_rng(2)
    for i, n in enumerate((70, 3, 9)):
        np.save(faces / f"clip{i}.npy", rng.integers(0, 256, (n, 112, 112, 3), np.uint8))
    return ckpt, faces


def _run(zoo, tmp_path, name, level, extra=(), jax_extra=None):
    """(the port's store, the JAX CLI's store) of one invocation."""
    from mertools_tpu.cli import extract_vision as jev

    ckpt, faces = zoo
    flags = ["--model_name", name, "--pretrain_dir", str(ckpt), "--face_dir", str(faces),
             "--feature_level", level]
    jev.main(flags + list(extra if jax_extra is None else jax_extra)
             + ["--save_dir", str(tmp_path / "jax")])
    tev.main(flags + list(extra) + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    sub = f"{name}-{'UTT' if level == 'UTTERANCE' else 'FRA'}"
    return tuple({f[:-4]: np.load(d / sub / f) for f in sorted(os.listdir(d / sub))}
                 for d in (tmp_path / "port", tmp_path / "jax"))


def _assert_close(out, ref):
    assert sorted(out) == sorted(ref)
    for n in ref:
        close(out[n], ref[n])


# family -> its invocations (level, flags)
RUNS = {"dinov2-tiny": (("FRAME", []), ("UTTERANCE", ["--tome_r", "1"])),
        "data2vec-vision-tiny": (("FRAME", []),),
        "eva-clip-g": (("UTTERANCE", ["--tome_r", "1", "--max_frames", "8"]),),
        "siglip-tiny": (("FRAME", ["--max_frames", "8"]), ("UTTERANCE", ["--tome_r", "3"]))}


@pytest.mark.parametrize("name", list(RUNS))
def test_stores_match_the_jax_cli(zoo, tmp_path, name):
    for i, (level, extra) in enumerate(RUNS[name]):
        out, ref = _run(zoo, tmp_path / str(i), name, level, extra)
        _assert_close(out, ref)
        rows = {"dinov2": 64, "data2vec": 70}.get(name.split("-")[0], 8)
        assert out["clip0"].shape == ((rows, 32) if level == "FRAME" else (32,))


def test_videomae_stores_and_finetuned_ckpt_in_the_hf_layout(zoo, tmp_path):
    """VideoMAE's FRA and UTT stores against the JAX CLI's; then
    ``--finetuned_ckpt``: a ``save_pretrained`` VideoMAE with moved weights
    replaces the pretrained one (equal to the JAX CLI run on the moved
    checkpoint); a checkpoint one layer short is refused with the JAX CLI's
    message."""
    import transformers as tr

    for level in ("FRAME", "UTTERANCE"):
        out, ref = _run(zoo, tmp_path / level, "videomae-tiny", level)
        _assert_close(out, ref)
        assert out["clip0"].shape == ((2, 32) if level == "FRAME" else (32,))
    ckpt, faces = zoo
    model = tr.VideoMAEModel.from_pretrained(str(ckpt / "videomae-tiny"))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for v in model.parameters():
            v.add_(0.05 * torch.randn(v.shape, generator=g))
    model.save_pretrained(str(tmp_path / "ft" / "videomae-tiny"))
    model.config.num_hidden_layers = 1
    tr.VideoMAEModel(model.config).save_pretrained(str(tmp_path / "shallow"))

    from mertools_tpu.cli import extract_vision as jev

    flags = ["--model_name", "videomae-tiny", "--face_dir", str(faces)]
    jev.main(flags + ["--pretrain_dir", str(tmp_path / "ft"), "--save_dir", str(tmp_path / "jax")])
    tev.main(flags + ["--pretrain_dir", str(ckpt), "--finetuned_ckpt",
                      str(tmp_path / "ft" / "videomae-tiny"), "--save_dir",
                      str(tmp_path / "port"), "--device", "cpu"])
    sub = "videomae-tiny-UTT"
    read = lambda d: {f[:-4]: np.load(d / sub / f) for f in sorted(os.listdir(d / sub))}
    _assert_close(read(tmp_path / "port"), read(tmp_path / "jax"))
    with pytest.raises(ValueError, match="checkpoint tree does not match the selected "
                                         "model architecture"):
        tev.main(flags + ["--pretrain_dir", str(ckpt), "--finetuned_ckpt",
                          str(tmp_path / "shallow"), "--save_dir", str(tmp_path / "x"),
                          "--device", "cpu"])


def test_eva02_names_and_int8_follow_the_jax_cli(zoo, tmp_path):
    """Two JAX CLI behaviours the port copies (ROADMAP, reference-side
    findings): an ``eva02-*`` name takes the CLIP route (the JAX CLI has no
    EVA-02 branch, though its docstring lists one), in both CLIs; and
    ``--compute_dtype int8`` acts on CLIP only: on DINOv2 the port's int8
    store equals the JAX CLI's within 2e-4 and its own fp32 store bit for
    bit."""
    out, ref = _run(zoo, tmp_path / "eva02", "eva02-tiny", "UTTERANCE", ["--max_frames", "8"])
    _assert_close(out, ref)
    assert out["clip0"].shape == (24,)      # CLIP's projection width
    out, ref = _run(zoo, tmp_path / "int8", "dinov2-tiny", "UTTERANCE",
                    ["--compute_dtype", "int8"])
    _assert_close(out, ref)
    tev.main(["--model_name", "dinov2-tiny", "--pretrain_dir", str(zoo[0]), "--face_dir",
              str(zoo[1]), "--save_dir", str(tmp_path / "fp32"), "--device", "cpu"])
    sub = tmp_path / "fp32" / "dinov2-tiny-UTT"
    for n, f in out.items():
        np.testing.assert_array_equal(np.load(sub / f"{n}.npy"), f)
