"""The port's extract_text and extract_vision CLIs against the JAX package's
on the same checkpoint directories, written by ``transformers``'
``save_pretrained`` (a BertForMaskedLM of 4 layers with a BertTokenizer
from a temporary vocab.txt; a CLIPVisionModelWithProjection of 2 layers at
56 px): the ``.npy`` files agree within 1e-4 (fp32, ``--device cpu``);
``--finetuned_ckpt`` and vision's ``--compute_dtype int8``; the branches not
ported exit naming their ROADMAP item."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from mertools_tpu_torch.cli import extract_text as tet
from mertools_tpu_torch.cli import extract_vision as tev

torch.set_num_threads(1)

TOL = 1e-4
CHARS = "今天天气真好我很高兴你为什么生气了吗不知道"


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    import transformers as tr

    d = tmp_path_factory.mktemp("ckpt") / "tiny-macbert"
    d.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(CHARS))
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    tr.BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    cfg = tr.BertConfig(hidden_size=16, num_hidden_layers=4,
                        num_attention_heads=2, intermediate_size=32,
                        vocab_size=len(vocab), max_position_embeddings=64)
    torch.manual_seed(0)
    tr.BertForMaskedLM(cfg).save_pretrained(str(d))
    return d


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    import transformers as tr

    d = tmp_path_factory.mktemp("ckpt") / "clip-tiny"
    cfg = tr.CLIPVisionConfig(hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=2, intermediate_size=64,
                              image_size=56, patch_size=14, projection_dim=24)
    torch.manual_seed(0)
    tr.CLIPVisionModelWithProjection(cfg).save_pretrained(str(d))
    return d


def _transcripts(path):
    rng = np.random.default_rng(0)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name", "chinese"])
        for i, n in enumerate((5, 12, 3, 30)):
            w.writerow([f"sample_{i:08d}",
                        "".join(rng.choice(list(CHARS), size=n))])
        w.writerow(["sample_empty", ""])


def _read(d):
    return {f[:-4]: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def _assert_same(out, ref):
    assert sorted(out) == sorted(ref)
    for n in ref:
        assert out[n].shape == ref[n].shape, n
        assert np.abs(out[n] - ref[n]).max() < TOL, n


@pytest.mark.parametrize("level", ["UTTERANCE", "FRAME"])
def test_extract_text_matches_jax_cli(bert_dir, tmp_path, level):
    from mertools_tpu.cli import extract_text as jet

    _transcripts(tmp_path / "trans.csv")
    flags = ["--model_name", bert_dir.name, "--pretrain_dir", str(bert_dir.parent),
             "--trans_path", str(tmp_path / "trans.csv"),
             "--feature_level", level]
    jet.main(flags + ["--save_dir", str(tmp_path / "jax")])
    tet.main(flags + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    sub = f"{bert_dir.name}-{'UTT' if level == 'UTTERANCE' else 'FRA'}"
    ref, out = _read(tmp_path / "jax" / sub), _read(tmp_path / "port" / sub)
    _assert_same(out, ref)
    assert len(out) == 5 and not out["sample_empty"].any()
    assert out["sample_empty"].shape == ((16,) if level == "UTTERANCE" else (1, 16))


@pytest.mark.parametrize("level", ["UTTERANCE", "FRAME"])
def test_extract_vision_matches_jax_cli(clip_dir, tmp_path, level):
    from mertools_tpu.cli import extract_vision as jev

    faces = tmp_path / "faces"
    faces.mkdir()
    rng = np.random.default_rng(1)
    for i, t in enumerate((2, 5, 9)):
        np.save(faces / f"clip{i}.npy",
                rng.integers(0, 256, size=(t, 112, 112, 3)).astype(np.uint8))
    flags = ["--model_name", clip_dir.name, "--pretrain_dir", str(clip_dir.parent),
             "--face_dir", str(faces), "--feature_level", level,
             "--max_frames", "8"]
    jev.main(flags + ["--save_dir", str(tmp_path / "jax")])
    tev.main(flags + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    sub = f"{clip_dir.name}-{'UTT' if level == 'UTTERANCE' else 'FRA'}"
    out = _read(tmp_path / "port" / sub)
    _assert_same(out, _read(tmp_path / "jax" / sub))
    assert out["clip2"].shape == ((24,) if level == "UTTERANCE" else (8, 24))


def _config_only(tmp_path, model_type):
    d = tmp_path / f"m-{model_type}"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": model_type}))
    return str(d)


@pytest.mark.parametrize("model_type,item", [
    ("llama", "A9, the decoder-LLM text branch"), ("qwen2", "A9"),
    ("chatglm", "A9, the text encoder zoo"), ("gpt2", "A9"),
    ("deberta-v2", "A9")])
def test_extract_text_exits_naming_the_roadmap_item(tmp_path, model_type, item):
    with pytest.raises(SystemExit, match=item):
        tet.main(["--model_name", _config_only(tmp_path, model_type),
                  "--trans_path", "t.csv", "--save_dir", str(tmp_path),
                  "--device", "cpu"])


def _finetuned(src, dst, seed: int, load_hf_state_dict, layers: str):
    """A fine-tuned stand-in of the checkpoint ``src``: its config and its
    weights moved by seeded noise, written as ``main_release --savemodel``
    writes a backbone; and one with the last layer dropped."""
    from mertools_tpu_torch.core.checkpoint import (read_hf_config, read_hf_weights,
                                                    write_hf_checkpoint)

    g = torch.Generator().manual_seed(seed)
    sd = load_hf_state_dict(read_hf_weights(str(src)))
    moved = {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in sd.items()}
    cfg = read_hf_config(str(src))
    last = max(int(k.split(layers)[1].split(".")[0]) for k in sd if layers in k)
    shallow = {k: v for k, v in sd.items() if f"{layers}{last}." not in k}
    return (write_hf_checkpoint(str(dst / "fold0_backbone"), cfg, moved),
            write_hf_checkpoint(str(dst / "shallow"), cfg, shallow))


def test_extract_text_finetuned_ckpt_exits_naming_a17(bert_dir, tmp_path):
    """(Once an exit naming A17.) ``--finetuned_ckpt`` replaces the BERT
    weights: the files equal the CLI's on a copy of the checkpoint holding
    the fine-tuned weights; a checkpoint one layer short is refused with
    the JAX CLI's architecture message."""
    import shutil

    from mertools_tpu_torch.encoders.bert import load_hf_state_dict

    _transcripts(tmp_path / "trans.csv")
    ft, shallow = _finetuned(bert_dir, tmp_path, 3, load_hf_state_dict, "encoder.layer.")
    merged = tmp_path / "pre" / bert_dir.name
    shutil.copytree(bert_dir, merged)
    for f in merged.glob("*.safetensors"):
        f.unlink()
    shutil.copy(os.path.join(ft, "pytorch_model.bin"), merged / "pytorch_model.bin")
    flags = ["--model_name", bert_dir.name, "--trans_path", str(tmp_path / "trans.csv"),
             "--device", "cpu"]
    tet.main(flags + ["--pretrain_dir", str(bert_dir.parent), "--finetuned_ckpt", ft,
                      "--save_dir", str(tmp_path / "ft")])
    tet.main(flags + ["--pretrain_dir", str(merged.parent), "--save_dir",
                      str(tmp_path / "merged")])
    sub = f"{bert_dir.name}-UTT"
    out, ref = _read(tmp_path / "ft" / sub), _read(tmp_path / "merged" / sub)
    assert sorted(out) == sorted(ref)
    for n in ref:
        np.testing.assert_array_equal(out[n], ref[n])
    with pytest.raises(ValueError, match="checkpoint tree does not match the selected "
                                         "model architecture"):
        tet.main(flags + ["--pretrain_dir", str(bert_dir.parent), "--finetuned_ckpt",
                          shallow, "--save_dir", str(tmp_path / "bad")])


@pytest.mark.parametrize("extra", [["--compute_dtype", "int8"], ["--finetuned_ckpt"]],
                         ids=["int8", "finetuned"])
def test_extract_vision_int8_and_finetuned_ckpt(clip_dir, tmp_path, extra):
    """``--compute_dtype int8`` against the JAX CLI's int8 mode (UTT within
    2e-2 of max|jax|: two bf16 computations that round apart); and
    ``--finetuned_ckpt`` against the library on the fine-tuned weights,
    with a checkpoint one layer short refused."""
    from mertools_tpu_torch.core.checkpoint import read_hf_config, read_hf_weights
    from mertools_tpu_torch.encoders.vit_clip import CLIPVisionConfig, load_hf_state_dict
    from mertools_tpu_torch.features.vision import VisionExtractor

    faces = tmp_path / "faces"
    faces.mkdir()
    rng = np.random.default_rng(2)
    clips = {f"clip{i}": rng.integers(0, 256, size=(t, 112, 112, 3)).astype(np.uint8)
             for i, t in enumerate((3, 7))}
    for n, c in clips.items():
        np.save(faces / f"{n}.npy", c)
    flags = ["--model_name", clip_dir.name, "--pretrain_dir", str(clip_dir.parent),
             "--face_dir", str(faces)]
    sub = f"{clip_dir.name}-UTT"
    if extra[0] == "--compute_dtype":
        from mertools_tpu.cli import extract_vision as jev

        jev.main(flags + extra + ["--save_dir", str(tmp_path / "jax")])
        tev.main(flags + extra + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
        out, ref = _read(tmp_path / "port" / sub), _read(tmp_path / "jax" / sub)
        assert sorted(out) == sorted(ref)
        for n in ref:
            assert np.abs(out[n] - ref[n]).max() <= 2e-2 * np.abs(ref[n]).max()
        return
    ft, shallow = _finetuned(clip_dir, tmp_path, 4, load_hf_state_dict, "encoder.layers.")
    tev.main(flags + ["--finetuned_ckpt", ft, "--save_dir", str(tmp_path / "ft"),
                      "--device", "cpu"])
    cfg = CLIPVisionConfig.from_hf(read_hf_config(str(clip_dir)))
    want = VisionExtractor(cfg, load_hf_state_dict(read_hf_weights(ft)),
                           device="cpu").extract(clips, level="UTT")
    out = _read(tmp_path / "ft" / sub)
    for n in want:
        np.testing.assert_array_equal(out[n], want[n])
    with pytest.raises(ValueError, match="checkpoint tree does not match"):
        tev.main(flags + ["--finetuned_ckpt", shallow, "--save_dir", str(tmp_path / "x"),
                          "--device", "cpu"])


@pytest.mark.parametrize("name,extra,item", [
    ("videomae-base", [], "A9"), ("dinov2-large", [], "A9"),
    ("data2vec-vision-base", [], "A9"), ("eva-clip-g", [], "A9"),
    ("siglip-base", [], "A9"), ("emonet", [], "A9"), ("manet", [], "A9"),
    ("resnet50-ferplus", [], "A9"), ("senet50-msceleb", [], "A9")])
def test_extract_vision_exits_naming_the_roadmap_item(tmp_path, name, extra, item):
    with pytest.raises(SystemExit, match=item):
        tev.main(["--model_name", name, "--face_dir", str(tmp_path),
                  "--save_dir", str(tmp_path), "--device", "cpu", *extra])
