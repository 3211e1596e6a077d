"""The port's generation CLIs against the JAX CLIs on the same local HF
checkpoint (the JAX tests' tiny Qwen2 directory, read by the port's
``core/checkpoint`` loader): ``ovlabel_extraction`` (static and continuous
engines, w8, bf16), ``translate``, ``main_ov generate-synonyms``,
``main_asr punctuate --model`` and ``inference_mllm`` (feature stores, a
``save_model`` AffectGPT, resume, the ``--run_dir`` sweep) write the JAX
outputs at temperature 0; the raw-media mode exits naming A9d; each CLI
defaults to the card."""

import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from test_cli_ovlabel_translate import tiny_hf_llm  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _reasons(tmp_path, n=5):
    reasons = {f"c{i}": f"the person is {'happy' if i % 2 else 'sad'} and talks"
               for i in range(n)}
    npz = tmp_path / "name2reason.npz"
    np.savez_compressed(npz, name2reason=np.array(reasons, dtype=object))
    return npz


def _store(path):
    out = np.load(path, allow_pickle=True)
    return dict(zip([str(n) for n in out["filenames"]], [str(x) for x in out["fileitems"]]))


@pytest.mark.parametrize("extra", [[], ["--engine=continuous"], ["--w8"],
                                   ["--engine=continuous", "--w8"]])
def test_ovlabel_extraction_equals_jax(tiny_hf_llm, tmp_path, extra):  # noqa: F811
    from mertools_tpu.cli.ovlabel_extraction import main as jmain
    from mertools_tpu_torch.cli.ovlabel_extraction import main as tmain

    npz = _reasons(tmp_path)
    argv = [f"--reason_npz={npz}", f"--model={tiny_hf_llm}", "--batch=2",
            "--max_new_tokens=6", "--temperature=0.0", *extra]
    jmain(argv + [f"--store_npz={tmp_path / 'j.npz'}"])
    tmain(argv + [f"--store_npz={tmp_path / 't.npz'}", f"--store_root={tmp_path / 'root'}",
                  "--device", "cpu"])
    got = _store(tmp_path / "t.npz")
    assert got == _store(tmp_path / "j.npz") and len(got) == 5
    assert sorted(os.listdir(tmp_path / "root")) == [f"c{i}.npy" for i in range(5)]


def test_ovlabel_extraction_bf16_writes_every_clip(tiny_hf_llm, tmp_path):  # noqa: F811
    from mertools_tpu_torch.cli.ovlabel_extraction import main

    npz = _reasons(tmp_path, 3)
    for engine in ("static", "continuous"):
        main([f"--reason_npz={npz}", f"--model={tiny_hf_llm}", "--batch=2",
              "--max_new_tokens=4", "--bf16", f"--engine={engine}",
              f"--store_npz={tmp_path / engine}.npz", "--device", "cpu"])
        assert sorted(_store(f"{tmp_path / engine}.npz")) == ["c0", "c1", "c2"]


def test_translate_equals_jax(tiny_hf_llm, tmp_path):  # noqa: F811
    from mertools_tpu.cli.translate import main as jmain
    from mertools_tpu_torch.cli.translate import main as tmain

    src = tmp_path / "transcription.csv"
    with open(src, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name", "chinese"])
        w.writerows([["c0", "the happy person"], ["c1", ""], ["c2", "a sad state"]])
    argv = [f"--trans_path={src}", "--direction=chi2eng", f"--model={tiny_hf_llm}",
            "--batch=2", "--max_new_tokens=5"]
    jmain(argv + [f"--save_path={tmp_path / 'j.csv'}"])
    tmain(argv + [f"--save_path={tmp_path / 't.csv'}", "--device", "cpu"])
    read = lambda p: list(csv.DictReader(open(p, newline="", encoding="utf-8")))  # noqa: E731
    got = read(tmp_path / "t.csv")
    assert got == read(tmp_path / "j.csv")
    assert [r["name"] for r in got] == ["c0", "c1", "c2"] and got[1]["english"] == ""


def test_generate_synonyms_equals_jax(tiny_hf_llm, tmp_path):  # noqa: F811
    from mertools_tpu.cli.main_ov import main as jmain
    from mertools_tpu_torch.cli.main_ov import main as tmain

    gt = tmp_path / "gt.csv"
    gt.write_text('name,openset\nc0,"[\'happy\']"\nc1,"[\'sad\']"\n', encoding="utf-8")
    pred = tmp_path / "pred.csv"
    pred.write_text('name,openset\nc0,"[\'calm\']"\nc1,"[\'angry\']"\n', encoding="utf-8")
    argv = [f"--gt_csv={gt}", f"--pred_csv={pred}", f"--model={tiny_hf_llm}",
            "--batch=2", "--max_new_tokens=5"]
    jmain(["generate-synonyms", *argv, f"--synonym_root={tmp_path / 'j'}"])
    tmain(["generate-synonyms", *argv, f"--synonym_root={tmp_path / 't'}",
           "--device", "cpu"])
    for n in ("c0", "c1"):
        assert np.load(tmp_path / "t" / f"{n}.npy") == np.load(tmp_path / "j" / f"{n}.npy")
    mtime = os.path.getmtime(tmp_path / "t" / "c0.npy")
    tmain(["generate-synonyms", *argv, f"--synonym_root={tmp_path / 't'}", "--device", "cpu"])
    assert os.path.getmtime(tmp_path / "t" / "c0.npy") == mtime   # idempotent


def test_punctuate_with_a_model_equals_jax(tiny_hf_llm, tmp_path):  # noqa: F811
    from mertools_tpu.cli.main_asr import main as jmain
    from mertools_tpu_torch.cli.main_asr import main as tmain

    old = tmp_path / "old.csv"
    old.write_text("name,sentence\na,the happy person\nb,\nc,a sad state\n", encoding="utf-8")
    argv = [f"--old_path={old}", f"--model={tiny_hf_llm}", "--batch=2",
            "--max_new_tokens=6"]
    jmain(["punctuate", *argv, f"--new_path={tmp_path / 'j.csv'}"])
    tmain(["punctuate", *argv, f"--new_path={tmp_path / 't.csv'}", "--device", "cpu"])
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def _affectgpt(vocab, seed=0):
    from mertools_tpu.mllm import AffectGPT, AffectGPTConfig, LLMConfig, QFormerConfig

    qf = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
    cfg = AffectGPTConfig(
        llm=LLMConfig(vocab_size=vocab, hidden_size=32, num_layers=1, num_heads=4,
                      num_kv_heads=2, intermediate_size=64, lora_r=2),
        video_qformer=QFormerConfig(num_queries=4, **qf),
        audio_qformer=QFormerConfig(num_queries=2, **qf),
        video_dim=12, audio_dim=10, max_video_frames=8, max_audio_frames=8)
    rng = np.random.default_rng(seed)
    batch = {"video_feats": np.zeros((1, 4, 12), np.float32),
             "audio_feats": np.zeros((1, 3, 10), np.float32),
             "input_ids": np.zeros((1, 16), np.int32),
             "splice_start": np.array([2], np.int32),
             "attention_mask": np.ones((1, 16), np.int32),
             "labels": np.full((1, 16), 7, np.int64)}
    model = AffectGPT(cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (np.float32(rng.normal(size=leaf.shape) * 0.1)
                         if getattr(p[-1], "key", None) == "lora_b" else leaf),
        jax.jit(model.init)(jax.random.PRNGKey(seed), batch)["params"])
    return cfg, model, params


def test_inference_mllm_equals_jax_chat(tiny_hf_llm, tmp_path):  # noqa: F811
    """name2reason of the port's CLI on a save_model directory equals the
    JAX Chat's answers on the same weights, clips and prompts; a rerun
    resumes; --run_dir writes one npz an epoch from the overlays."""
    from transformers import AutoTokenizer

    from mertools_tpu.mllm.chat import Chat as JChat
    from mertools_tpu_torch.cli.inference_mllm import load_feat, main
    from mertools_tpu_torch.mllm import affectgpt as ta
    from mertools_tpu_torch.mllm import runner as tr

    tok = AutoTokenizer.from_pretrained(tiny_hf_llm)
    cfg, jmodel, params = _affectgpt(len(tok))
    tcfg = ta.config_from_dict(dataclasses.asdict(cfg))
    port = ta.AffectGPT(tcfg)
    port.load_state_dict(ta.state_dict_from_flax(tcfg, params))
    ckpt = tr.save_model(str(tmp_path / "model"), port)

    rng = np.random.default_rng(1)
    vdir, adir = tmp_path / "v", tmp_path / "a"
    vdir.mkdir()
    adir.mkdir()
    names = [f"c{i}" for i in range(5)]
    for i, n in enumerate(names):
        np.save(vdir / f"{n}.npy", rng.normal(size=(3 + i, 12)).astype(np.float32))
        np.save(adir / f"{n}.npy", rng.normal(size=(12 - i, 10)).astype(np.float32))
    (tmp_path / "sub.csv").write_text(
        "name,sentence\n" + "\n".join(f"{n},hello there {n}" for n in names) + "\n")
    save = tmp_path / "name2reason.npz"
    argv = [f"--ckpt={ckpt}", f"--tokenizer={tiny_hf_llm}", f"--video_feat_dir={vdir}",
            f"--audio_feat_dir={adir}", f"--subtitle_csv={tmp_path / 'sub.csv'}",
            "--batch=2", "--max_new_tokens=5", "--question=What emotion?",
            "--max_audio_frames=8", "--max_video_frames=8", "--device", "cpu"]
    main(argv + [f"--save_path={save}"])
    got = np.load(save, allow_pickle=True)["name2reason"].item()

    chat = JChat(jmodel, params, tok, max_new_tokens=5)
    want = {}
    for i in range(0, 5, 2):
        group = names[i: i + 2]
        samples = [{"video_feats": load_feat(str(vdir), n, 8),
                    "audio_feats": load_feat(str(adir), n, 8),
                    "subtitle": f"hello there {n}", "question": "What emotion?"}
                   for n in group]
        want.update(zip(group, chat.answer_batch(samples)))
    assert got == want

    mtime = os.path.getmtime(save)
    main(argv + [f"--save_path={save}"])          # nothing left to do
    assert os.path.getmtime(save) == mtime

    run = tmp_path / "run"
    for epoch in (1, 2):
        d = run / f"checkpoint_{epoch}"
        d.mkdir(parents=True)
        torch.save({"params": {"video_proj.bias": torch.full((32,), 0.1 * epoch)},
                    "epoch": epoch}, d / "trainable.pt")
    main(argv + [f"--save_path={tmp_path / 'sweep.npz'}", f"--run_dir={run}",
                 "--test_epochs=1-2"])
    for epoch in (1, 2):
        out = np.load(tmp_path / f"sweep_epoch{epoch}.npz", allow_pickle=True)
        assert sorted(out["name2reason"].item()) == names


@pytest.mark.parametrize("argv,match", [
    (["--face_dir=f", "--audio_dir=a"], "A9d"),
    (["--video_feat_dir=v"], "--audio_feat_dir"),
])
def test_inference_mllm_unported_modes_exit(argv, match):
    from mertools_tpu_torch.cli.inference_mllm import main

    with pytest.raises(SystemExit, match=match):
        main(["--ckpt=x", "--tokenizer=x", "--save_path=x.npz", *argv])


def test_generation_clis_default_to_the_card(tiny_hf_llm, tmp_path, monkeypatch):  # noqa: F811
    from mertools_tpu_torch.cli import main_asr, ovlabel_extraction, translate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npz = _reasons(tmp_path, 2)
    (tmp_path / "t.csv").write_text("name,chinese,sentence\nc0,hi,hi\n", encoding="utf-8")
    for run in (lambda: ovlabel_extraction.main([f"--reason_npz={npz}", f"--model={tiny_hf_llm}"]),
                lambda: translate.main([f"--trans_path={tmp_path / 't.csv'}",
                                        f"--save_path={tmp_path / 'o.csv'}",
                                        f"--model={tiny_hf_llm}"]),
                lambda: main_asr.main(["punctuate", f"--old_path={tmp_path / 't.csv'}",
                                       f"--new_path={tmp_path / 'o.csv'}",
                                       f"--model={tiny_hf_llm}"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
