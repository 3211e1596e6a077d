"""The port's KV-cached greedy decoder, ``WhisperASR`` and ``main_asr`` CLI
against the JAX package's, on one tiny full-length Whisper (3000 mel frames,
1500 positions) whose Flax params are carried across by
``state_dict_from_flax``. JAX's ``greedy_decode`` is compiled once, for the
shapes ``WhisperASR.transcribe_batch`` gives it; the port's own oracle is its
full-sequence forward, re-run per step (cheap in PyTorch)."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.asr.decode import greedy_decode as jax_greedy
from mertools_tpu.asr.pipeline import WhisperASR as JaxASR
from mertools_tpu.encoders import whisper as jw
from mertools_tpu_torch.asr.decode import greedy_decode
from mertools_tpu_torch.asr.pipeline import WhisperASR
from mertools_tpu_torch.cli.main_asr import main as asr_main
from mertools_tpu_torch.encoders import whisper as tw
from mertools_tpu_torch.ops.mel import log_mel_spectrogram

torch.set_num_threads(1)

PROMPT = (70, 5, 6, 7)
MAX_NEW = 10


@pytest.fixture(scope="module")
def case():
    cfg = jw.WhisperConfig(d_model=32, encoder_layers=2, decoder_layers=2,
                           num_heads=4, ffn_dim=64, vocab_size=73,
                           max_target_positions=32, decoder_start_token_id=70,
                           eos_token_id=71)
    params = jax.jit(jw.WhisperModel(cfg).init)(
        jax.random.PRNGKey(3), np.zeros((1, 80, 3000), np.float32),
        np.zeros((1, 4), np.int32))["params"]
    tcfg = tw.WhisperConfig(**cfg.__dict__)
    sd = tw.state_dict_from_flax(tcfg, params)
    rng = np.random.default_rng(0)
    t = np.arange(48000) / 16000.0
    wavs = [(0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32),
            (rng.normal(size=480000) * 0.1).astype(np.float32)]
    jasr = JaxASR(cfg, params, batch_size=2, max_new_tokens=MAX_NEW,
                  prompt=PROMPT)
    return dict(cfg=cfg, params=params, tcfg=tcfg, sd=sd, wavs=wavs, jasr=jasr,
                port=tw.build_model(tcfg, sd, "cpu"))


def _encode(case):
    batch = np.stack([np.pad(w, (0, 480000 - len(w))) for w in case["wavs"]])
    with torch.no_grad():
        return case["port"].encode(log_mel_spectrogram(torch.from_numpy(batch)))


def test_transcribe_batch_matches_jax(case):
    ref = case["jasr"].transcribe_batch(case["wavs"])
    asr = WhisperASR(case["tcfg"], case["sd"], batch_size=2,
                     max_new_tokens=MAX_NEW, prompt=PROMPT, device="cpu")
    assert asr.transcribe_batch(case["wavs"]) == ref
    # three clips: a second batch with one zero filler row
    assert asr.transcribe_batch(case["wavs"] + case["wavs"][:1]) == ref + ref[:1]


def test_greedy_decode_matches_jax(case):
    """Same tokens, EOS padding included. The JAX step decoder normalises
    with eps 1e-6 where the modules (and the port) use 1e-5; at this seed the
    top-2 logit margins are far wider than that difference moves them."""
    enc = _encode(case)
    prompt = np.tile(np.asarray(PROMPT, np.int32), (2, 1))
    ref = np.asarray(jax_greedy(case["cfg"], case["params"],
                                jnp.asarray(enc.numpy()), jnp.asarray(prompt),
                                len(PROMPT), MAX_NEW))
    got = greedy_decode(case["tcfg"], case["port"], enc, torch.from_numpy(prompt),
                        len(PROMPT), MAX_NEW)
    assert got.dtype == torch.int32 and got.shape == (2, len(PROMPT) + MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_greedy_decode_matches_full_forward_oracle(case):
    """The cached step decoder gives the tokens that re-running the full
    decoder and taking the argmax of its last position gives."""
    enc = _encode(case)
    eos = case["tcfg"].eos_token_id
    emb = case["port"].decoder.embed_tokens.weight
    prompt = torch.tensor([PROMPT] * 2, dtype=torch.int32)
    got = greedy_decode(case["tcfg"], case["sd"], enc, prompt, len(PROMPT),
                        MAX_NEW)  # from a state dict this time
    for b in range(2):
        toks = list(PROMPT)
        with torch.no_grad():
            for _ in range(MAX_NEW):
                h = case["port"].decode(torch.tensor([toks]), enc[b: b + 1])
                toks.append(int((h[0, -1] @ emb.T).argmax()))
                if toks[-1] == eos:
                    break
        toks += [eos] * (len(PROMPT) + MAX_NEW - len(toks))
        assert got[b].tolist() == toks


def test_batch_decode_matches_single(case):
    enc = _encode(case)
    prompt = torch.tensor([[70, 3, 4]] * 2, dtype=torch.int32)
    both = greedy_decode(case["tcfg"], case["port"], enc, prompt, 3, 8)
    for b in range(2):
        solo = greedy_decode(case["tcfg"], case["port"], enc[b: b + 1],
                             prompt[b: b + 1], 3, 8)
        assert torch.equal(both[b], solo[0])


def test_suppress_mask(case):
    enc = _encode(case)[:1]
    prompt = torch.tensor([[70]], dtype=torch.int32)
    free = greedy_decode(case["tcfg"], case["port"], enc, prompt, 1, 6)
    banned = int(free[0, 1])
    assert banned != case["tcfg"].eos_token_id  # at this seed: something to ban
    mask = torch.zeros(case["tcfg"].vocab_size, dtype=torch.bool)
    mask[banned] = True
    sup = greedy_decode(case["tcfg"], case["port"], enc, prompt, 1, 6,
                        suppress_mask=mask)
    assert banned not in sup[0, 1:].tolist()


class _Tokenizer:
    """Stand-in for transformers' WhisperTokenizer: ids -> letters."""

    def convert_tokens_to_ids(self, tokens):
        return [70, 5, 6, 7][: len(tokens)]

    def decode(self, ids, skip_special_tokens=True):
        return " " + "".join(chr(ord("a") + i % 26) for i in ids) + " "


def test_transcribe_with_tokenizer(case):
    asr = WhisperASR(case["tcfg"], case["sd"], tokenizer=_Tokenizer(),
                     batch_size=2, max_new_tokens=MAX_NEW, device="cpu")
    assert asr.prompt == PROMPT
    ids = asr.transcribe_batch(case["wavs"])
    assert asr.transcribe(case["wavs"]) == [
        "".join(chr(ord("a") + i % 26) for i in t) for t in ids]
    with pytest.raises(ValueError, match="tokenizer"):
        WhisperASR(case["tcfg"], case["sd"], batch_size=2, max_new_tokens=2,
                   prompt=PROMPT, device="cpu").transcribe(case["wavs"])


def test_asr_cli_merge_and_punctuate(tmp_path):
    """tests/test_asr_decode.py's CLI case, on the port."""
    new = tmp_path / "new.csv"
    new.write_text("name,sentence\na,hello there\nb,你好\nc,\n", encoding="utf-8")
    chk = tmp_path / "check.csv"
    chk.write_text("name,chinese\nb,你好吗\n", encoding="utf-8")
    out = tmp_path / "merged.csv"
    asr_main(["merge", f"--new_path={new}", f"--check_path={chk}",
              f"--merge_path={out}"])
    with open(out, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert [(r["name"], r["chinese"]) for r in rows] == [
        ("a", "hello there"), ("b", "你好吗"), ("c", "")]

    ref = tmp_path / "refined.csv"
    asr_main(["punctuate", f"--old_path={new}", f"--new_path={ref}"])
    with open(ref, newline="", encoding="utf-8") as f:
        rows = {r["name"]: r["sentence"] for r in csv.DictReader(f)}
    assert rows == {"a": "hello there。", "b": "你好。", "c": ""}

    # --model runs the LLM pass now (no ROADMAP exit): a directory without
    # a checkpoint is refused by the loader
    with pytest.raises(SystemExit, match="config.json"):
        asr_main(["punctuate", f"--old_path={new}", f"--new_path={ref}",
                  f"--model={tmp_path}", "--device", "cpu"])
