"""The port's Runner (mertools_tpu_torch/mllm/runner.py) against the JAX
Runner in fp32 on the same weights and batches: the warmup-cosine schedule
against optax's, three AdamW steps, two updates accumulated over four
micro-steps against ``optax.MultiSteps``, and weight decay on every
trainable leaf (optax's default mask); plus the trainable-only checkpoint
round trip."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import affectgpt as ja
from mertools_tpu.mllm import runner as jr
from mertools_tpu.mllm.llm import LLMConfig
from mertools_tpu_torch.mllm import affectgpt as ta
from mertools_tpu_torch.mllm import runner as tr

torch.set_num_threads(1)

CFG = ja.AffectGPTConfig(
    llm=LLMConfig(vocab_size=48, hidden_size=32, num_layers=1, num_heads=4,
                  num_kv_heads=2, intermediate_size=48, lora_r=2),
    video_dim=12, audio_dim=10, fusion="mean", num_video_query_token=2,
    num_audio_query_token=2)


def _batches(n, seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 48, size=(B, S))
        labels[:, :6] = -100
        out.append({"video_feats": rng.normal(size=(B, 5, 12)).astype(np.float32),
                    "audio_feats": rng.normal(size=(B, 4, 10)).astype(np.float32),
                    "input_ids": rng.integers(1, 48, size=(B, S)).astype(np.int32),
                    "splice_start": np.full(B, 1, np.int32),
                    "attention_mask": np.ones((B, S), np.int32),
                    "labels": labels})
    return out


def _setup(tmp_path, accum):
    batches = _batches(4)
    model = ja.AffectGPT(CFG)
    # a host copy: the JAX train step donates (deletes) the state it is given
    params = jax.tree_util.tree_map(
        np.array, jax.jit(model.init)(jax.random.PRNGKey(0), batches[0])["params"])
    rcfg = dict(max_epoch=1, iters_per_epoch=4 if accum > 1 else 3, batch_size=2,
                accum_grad_iters=accum, init_lr=1e-2, min_lr=1e-3,
                warmup_steps=2, weight_decay=0.05)
    jrun = jr.Runner(jr.RunnerConfig(output_dir=str(tmp_path / "jax"), **rcfg),
                     model, params)
    tcfg = ta.config_from_dict(dataclasses.asdict(CFG))
    port = ta.AffectGPT(tcfg)
    port.load_state_dict(ta.state_dict_from_flax(tcfg, params), strict=True)
    trun = tr.Runner(tr.RunnerConfig(output_dir=str(tmp_path / "port"), **rcfg),
                     port)
    return batches, jrun, trun, tcfg, params


def _compare(jrun, trun, tcfg, params):
    want = ta.state_dict_from_flax(tcfg, jrun.state.params)
    before = ta.state_dict_from_flax(tcfg, params)
    moved = 0
    for n, p in trun.model.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        if not p.requires_grad:   # frozen: untouched on both sides
            np.testing.assert_array_equal(got, before[n].numpy())
            np.testing.assert_array_equal(w, before[n].numpy())
            continue
        # the updates are lr-sized; fp32 rounding of the gradients moves
        # Adam's m / sqrt(v) by far less than that
        assert np.abs(got - w).max() <= 1e-5, n
        moved += int(np.abs(w - before[n].numpy()).max() > 0)
    assert moved > 5


def test_schedule_matches_optax():
    for args in ((1e-4, 8e-5, 100, 1000), (1e-2, 1e-3, 2, 3), (5e-3, 0.0, 0, 50)):
        want = jr.warmup_cosine_schedule(*args)
        got = tr.warmup_cosine_schedule(*args)
        for step in (0, 1, 2, 3, 50, 99, 100, 101, 500, 999, 1000, 2000):
            assert abs(got(step) - float(want(step))) <= 1e-6 * args[0], (args, step)


def test_three_steps_match_the_jax_runner(tmp_path):
    batches, jrun, trun, tcfg, params = _setup(tmp_path, accum=1)
    js = jrun.train_epoch(0, iter(batches[:3]))
    ts = trun.train_epoch(0, iter(batches[:3]))
    assert abs(ts["train_loss"] - js["train_loss"]) <= 1e-5 * abs(js["train_loss"])
    assert trun.updates == 3
    _compare(jrun, trun, tcfg, params)
    log = [json.loads(line) for line in
           (tmp_path / "port" / "log.txt").read_text().splitlines()]
    assert log == [ts]


def test_gradient_accumulation_matches_optax_multisteps(tmp_path):
    batches, jrun, trun, tcfg, params = _setup(tmp_path, accum=2)
    jrun.train_epoch(0, iter(batches))
    trun.train_epoch(0, iter(batches))
    assert trun.updates == 2
    _compare(jrun, trun, tcfg, params)


def test_weight_decay_reaches_every_trainable_leaf(tmp_path):
    """LoRA A has an exactly zero gradient while LoRA B is zero, so its first
    update is the decay alone: p * (1 - lr * wd), lr = init_lr without warmup."""
    batches, _, _, tcfg, _ = _setup(tmp_path, accum=1)
    trun = tr.Runner(tr.RunnerConfig(init_lr=1e-2, warmup_steps=0,
                                     weight_decay=0.05,
                                     output_dir=str(tmp_path / "wd")),
                     ta.build(tcfg, "cpu", seed=3))
    a = trun.model.llm.layers[0].self_attn.q_proj.lora_A
    before = a.detach().clone()
    trun.train_step(batches[0])
    assert trun.schedule(0) == 1e-2
    assert not torch.equal(a.detach(), before)
    assert torch.allclose(a.detach(), before * (1 - 1e-2 * 0.05), rtol=1e-6, atol=0)
    assert all(p.requires_grad for p in trun.opt.param_groups[0]["params"])


def test_checkpoint_round_trip_and_bf16_frozen_base(tmp_path):
    batches, _, trun, tcfg, _ = _setup(tmp_path, accum=1)
    trun.train_step(batches[0])
    path = trun.save_checkpoint(0)
    saved = trun.trainable_state()
    assert set(saved) == {n for n, p in trun.model.named_parameters()
                          if p.requires_grad}
    fresh = ta.build(tcfg, "cpu", seed=7)
    r2 = tr.Runner(tr.RunnerConfig(output_dir=str(tmp_path / "r2"),
                                   compute_dtype="bf16"), fresh)
    assert r2.load_checkpoint(path) == 0
    for n, p in fresh.named_parameters():
        if p.requires_grad:
            assert p.dtype == torch.float32 and torch.equal(p.detach(), saved[n])
        else:
            assert p.dtype == torch.bfloat16, n   # held in the compute dtype
    loss = r2.train_step(batches[1])
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError, match="A14"):
        tr.Runner(tr.RunnerConfig(), fresh, mesh=object())
