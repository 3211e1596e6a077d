"""The port's e2e fine-tuning model, dataset and trainer path against the
JAX package's on the CPU (``mertools_tpu/models/e2e_model.py``,
``data/e2e_dataset.py``, ``train/loop.py``), at the JAX package's tiny
backbone configs: the same Flax params carried across by
``E2EModel.state_dict_from_flax`` and the same numpy inputs; eval outputs
within 1e-5 and each gradient within 1e-4 of max|jax| (a tensor's max counts
as at least 1e-3 of the largest) for audio, text and video_clip; the
``videos_u8`` path against precomputed frames; ``e2e_param_labels``;
``E2EDataset``'s three constructors bit-equal (the float video layout
within 1e-6); ``run_cv`` from JAX's initial weights (cv and test logits
within 1e-4, the same best epochs); the ``--savemodel`` tie rule; one
learning rate; no dropout in the backbone. Each JAX function is compiled
once for the module."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.core.config import Args as JArgs
from mertools_tpu.data import e2e_dataset as jds
from mertools_tpu.models import e2e_model as jm
from mertools_tpu.models import get_model as j_get_model
from mertools_tpu.ops import losses as j_losses
from mertools_tpu.train import loop as j_loop
from mertools_tpu_torch.core.config import Args
from mertools_tpu_torch.data import e2e_dataset as tds
from mertools_tpu_torch.io import wav as wav_io
from mertools_tpu_torch.models import e2e_model as tm
from mertools_tpu_torch.train import loop

torch.set_num_threads(1)

FWD_TOL = 1e-5    # eval outputs, max |port - jax| / max |jax|
GRAD_TOL = 1e-4   # each gradient, max |port - jax| / max(|jax|), floor below
GRAD_FLOOR = 1e-3  # a tensor's max |jax| counts as at least this of the largest
RUN_TOL = 1e-4    # run_cv: eval and test logits after training

KW = dict(hidden_dim=8, dropout=0.0, output_dim1=6, output_dim2=1)
_JAX = {}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _batch(modality: str, rng):
    if modality == "audio":
        return {"audios": rng.normal(size=(2, 3, 800)).astype(np.float32)}
    if modality == "text":
        mask = np.ones((3, 12), np.int32)
        mask[0, 8:] = 0
        mask[2] = 0          # no token: the pooled mean's count clamps at 1
        return {"input_ids": rng.integers(0, 64, (3, 12)).astype(np.int32),
                "attention_mask": mask}
    return {"videos_u8": rng.integers(0, 256, (2, 3, 48, 40, 3)).astype(np.uint8)}


def _models(name: str):
    """(JAX model, its params, the port's model with them, the batch), once
    a name for the module; the Flax tree from ``jax.eval_shape`` filled with
    seeded normals (an eager Flax init of the wav2vec2 backbone takes ~12
    s)."""
    if name not in _JAX:
        rng = np.random.default_rng(len(_JAX))
        jmodel, _ = jm.build_e2e_model(JArgs(e2e_name=name, **KW))
        batch = _batch(jmodel.cfg.modality, rng)
        n = len(next(iter(batch.values())))
        batch.update(emos=np.array([1, 4, 2][:n], np.int32),
                     vals=np.array([0.5, -1.0, 0.25][:n], np.float32))
        shapes = jax.eval_shape(lambda k: jmodel.init({"params": k}, batch)["params"],
                                jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(
            lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32), shapes)
        tmodel, backbone_sd = tm.build_e2e_model(Args(e2e_name=name, **KW))
        assert backbone_sd is None
        tmodel.load_state_dict(tmodel.state_dict_from_flax(params), strict=True)
        _JAX[name] = (jmodel, params, tmodel, batch)
    return _JAX[name]


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["tiny-audio", "tiny-text", "tiny-video"])
def test_e2e_model_matches_jax(name):
    """Eval outputs, then the gradients of CE + MSE in training mode (at
    dropout 0 the JAX training forward is its eval forward, so one compiled
    function gives both)."""
    jmodel, params, tmodel, batch = _models(name)
    mask = np.ones(len(batch["emos"]), np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, batch, train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        _, e, v, inter = out
        return (inter + j_losses.cross_entropy(e, batch["emos"], mask)
                + j_losses.mse(v, batch["vals"], mask)), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    with torch.no_grad():
        got = tmodel.eval()(_torch(batch))
    for g, r in zip(got[:3], ref[:3]):
        assert tuple(g.shape) == r.shape and _rel(g.numpy(), r) <= FWD_TOL
    assert float(got[3]) == float(ref[3]) == 0.0

    want = tmodel.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, _, _ = loop.compute_loss(tmodel.train(), _torch(batch), torch.from_numpy(mask),
                                   None, True, True)
    loss.backward()
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    tmodel.zero_grad(set_to_none=True)
    assert sorted(got) == sorted(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        err = float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                    GRAD_FLOOR * largest)
        assert err <= GRAD_TOL, (n, err)


def test_backbone_has_no_dropout_in_training():
    """Two training-mode forwards with the head's dropout at 0 agree: only
    the head's MLPEncoder may drop out (the JAX model calls the backbone
    without ``train``)."""
    for name in ("tiny-audio", "tiny-text", "tiny-video"):
        _, _, tmodel, batch = _models(name)
        with torch.no_grad():
            a = tmodel.train()(_torch(batch), torch.Generator().manual_seed(0))
            b = tmodel.train()(_torch(batch), torch.Generator().manual_seed(1))
        for x, y in zip(a, b):
            assert torch.equal(x, y), name


def test_param_labels_match_jax():
    _, params, tmodel, _ = _models("tiny-text")
    flat = jax.tree_util.tree_leaves_with_path(jm.e2e_param_labels(params))
    jlab = {}
    for path, label in flat:
        jlab.setdefault(label, set()).add(path[0].key)
    labels = tm.e2e_param_labels(tmodel.state_dict())
    got = {}
    for n, label in labels.items():
        got.setdefault(label, set()).add(n.split(".")[0])
    assert got == jlab == {"head": {"encoder", "heads"}, "backbone": {"backbone"}}


def test_modality_and_tiny_configs_match_jax():
    import dataclasses

    for name in ("tiny-audio", "tiny-text", "tiny-video", "chinese-hubert-large",
                 "chinese-macbert-large", "clip-vit-large-patch14"):
        assert tm.e2e_modality(name) == jm.e2e_modality(name)
    with pytest.raises(ValueError, match="unknown e2e_name"):
        tm.e2e_modality("nope")
    for name in ("tiny-audio", "tiny-text", "tiny-video"):
        jmodel, _, tmodel, _ = _models(name)
        jb = jmodel.backbone.inner.cfg if name == "tiny-video" else jmodel.backbone.cfg
        tb = dataclasses.asdict(tmodel.backbone.cfg)
        assert {k: tb[k] for k in dataclasses.asdict(jb)} == dataclasses.asdict(jb)
        assert dataclasses.asdict(tmodel.cfg) == dataclasses.asdict(jmodel.cfg)
        # the saved config.json reads back as the same backbone config
        cls = type(tmodel.backbone.cfg)
        raw = tmodel.backbone.cfg.to_config_json()
        back = (cls.from_config_json(raw) if name == "tiny-audio" else cls.from_hf(raw))
        assert back == tmodel.backbone.cfg


def test_videos_u8_equals_precomputed_frames(tmp_path):
    """The compact uint8 layout, resized and normalised in the forward,
    against the precomputed float frames of ``compact=False``."""
    rng = np.random.default_rng(3)
    for n in ("a", "b"):
        np.save(tmp_path / f"{n}.npy", rng.integers(0, 256, (5, 48, 48, 3)).astype(np.uint8))
    _, _, tmodel, _ = _models("tiny-video")
    args = ([["a", "b"], [0, 1], [0.1, -0.2], str(tmp_path)],
            dict(n_frms=4, image_size=32))
    u8 = tds.E2EDataset.build_video(*args[0], **args[1]).arrays()
    fl = tds.E2EDataset.build_video(*args[0], **args[1], compact=False).arrays()
    with torch.no_grad():
        a = tmodel.eval()({"videos_u8": torch.from_numpy(u8["videos_u8"])})
        b = tmodel.eval()({"videos": torch.from_numpy(fl["videos"])})
    for x, y in zip(a[:3], b[:3]):
        assert _rel(x.numpy(), y.numpy()) <= FWD_TOL


def test_dataset_constructors_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    names, emos, vals = ["a", "b", "c"], [0, 3, 5], [0.5, -0.25, 1.0]
    for n, L in zip(names, (1500, 5000, 333)):      # one shorter than a window
        wav_io.write_wav(str(tmp_path / f"{n}.wav"), 0.3 * rng.normal(size=L))
        np.save(tmp_path / f"{n}.npy", rng.integers(0, 256, (7, 40, 36, 3)).astype(np.uint8))
    with open(tmp_path / "t.csv", "w", encoding="utf-8") as f:
        f.write("name,chinese\na,你好世界\nb,\n")       # b empty, c absent

    class Tok:
        pad_token_id = 3

        def encode(self, text, add_special_tokens=True):
            return [5 + ord(ch) % 50 for ch in text]

    built = [
        (lambda m: m.E2EDataset.build_audio(names, emos, vals, str(tmp_path), 3, 1000)),
        (lambda m: m.E2EDataset.build_text(names, emos, vals, str(tmp_path / "t.csv"),
                                           Tok(), max_length=6)),
        (lambda m: m.E2EDataset.build_video(names, emos, vals, str(tmp_path), 4)),
    ]
    for build in built:
        got, ref = build(tds), build(jds)
        assert got.modality == ref.modality and got.names == ref.names
        g, r = got.arrays(), ref.arrays()
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), k
    got = tds.E2EDataset.build_video(names, emos, vals, str(tmp_path), 4, 24, compact=False)
    ref = jds.E2EDataset.build_video(names, emos, vals, str(tmp_path), 4, 24, compact=False)
    assert got.data["videos"].dtype == np.float32
    assert np.abs(got.data["videos"] - ref.data["videos"]).max() <= 1e-6 * np.abs(
        ref.data["videos"]).max() * 10
    for w in (np.zeros(10, np.float32), np.arange(70000, dtype=np.float32)):
        assert np.array_equal(tds.audio_segments(w), jds.audio_segments(w))


def _tone_set(mod, n: int, seed: int, tmp_path):
    """The tone corpus of tests/test_e2e_model.py (200 / 500 Hz classes),
    with seeded valence, as one module's E2EDataset (2 x 2000 samples)."""
    d = tmp_path / f"tones{seed}"
    if not d.exists():
        d.mkdir()
        t = np.arange(8000) / 16000.0
        for i in range(n):
            wav_io.write_wav(str(d / f"c{i:02d}.wav"),
                             0.4 * np.sin(2 * np.pi * (200.0, 500.0)[i % 2] * t + i))
    vals = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return mod.E2EDataset.build_audio([f"c{i:02d}" for i in range(n)], np.arange(n) % 2,
                                      vals, str(d), 2, 2000)


def test_run_cv_matches_the_jax_trainer(monkeypatch, tmp_path):
    """tiny-audio e2e, 2 folds x 2 epochs at dropout 0, each fold started
    from JAX's initial weights: the same best epochs; eval and test logits
    and valence within RUN_TOL of max|ref|."""
    kw = dict(model="e2e_model", e2e_name="tiny-audio", hidden_dim=8, dropout=0.0,
              lr=1e-2, l2=1e-5, grad_clip=-1.0, batch_size=8, epochs=2, num_folder=2,
              output_dim1=6, output_dim2=1, metric_name="emoval")
    # the test set as large as the train set and one batch a plan: one JAX
    # compile of the eval epoch serves the folds' eval and the test set
    train, test = (_tone_set(tds, 8, 1, tmp_path), _tone_set(tds, 8, 2, tmp_path))
    j_train, j_test = (_tone_set(jds, 8, 1, tmp_path), _tone_set(jds, 8, 2, tmp_path))
    seed, folds = 3, []
    # JAX's create_state initialises eagerly (~12 s a fold for this
    # backbone); the same init, compiled once, serves both trainers
    jinit = jax.jit(lambda key, b: j_get_model(JArgs(kw)).init(
        {"params": key}, b, train=False)["params"])

    def create_state(model, sample_batch, rng, lr, l2=1e-5, grad_clip=-1.0):
        return j_loop.TrainState.create(apply_fn=model.apply, params=jinit(rng, sample_batch),
                                        tx=j_loop.make_optimizer(lr, l2, grad_clip))

    def init_from_jax(args, sample_batch, generator):
        _, key = jax.random.split(jax.random.PRNGKey(seed * 1000 + len(folds)))
        params = jinit(key, sample_batch)
        folds.append(len(folds))
        model, _ = tm.build_e2e_model(args)
        model.load_state_dict(model.state_dict_from_flax(params), strict=True)
        return model

    monkeypatch.setattr(j_loop, "create_state", create_state)
    monkeypatch.setattr(loop, "init_model", init_from_jax)
    ref = j_loop.run_cv(JArgs(kw), j_train, {"test1": j_test}, seed=seed, verbose=False)
    got = loop.run_cv(Args(kw), train, {"test1": test}, seed=seed, verbose=False,
                      device="cpu")
    assert folds == [0, 1]
    assert got.best_epochs == ref.best_epochs
    for fg, fr in zip(got.folds, ref.folds, strict=True):
        for split in ("eval", "test1"):
            for key in ("emoprobs", "valpreds"):
                assert _rel(fg[f"{split}_{key}"], fr[f"{split}_{key}"]) <= RUN_TOL
    assert _rel(got.test_results["test1"]["emoprobs"],
                ref.test_results["test1"]["emoprobs"]) <= RUN_TOL


def test_savemodel_keeps_the_last_tied_epoch(monkeypatch, tmp_path):
    """Every epoch's eval metric ties (a constant metric): ``run_cv``
    reports the first epoch as best (argmax) but saves the backbone of the
    last one, JAX's ``epoch_metrics[-1] >= max(epoch_metrics)``
    (``train/loop.py:221-222``), under ``{save_root}/model``."""
    after = []
    run_epoch = loop.run_epoch

    def probe(model, *args, **kw):
        out = run_epoch(model, *args, **kw)
        after.append({k: v.clone() for k, v in model.backbone.state_dict().items()})
        return out

    def flat(emo_probs=None, emo_labels=None, val_preds=None, val_labels=None):
        return {"emofscore": 0.5, "emoacc": 0.5, "valmse": 1.0, "emoprobs": emo_probs,
                "emolabels": emo_labels, "valpreds": val_preds, "vallabels": val_labels}

    monkeypatch.setattr(loop, "run_epoch", probe)
    args = Args(model="e2e_model", e2e_name="tiny-audio", hidden_dim=8, dropout=0.0,
                lr=1e-2, batch_size=4, epochs=3, num_folder=2, output_dim1=6,
                output_dim2=1, savemodel=True, save_root=str(tmp_path / "saved"))
    res = loop.run_cv(args, _tone_set(tds, 8, 1, tmp_path), seed=0, verbose=False,
                      calc_fn=flat, device="cpu")
    assert res.best_epochs == [0, 0]
    for fold in (0, 1):
        path = tmp_path / "saved" / "model" / f"fold{fold}_backbone"
        assert sorted(os.listdir(path)) == ["config.json", "pytorch_model.bin"]
        saved = torch.load(path / "pytorch_model.bin", weights_only=True)
        last, first = after[3 * fold + 2], after[3 * fold]
        assert all(torch.equal(saved[k], v) for k, v in last.items())
        assert any(not torch.equal(saved[k], v) for k, v in first.items())


def test_one_optimizer_steps_backbone_and_head_at_one_rate(monkeypatch, tmp_path):
    """The JAX docstring's 1/10 backbone rate is never applied: JAX's
    ``run_cv`` builds one optax chain over every parameter
    (``train/loop.py:42-58,185``), and so does the port, one ``ClippedAdam``
    at ``args.lr`` holding the backbone and the head."""
    made, models = [], []
    init_model = loop.init_model

    class Recording(loop.ClippedAdam):
        def __init__(self, params, lr, **kw):
            super().__init__(params, lr, **kw)
            made.append(self)

    def recording_init(*a, **kw):
        models.append(init_model(*a, **kw))
        return models[-1]

    monkeypatch.setattr(loop, "ClippedAdam", Recording)
    monkeypatch.setattr(loop, "init_model", recording_init)
    args = Args(model="e2e_model", e2e_name="tiny-audio", hidden_dim=8, dropout=0.0,
                lr=3e-3, batch_size=4, epochs=1, num_folder=2, output_dim1=6,
                output_dim2=1)
    loop.run_cv(args, _tone_set(tds, 8, 1, tmp_path), verbose=False, device="cpu")
    assert len(made) == len(models) == 2        # one a fold
    for opt, model in zip(made, models):
        groups = opt.adam.param_groups
        assert len(groups) == 1 and groups[0]["lr"] == 3e-3
        assert {id(p) for p in groups[0]["params"]} == {id(p) for p in model.parameters()}
        assert any(n.startswith("backbone.") for n, _ in model.named_parameters())
