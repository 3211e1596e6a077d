"""MLLM training datasets (MERCaptionPlus / OVMERD equivalents) — the
port's copy of ``mertools_tpu/mllm/data.py`` (numpy only).

Reference (``my_affectgpt/datasets/datasets/mercaptionplus_dataset.py:25-105``
+ ``base_dataset``): per-clip annotations join three CSVs — openset labels,
reason descriptions, subtitles — and the QA prompt asks for either the
``description`` or the ``ovlabel`` (label_type candidates). Raw media goes
through processors; here the AV side reads the offline feature store (the
frozen encoders already ran in the extraction pipeline — same factorization
the reference uses for its 'face'/'frame' precomputed features).

Batches come out right-padded with static shapes per length bucket:
input_ids / attention_mask / labels (-100 outside the answer span) /
splice_start / video_feats / audio_feats (+masks) — exactly the AffectGPT
training contract (mllm/affectgpt.py).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np

from ..ops.ov_metrics import string_to_list
from .chat import DEFAULT_SYSTEM, Conversation

# ---------------------------------------------------------------------------
# QA-type algebra (reference base_dataset.py:254-374 / get_qa_pairs:376-460).
# The template strings are reproduced EXACTLY (including the reference's
# "ﬂoating-point" ligature) — converted reference checkpoints were trained
# on these prompts, so any drift costs accuracy.
# ---------------------------------------------------------------------------

IMAGE_CAPTION_PROMPTS = (  # base_dataset.py:38-41
    "Describe this image in detail.",
    "Take a look at this image and describe what you notice.",
    "Please provide a detailed description of the picture.",
    "Could you describe the contents of this image for me?")
AUDIO_CAPTION_PROMPTS = (  # base_dataset.py:43-46
    "Describe this audio in detail.",
    "Listen to this audio and describe what you hear.",
    "Please provide a detailed description of this audio.",
    "Could you describe the contents of this audio for me?")


def build_qa(label_type: str, ann: dict, ds: "CaptionDataset",
             rng: np.random.Generator) -> tuple[str, str]:
    """(question, answer) for one sample — base_dataset.py:254-374."""
    if label_type == "description":
        return ("Please infer the person's emotional state and provide "
                "your reasoning process.", ann["description"])
    if label_type == "ovlabel":
        return ("Please recognize all possible emotional states of the "
                "character.",
                f"The character's emotional state is {ann['ovlabel']}.")
    if label_type == "onehot_w_candidates":
        return (f"Please select the label that can best describe the "
                f"person's emotional state from the provided candidate "
                f"labels: {ds.candidate_labels}.",
                f"The most likely label is {ann['onehot']}.")
    if label_type == "onehot_wo_candidates":
        return ("Please recognize the character's most likely emotional "
                "state.",
                f"The character's emotional state is {ann['onehot']}.")
    if label_type == "valence":
        return (f"Please identify the overall positive or negative "
                f"emotional polarity of the main characters. The output "
                f"should be a ﬂoating-point number ranging from "
                f"{ds.minval} to {ds.maxval}. Here, {ds.minval} indicates "
                f"extremely negative emotions, 0 indicates neutral "
                f"emotions, and {ds.maxval} indicates extremely positive "
                f"emotions. Please provide your judgment as a "
                f"ﬂoating-point number.",
                "The valence score is %.2f." % float(ann["valence"]))
    if label_type == "sentiment":
        sent = ann.get("sentiment") or (
            "positive" if float(ann["valence"]) > 0 else
            "negative" if float(ann["valence"]) < 0 else "neutral")
        return ("Please select the most likely sentiment label that can "
                "best describe the person's emotional state: positive, "
                "negative, neutral.",
                f"The character's sentiment state is {sent}.")
    if label_type == "qa":
        return ann["question"], ann["answer"]
    if label_type in ("caption", "caption_image"):
        prompts = IMAGE_CAPTION_PROMPTS
        return (prompts[int(rng.integers(0, len(prompts)))], ann["caption"])
    if label_type == "caption_audio":
        prompts = AUDIO_CAPTION_PROMPTS
        return (prompts[int(rng.integers(0, len(prompts)))], ann["caption"])
    if label_type == "preference":
        a1, a2, pref = ann["a1"], ann["a2"], ann["p"]
        question = (f"We provide two descriptions. a1: {a1} \t\t\t a2: {a2} "
                    f"Please select the one that best matches the video "
                    f"content.")
        assert pref in ("a1", "a2", "same"), pref
        answer = (f"The best one is {pref}." if pref in ("a1", "a2") else
                  "These two sentences describe the content of the video "
                  "with the same accuracy.")
        return question, answer
    if label_type == "reward":
        reward = ann["reward"]
        assert reward in ("accept", "reject"), reward
        return (f"We have provided a description: {ann['description']} "
                f"\t\t\t Please evaluate and decide whether to accept or "
                f"reject this description based on its alignment with the "
                f"video content.",
                f"{reward} this sentence.")
    raise KeyError(f"unknown label_type {label_type!r}")


# annotation column each label type needs (candidate derivation for
# mixed/hybird sampling — reference get_qa_pairs per-dataset candidate sets)
_QA_REQUIRED_KEY = {
    "description": "description", "ovlabel": "ovlabel",
    "onehot_w_candidates": "onehot", "onehot_wo_candidates": "onehot",
    "valence": "valence", "sentiment": "valence", "qa": "question",
    "caption": "caption", "caption_image": "caption",
    "caption_audio": "caption", "preference": "p", "reward": "reward",
}



def _read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


@dataclass
class CaptionDataset:
    """Annotation join + feature reads for MLLM training."""

    annotations: list[dict]
    video_feat_dir: str
    audio_feat_dir: str
    max_video_frames: int = 64
    max_audio_frames: int = 64
    # any build_qa type, or mixed/hybird for per-sample random selection
    # over label_type_candidates (reference get_cur_label_type :125-131)
    label_type: str = "description"
    # explicit candidate set for mixed/hybird; None derives it from the
    # columns present on each annotation (get_qa_pairs per-dataset sets)
    label_type_candidates: tuple | None = None
    candidate_labels: str = ""      # onehot_w_candidates question (:276-279)
    minval: float = -1.0            # valence range (CMUMOSI/MOSEI: -3..3,
    maxval: float = 1.0             # SIMS/SIMSv2: -1..1)
    # Multi-stream mode (cfg.face_or_frame set): per-stream feature dirs;
    # unset streams fall back to video_feat_dir (face/frame/image) or
    # audio_feat_dir (audio) — the reference points 'face' at openface-crop
    # features and 'frame' at raw-video features of the same clips.
    face_or_frame: str | None = None
    stream_dirs: dict = field(default_factory=dict)

    @classmethod
    def from_csvs(cls, openset_csv: str, reason_csv: str | None,
                  subtitle_csv: str | None, video_feat_dir: str,
                  audio_feat_dir: str, **kw) -> "CaptionDataset":
        """reason_csv=None covers the ovlabel-only datasets (MER2026-T2
        Human_Dataset / MER2026OV join just openset + subtitle and set
        label_type_candidates=['ovlabel'] — human_dataset.py:40-60)."""
        # one pass over the openset csv collects both the labels and any
        # extra QA columns (onehot/valence/.../reward) riding on it
        extra_cols = ("onehot", "valence", "sentiment", "caption",
                      "question", "answer", "a1", "a2", "p", "reward")
        name2openset, name2extra = {}, {}
        for r in _read_csv(openset_csv):
            labels = string_to_list(r.get("openset", "")) or ["neutral"]
            name2openset[r["name"]] = ", ".join(labels)
            extra = {k: r[k] for k in extra_cols if r.get(k)}
            if extra:
                name2extra[r["name"]] = extra
        name2reason = ({r["name"]: (r.get("reason") or "")
                        for r in _read_csv(reason_csv)} if reason_csv
                       else {})
        if not reason_csv:
            kw.setdefault("label_type", "ovlabel")
        name2sub = {}
        if subtitle_csv:
            for r in _read_csv(subtitle_csv):
                name2sub[r["name"]] = (r.get("english") or
                                       r.get("sentence") or
                                       r.get("chinese") or "")
        annotations = []
        for name, openset in name2openset.items():
            # raw-media mode (video_feat_dir=None) keeps every labeled clip;
            # feature mode drops clips missing from the store (the reference
            # datasets iterate the label csv against the feature dir)
            if video_feat_dir and not os.path.exists(
                    os.path.join(video_feat_dir, name + ".npy")):
                continue
            annotations.append({
                "name": name, "subtitle": name2sub.get(name, ""),
                "description": name2reason.get(name, ""), "ovlabel": openset,
                **name2extra.get(name, {})})
        return cls(annotations=annotations, video_feat_dir=video_feat_dir,
                   audio_feat_dir=audio_feat_dir, **kw)

    def __len__(self):
        return len(self.annotations)

    def _feat(self, root, name, cap):
        x = np.load(os.path.join(root, name + ".npy")).astype(np.float32)
        if x.ndim == 1:
            x = x[None]
        if len(x) > cap:
            idx = np.linspace(0, len(x) - 1, cap).astype(int)
            x = x[idx]
        return x

    def sample(self, idx: int, rng: np.random.Generator,
               load_features: bool = True) -> dict:
        """``load_features=False`` yields only the QA/text fields (the
        raw-media training path encodes features per batch instead —
        mllm/raw_train.py)."""
        ann = self.annotations[idx]
        # 'hybird' is the reference's spelling for random candidate selection
        # (base_dataset.py:125-128); candidates come from the explicit set
        # or from the columns this annotation actually carries
        if self.label_type in ("mixed", "hybird"):
            cands = self.label_type_candidates or tuple(
                t for t in ("description", "ovlabel", "sentiment", "valence")
                if ann.get(_QA_REQUIRED_KEY[t]))
            if not cands:
                raise ValueError(
                    f"label_type={self.label_type!r} but annotation "
                    f"{ann.get('name')!r} carries none of the candidate "
                    f"columns (description/ovlabel/valence)")
            label_type = cands[int(rng.integers(0, len(cands)))]
        else:
            label_type = self.label_type
        question, answer = build_qa(label_type, ann, self, rng)
        out = {
            "name": ann["name"],
            "subtitle": ann["subtitle"],
            "question": question,
            "answer": answer,
        }
        if not load_features:
            return out
        if self.face_or_frame is None:
            out["video_feats"] = self._feat(self.video_feat_dir, ann["name"],
                                            self.max_video_frames)
            out["audio_feats"] = self._feat(self.audio_feat_dir, ann["name"],
                                            self.max_audio_frames)
            return out
        from .affectgpt import stream_plan

        _, needed = stream_plan(self.face_or_frame)
        for stream in needed:
            default = (self.audio_feat_dir if stream == "audio"
                       else self.video_feat_dir)
            cap = (self.max_audio_frames if stream == "audio"
                   else self.max_video_frames)
            out[f"{stream}_feats"] = self._feat(
                self.stream_dirs.get(stream, default), ann["name"], cap)
        return out


def build_batch(samples: list[dict], tokenizer, num_av_tokens: int,
                max_len: int = 512, conv: Conversation | None = None) -> dict:
    """Right-padded training batch with -100 labels outside the answer."""
    conv = conv or Conversation()
    eos = tokenizer.eos_token_id
    per = []
    for s in samples:
        pre, post = conv.render(s["subtitle"], s["question"])
        pre_ids = tokenizer.encode(pre, add_special_tokens=True)
        post_ids = tokenizer.encode(post, add_special_tokens=False)
        ans_ids = tokenizer.encode(s["answer"],
                                   add_special_tokens=False) + [eos]
        ids = pre_ids + [0] * num_av_tokens + post_ids + ans_ids
        labels = ([-100] * (len(ids) - len(ans_ids))) + ans_ids
        ids, labels = ids[:max_len], labels[:max_len]
        per.append((ids, labels, min(len(pre_ids),
                                     max(max_len - num_av_tokens, 0))))

    B = len(samples)
    S = max(len(p[0]) for p in per)
    Tv = max(s["video_feats"].shape[0] for s in samples)
    Ta = max(s["audio_feats"].shape[0] for s in samples)
    Dv = samples[0]["video_feats"].shape[1]
    Da = samples[0]["audio_feats"].shape[1]

    batch = {
        "input_ids": np.zeros((B, S), np.int32),
        "attention_mask": np.zeros((B, S), np.int32),
        "labels": np.full((B, S), -100, np.int64),
        "splice_start": np.zeros(B, np.int32),
        "video_feats": np.zeros((B, Tv, Dv), np.float32),
        "audio_feats": np.zeros((B, Ta, Da), np.float32),
        "video_mask": np.zeros((B, Tv), np.int32),
        "audio_mask": np.zeros((B, Ta), np.int32),
    }
    for b, ((ids, labels, start), s) in enumerate(zip(per, samples)):
        batch["input_ids"][b, : len(ids)] = ids
        batch["attention_mask"][b, : len(ids)] = 1
        batch["labels"][b, : len(labels)] = labels
        batch["splice_start"][b] = start
        tv = s["video_feats"].shape[0]
        ta = s["audio_feats"].shape[0]
        batch["video_feats"][b, :tv] = s["video_feats"]
        batch["audio_feats"][b, :ta] = s["audio_feats"]
        batch["video_mask"][b, :tv] = 1
        batch["audio_mask"][b, :ta] = 1
    return batch


def _pad_stream(samples: list[dict], key: str, multiple: int = 1,
                cap: int | None = None):
    """Stack ragged (T_i, D) features -> (B, T_max, D) + (B, T_max) mask.
    ``multiple`` rounds T_max up to a bucket so repeated inference batches
    reuse compiled shapes; ``cap`` bounds the bucket (frame-position tables
    are sized to the config's max frames)."""
    B = len(samples)
    T = max(s[key].shape[0] for s in samples)
    if multiple > 1:
        bucket = -(-T // multiple) * multiple
        T = max(T, min(bucket, cap) if cap is not None else bucket)
    D = samples[0][key].shape[1]
    feats = np.zeros((B, T, D), np.float32)
    mask = np.zeros((B, T), np.int32)
    for b, s in enumerate(samples):
        t = s[key].shape[0]
        feats[b, :t] = s[key]
        mask[b, :t] = 1
    return feats, mask


def build_stream_batch(samples: list[dict], tokenizer, cfg,
                       max_len: int = 512, system: str | None = None) -> dict:
    """Multi-stream training batch for a ``face_or_frame`` config: one
    placeholder run per spliced segment (reference builds the same prompts in
    base_dataset.get_prompt_for_multimodal :463-549 and splices every segment
    in affectgpt.forward :686-711).

    ``samples`` carry ``{stream}_feats`` for each needed stream plus
    subtitle/question/answer strings. Raises if a prompt's placeholder runs
    don't fit ``max_len`` (only the answer may be truncated).
    """
    from .affectgpt import stream_plan
    from .chat import DEFAULT_SYSTEM, encode_stream_prompt

    segments, needed = stream_plan(cfg.face_or_frame)
    eos = tokenizer.eos_token_id
    per = []
    for s in samples:
        ids, starts = encode_stream_prompt(
            tokenizer, cfg, s.get("subtitle", ""), s["question"],
            system=DEFAULT_SYSTEM if system is None else system)
        if len(ids) > max_len:
            raise ValueError(f"prompt length {len(ids)} exceeds max_len "
                             f"{max_len}; placeholder runs must not truncate")
        ans = tokenizer.encode(s["answer"], add_special_tokens=False) + [eos]
        full = (ids + ans)[:max_len]
        labels = ([-100] * len(ids) + ans)[:max_len]
        per.append((full, labels, starts))

    B = len(samples)
    S = max(len(p[0]) for p in per)
    batch = {
        "input_ids": np.zeros((B, S), np.int32),
        "attention_mask": np.zeros((B, S), np.int32),
        "labels": np.full((B, S), -100, np.int64),
    }
    for seg in segments:
        batch[f"splice_{seg}"] = np.zeros(B, np.int32)
    for stream in sorted(needed):
        feats, mask = _pad_stream(samples, f"{stream}_feats")
        batch[f"{stream}_feats"] = feats
        batch[f"{stream}_mask"] = mask
    for b, (ids, labels, starts) in enumerate(per):
        batch["input_ids"][b, : len(ids)] = ids
        batch["attention_mask"][b, : len(ids)] = 1
        batch["labels"][b, : len(labels)] = labels
        for seg, start in starts.items():
            batch[f"splice_{seg}"][b] = start
    return batch


def _pad_seq_to_multiple(batch: dict, pad_to_multiple: int, max_len: int):
    """Round sequence length up so XLA sees few shapes."""
    S = batch["input_ids"].shape[1]
    target = min(-(-S // pad_to_multiple) * pad_to_multiple, max_len)
    if target > S:
        pad = target - S
        for k in ("input_ids", "attention_mask"):
            batch[k] = np.pad(batch[k], ((0, 0), (0, pad)))
        batch["labels"] = np.pad(batch["labels"], ((0, 0), (0, pad)),
                                 constant_values=-100)
    return batch


def stream_batch_iterator(dataset: CaptionDataset, tokenizer, model_cfg,
                          batch_size: int, seed: int = 0, max_len: int = 512,
                          pad_to_multiple: int = 32):
    """Infinite shuffled iterator of multi-stream training batches
    (``model_cfg.face_or_frame`` set)."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            samples = [dataset.sample(int(j), rng)
                       for j in order[i: i + batch_size]]
            batch = build_stream_batch(samples, tokenizer, model_cfg,
                                       max_len)
            yield _pad_seq_to_multiple(batch, pad_to_multiple, max_len)


def batch_iterator(dataset: CaptionDataset, tokenizer, num_av_tokens: int,
                   batch_size: int, seed: int = 0, max_len: int = 512,
                   pad_to_multiple: int = 32):
    """Infinite shuffled iterator of training batches (the reference runs
    iter-based epochs — runner_base.py:198-293 + base_task.py:101-185).

    Sequence lengths round up to ``pad_to_multiple`` so XLA sees few shapes.
    """
    rng = np.random.default_rng(seed)
    n = len(dataset)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            samples = [dataset.sample(int(j), rng)
                       for j in order[i: i + batch_size]]
            batch = build_batch(samples, tokenizer, num_av_tokens, max_len)
            yield _pad_seq_to_multiple(batch, pad_to_multiple, max_len)


class FakeWordTokenizer:
    """Hash-bucket word tokenizer for smoke configs without a checkpoint."""

    def __init__(self, vocab_size: int = 256):
        self.vocab_size = vocab_size
        self.eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        return [3 + (hash(w) % (self.vocab_size - 3)) for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids if i != self.eos_token_id)
