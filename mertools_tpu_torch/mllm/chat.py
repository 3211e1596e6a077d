"""Conversation and inference wrapper of the AffectGPT-equivalent MLLM —
port of ``mertools_tpu/mllm/chat.py``.

The prompt half (``DEFAULT_SYSTEM``, ``Conversation``, ``SEGMENT_TEXT``,
``encode_stream_prompt``) is the reference's wording exactly: converted
checkpoints were trained on these prompts. :class:`Chat` answers a batch of
clips at once: prompts are tokenized on the host, the AV tokens are spliced
by ``AffectGPT.generate_step_embeds`` and the batch decodes through the
KV-cached sampler (:func:`.generate.generate`), where the reference
(``conversation_video.py:200-260``) decodes one sample at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device, upload
from .generate import bucket_len, cast_llm_bf16, generate, make_generator

DEFAULT_SYSTEM = ("You are able to understand the video and audio the user "
                  "provides. Answer the question about the emotional state "
                  "of the person.")


@dataclass
class Conversation:
    system: str = DEFAULT_SYSTEM
    roles: tuple = ("Human", "Assistant")
    sep: str = "###"

    def render(self, subtitle: str, question: str,
               history: list | None = None) -> tuple[str, str]:
        """Returns (prefix_before_av, suffix_after_av). ``history`` is a list
        of earlier (question, answer) turns appended after the AV block —
        the reference Conversation accumulates messages the same way
        (conversation_video.py:33-76, Chat.ask/answer_sample :133-260)."""
        pre = f"{self.system}\n{self.sep}{self.roles[0]}: <Video>"
        sub = f" Subtitle: {subtitle}" if subtitle else ""
        turns = "".join(
            f"{q}\n{self.sep}{self.roles[1]}: {a}\n{self.sep}{self.roles[0]}: "
            for q, a in (history or []))
        post = (f"</Video>{sub} {turns}{question}\n"
                f"{self.sep}{self.roles[1]}: ")
        return pre, post


# the reference defaults inference to the ovlabel question
# (inference_hybird.py:109-114 -> func_get_qa_ovlabel question_only); the
# exact wording matters for converted trained checkpoints
DEFAULT_QUESTION = ("Please recognize all possible emotional states of the "
                    "character.")

# Per-segment prompt chunks (base_dataset.py:463-549 templates).
SEGMENT_TEXT = {
    "multi": ("The audio and video merged info is: <Multi>", "</Multi>. "),
    "audio": ("The audio content is as follows: <Audio>", "</Audio>. "),
    "face": ("Meanwhile, we uniformly sample raw frames from the video and "
             "extract faces from these frames: <Video>", "</Video>. "),
    "frame": ("Meanwhile, we uniformly sample raw frames from the video: "
              "<Video>", "</Video>. "),
    "image": ("The image content is as follows: <Image>", "</Image>. "),
}


def encode_stream_prompt(tokenizer, cfg, subtitle: str, question: str,
                         system: str = DEFAULT_SYSTEM,
                         history: list | None = None):
    """Tokenize a multi-stream prompt with one placeholder run per spliced
    segment (reference get_prompt_for_multimodal + the patch-token
    replacement, base_dataset.py:463-556).

    Returns (ids, starts) where ``starts[segment]`` is the index of that
    segment's placeholder run inside ``ids``.
    """
    from .affectgpt import stream_plan

    segments, _ = stream_plan(cfg.face_or_frame)
    ids, starts = [], {}
    head = f"{system}\n###Human: " if system else "###Human: "
    for i, seg in enumerate(segments):
        opener, closer = SEGMENT_TEXT[seg]
        text = (head if i == 0 else "") + opener
        ids += tokenizer.encode(text, add_special_tokens=(i == 0))
        starts[seg] = len(ids)
        ids += [0] * cfg.segment_tokens(seg)
        ids += tokenizer.encode(closer, add_special_tokens=False)
    if not segments:  # textonly
        ids += tokenizer.encode(head, add_special_tokens=True)
    sub = (f"The subtitle of this video is: <Subtitle>{subtitle}"
           f"</Subtitle>. ") if subtitle else ""
    turns = "".join(f"{q} ###Assistant: {a} ###Human: "
                    for q, a in (history or []))
    tail = (f"{sub}Now, please answer my question based on all the "
            f"provided information. {turns}{question} ###Assistant: ")
    ids += tokenizer.encode(tail, add_special_tokens=False)
    return ids, starts


class Chat:
    """Batched answers of an :class:`~.affectgpt.AffectGPT` on ``device``
    (the card unless the caller asks for ``"cpu"``; a host without a card
    raises); the model is moved there, and ``bf16`` casts its LLM to bf16 in
    place (the serving cast). Tokenizers without an EOS fall back to SEP,
    then PAD, then 0, so generation still ends deterministically."""

    def __init__(self, model, tokenizer, conv: Conversation | None = None,
                 max_new_tokens: int = 256, temperature: float = 0.0,
                 top_p: float = 0.9, eos_token_id: int | None = None,
                 max_len: int = 512, repetition_penalty: float = 1.0,
                 kv_int8: bool = False, bf16: bool = False, device="cuda"):
        self.device = resolve_device(device, fp32=not bf16)
        self.model = model.to(self.device).eval()
        if bf16:
            cast_llm_bf16(self.model.llm)
        self.kv_int8 = kv_int8
        self.tok = tokenizer
        self.conv = conv or Conversation()
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.eos = (eos_token_id if eos_token_id is not None
                    else tokenizer.eos_token_id)
        if self.eos is None:      # explicit None checks: id 0 is legitimate
            for attr in ("sep_token_id", "pad_token_id"):
                tid = getattr(tokenizer, attr, None)
                if tid is not None:
                    self.eos = tid
                    break
            else:
                self.eos = 0
        self.repetition_penalty = repetition_penalty
        self.max_len = max_len

    def _encode_prompts(self, items):
        """items: (subtitle, question[, history]) tuples -> right-padded
        input_ids, attention_mask and splice starts (numpy)."""
        n_av = self.model.num_av_tokens
        ids_list, starts = [], []
        for subtitle, question, *rest in items:
            history = rest[0] if rest else None
            pre, post = self.conv.render(subtitle, question or DEFAULT_QUESTION,
                                         history)
            pre_ids = self.tok.encode(pre, add_special_tokens=True)
            post_ids = self.tok.encode(post, add_special_tokens=False)
            ids = pre_ids + [0] * n_av + post_ids
            if len(ids) > self.max_len:
                # truncating would cut the current question and the
                # assistant cue: fail loudly
                raise ValueError(
                    f"prompt length {len(ids)} exceeds max_len "
                    f"{self.max_len}; raise max_len or trim the history")
            ids_list.append(ids)
            starts.append(len(pre_ids))
        S = bucket_len(max(len(i) for i in ids_list), cap=self.max_len)
        input_ids = np.zeros((len(ids_list), S), np.int64)
        mask = np.zeros((len(ids_list), S), np.int64)
        for b, ids in enumerate(ids_list):
            input_ids[b, : len(ids)] = ids
            mask[b, : len(ids)] = 1
        return input_ids, mask, np.asarray(starts, np.int64)

    def _decode_rows(self, tokens: np.ndarray) -> list[str]:
        out = []
        for toks in tokens:
            stop = np.nonzero(toks == self.eos)[0]
            toks = toks[: stop[0]] if len(stop) else toks
            out.append(self.tok.decode(toks.tolist(),
                                       skip_special_tokens=True).strip())
        return out

    def _generate(self, batch: dict, mask: np.ndarray, generator) -> list[str]:
        dev = self.device
        with torch.inference_mode():
            embeds = self.model.generate_step_embeds(
                {k: upload(v, dev) for k, v in batch.items()})
            tokens = generate(
                self.model.llm, embeds, upload(mask, dev),
                max_new_tokens=self.max_new_tokens, temperature=self.temperature,
                top_p=self.top_p, eos_token_id=int(self.eos),
                repetition_penalty=self.repetition_penalty, kv_int8=self.kv_int8,
                generator=generator if generator is not None
                else make_generator(dev, 0))
        return self._decode_rows(tokens.cpu().numpy())

    def _answer_batch_streams(self, samples, generator):
        """Multi-stream inference (cfg.face_or_frame set): one placeholder
        run per spliced segment, batched."""
        from .affectgpt import stream_plan
        from .data import _pad_stream

        cfg = self.model.cfg
        segments, needed = stream_plan(cfg.face_or_frame)
        ids_list, starts_list = [], []
        for s in samples:
            ids, starts = encode_stream_prompt(
                self.tok, cfg, s.get("subtitle", ""),
                s.get("question") or DEFAULT_QUESTION, history=s.get("history"))
            if len(ids) > self.max_len:
                raise ValueError(f"prompt length {len(ids)} exceeds max_len")
            ids_list.append(ids)
            starts_list.append(starts)
        B = len(samples)
        S = bucket_len(max(len(i) for i in ids_list), cap=self.max_len)
        batch = {"input_ids": np.zeros((B, S), np.int64)}
        mask = np.zeros((B, S), np.int64)
        for seg in segments:
            batch[f"splice_{seg}"] = np.asarray([st[seg] for st in starts_list],
                                                np.int64)
        stream_caps = {"face": cfg.max_video_frames, "frame": cfg.max_video_frames,
                       "audio": cfg.max_audio_frames}
        for stream in sorted(needed):
            # frame counts bucket too (not image: 'token' fusion splices one
            # LLM token per input frame, so its length is semantic)
            feats, smask = _pad_stream(samples, f"{stream}_feats",
                                       multiple=8 if stream in stream_caps else 1,
                                       cap=stream_caps.get(stream))
            batch[f"{stream}_feats"] = feats
            batch[f"{stream}_mask"] = smask
        for b, ids in enumerate(ids_list):
            batch["input_ids"][b, : len(ids)] = ids
            mask[b, : len(ids)] = 1
        return self._generate(batch, mask, generator)

    def answer_batch(self, samples: list[dict], generator=None) -> list[str]:
        """samples: dicts with video_feats (Tv, Dv) and audio_feats (Ta, Da)
        -- or per-stream ``{stream}_feats`` when cfg.face_or_frame is set --
        plus optional subtitle / question / history. Returns the decoded
        answers. ``generator`` drives sampling (default: seed 0)."""
        if self.model.cfg.face_or_frame is not None:
            return self._answer_batch_streams(samples, generator)
        B = len(samples)
        cfg = self.model.cfg
        Tv = max(s["video_feats"].shape[0] for s in samples)
        Ta = max(s["audio_feats"].shape[0] for s in samples)
        # bucket frame counts so ragged clips share shapes
        Tv = max(Tv, min(bucket_len(Tv, 8), cfg.max_video_frames))
        Ta = max(Ta, min(bucket_len(Ta, 8), cfg.max_audio_frames))
        Dv = samples[0]["video_feats"].shape[1]
        Da = samples[0]["audio_feats"].shape[1]
        video = np.zeros((B, Tv, Dv), np.float32)
        audio = np.zeros((B, Ta, Da), np.float32)
        vmask = np.zeros((B, Tv), np.int64)
        amask = np.zeros((B, Ta), np.int64)
        for b, s in enumerate(samples):
            tv, ta = s["video_feats"].shape[0], s["audio_feats"].shape[0]
            video[b, :tv] = s["video_feats"]
            audio[b, :ta] = s["audio_feats"]
            vmask[b, :tv] = 1
            amask[b, :ta] = 1
        input_ids, mask, starts = self._encode_prompts(
            [(s.get("subtitle", ""), s.get("question"), s.get("history"))
             for s in samples])
        batch = {"video_feats": video, "audio_feats": audio,
                 "video_mask": vmask, "audio_mask": amask,
                 "input_ids": input_ids, "splice_start": starts}
        return self._generate(batch, mask, generator)


class ChatSession:
    """Stateful multi-turn conversation over one clip (the reference's
    ``Chat.ask`` + ``answer_sample``, conversation_video.py:133-260): the
    features are fixed at construction and each :meth:`ask` appends a
    (question, answer) turn to the history later prompts include."""

    def __init__(self, chat: Chat, sample: dict):
        self.chat = chat
        self.sample = {k: v for k, v in sample.items() if k != "history"}
        self.history: list[tuple[str, str]] = list(sample.get("history", []))

    def ask(self, question: str, generator=None) -> str:
        answer = self.chat.answer_batch(
            [{**self.sample, "question": question, "history": self.history}],
            generator=generator)[0]
        self.history.append((question, answer))
        return answer
