"""Prompt templates of the AffectGPT-equivalent MLLM — the prompt half of
``mertools_tpu/mllm/chat.py`` (``DEFAULT_SYSTEM``, ``Conversation``,
``SEGMENT_TEXT``, ``encode_stream_prompt``), which the training data needs.
The wording is the reference's, exactly: converted checkpoints were trained
on these prompts. ``Chat`` and ``ChatSession`` come with the serving port.
"""

from __future__ import annotations

from dataclasses import dataclass

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
