"""The port's checkpoint reader (``core/checkpoint.py``): a ``config.json``
that lacks a key reads as transformers reads it, with the key's class
default, for every model type the port's encoders load."""

import dataclasses

import pytest
import transformers as tr

from mertools_tpu_torch.core.checkpoint import with_class_defaults
from mertools_tpu_torch.encoders import bert as tb
from mertools_tpu_torch.encoders import vit_clip as tc
from mertools_tpu_torch.encoders import wav2vec2 as tw
from mertools_tpu_torch.encoders import whisper as tws


def _from_dict(port_cls):
    return getattr(port_cls, "from_config_json", None) or port_cls.from_hf


# (port config class, model type, transformers config class)
CASES = [
    (tw.Wav2Vec2Config, "wav2vec2", tr.Wav2Vec2Config),
    (tw.Wav2Vec2Config, "hubert", tr.HubertConfig),
    (tw.Wav2Vec2Config, "wavlm", tr.WavLMConfig),
    (tw.Wav2Vec2Config, "data2vec-audio", tr.Data2VecAudioConfig),
    (tws.WhisperConfig, "whisper", tr.WhisperConfig),
    (tb.BertConfig, "bert", tr.BertConfig),
    (tb.BertConfig, "roberta", tr.RobertaConfig),
    (tb.BertConfig, "xlm-roberta", tr.XLMRobertaConfig),
    (tb.BertConfig, "camembert", tr.CamembertConfig),
    (tb.BertConfig, "electra", tr.ElectraConfig),
    (tc.CLIPVisionConfig, "clip_vision_model", tr.CLIPVisionConfig),
    (tc.CLIPVisionConfig, "clip", tr.CLIPConfig),
]


@pytest.mark.parametrize("port_cls, model_type, hf_cls", CASES,
                         ids=[c[1] for c in CASES])
def test_a_bare_config_json_reads_as_the_class_defaults(port_cls, model_type, hf_cls):
    """``{"model_type": t}`` alone gives the config that transformers'
    class of type t holds by default: every key the port reads has its
    class default, and none is missing from the port's table."""
    got = _from_dict(port_cls)({"model_type": model_type})
    want = _from_dict(port_cls)(hf_cls().to_dict())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_a_file_keeps_its_own_values_and_an_unknown_type_exits():
    table = {"bert": {"hidden_size": 768, "layer_norm_eps": 1e-12}}
    assert with_class_defaults({"model_type": "bert", "hidden_size": 1024}, table) == {
        "model_type": "bert", "hidden_size": 1024, "layer_norm_eps": 1e-12}
    with pytest.raises(SystemExit, match="model_type 'gpt2' is not one of"):
        with_class_defaults({"model_type": "gpt2"}, table)
    with pytest.raises(SystemExit, match="model_type None"):
        tb.BertConfig.from_hf({"hidden_size": 64})
