from .base import get_model  # noqa: F401

# importing registers each model under its reference name: the zoo of
# MERBench/toolkit/models/__init__.py:18-46 with MER2024's additions, and
# the raw-input e2e_model (videomae_pretrain is ROADMAP A7b)
from . import (attention, attention_topn, e2e_model, ef_lstm,  # noqa: F401
               graph_mfn, lf_dnn, lmf, mctn, mfm, mfn, misa, mmim, mult, tfn)
