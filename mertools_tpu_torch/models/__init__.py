from .base import get_model  # noqa: F401

# importing registers each model under its reference name: the zoo of
# MERBench/toolkit/models/__init__.py:18-46 with MER2024's additions; the
# raw-input e2e_model and videomae_pretrain are ROADMAP A7
from . import (attention, attention_topn, ef_lstm, graph_mfn,  # noqa: F401
               lf_dnn, lmf, mctn, mfm, mfn, misa, mmim, mult, tfn)
