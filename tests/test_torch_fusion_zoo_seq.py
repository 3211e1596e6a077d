"""The fusion zoo's sequence models (MCTN, MulT on frm_align and
frm_unalign) against the JAX package's, as ``test_torch_fusion_zoo.py``
holds the rest of the matrix: eval outputs and train-mode gradients from
the same weights. Their JAX compiles are the zoo's costliest, so they run
on a worker of their own."""

import pytest
import torch

from test_torch_fusion_zoo import ALL_CASES, SEQ, check_eval_outputs, check_train_gradients

torch.set_num_threads(1)

CASES = [c for c in ALL_CASES if c[0] in SEQ]
IDS = [f"{name}-{ft}" for name, _, ft in CASES]


@pytest.mark.parametrize("name,extra,feat_type", CASES, ids=IDS)
def test_eval_outputs_match_flax(name, extra, feat_type):
    check_eval_outputs(name, extra, feat_type)


@pytest.mark.parametrize("name,extra,feat_type", CASES, ids=IDS)
def test_train_gradients_match_flax(name, extra, feat_type):
    check_train_gradients(name, extra, feat_type)
