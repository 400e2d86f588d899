"""The port's data parallelism on cards.

Needs a CUDA card (marker ``cuda``) and skips without one; the second test
needs two cards or more. The file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_ddp_cuda.py

- ``chip_smoke.dp_reference_check`` (phase 23 of ``chip_smoke.py``): one step
  of a narrow detector and of a narrow cascade corrector by 2 gloo ranks
  placed on cuda:0, by 1 NCCL rank and, with two cards or more, by 2 NCCL
  ranks on two cards, each held to the one-process step on the same global
  batch, with the tolerances that function states.
- ``chip_smoke.dp_train_net_path`` with the CLI's own placement: the training
  CLI at full width (R-50-FPN base, AMP, IMS_PER_BATCH 16) in one NCCL rank
  a card over every card, with phase 24's checks (rank 0 alone writes, the
  merged evaluation equals a 1-process ``--eval-only``, K2/K3 1/1 a rank an
  iteration, ``sharded_knn_vote`` equal to ``knn_vote``); it prints ms/iter,
  ``data_time`` and peak memory a rank.
"""
import pytest
import torch

import chip_smoke


@pytest.fixture
def tag():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    chip_smoke.tf32_off()
    return f"[{chip_smoke.card_line()}]"


@pytest.mark.cuda
def test_data_parallel_step_on_cards_equals_one_process(tag):
    chip_smoke.dp_reference_check(tag)


@pytest.mark.cuda
def test_train_net_one_nccl_rank_a_card(tag):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards or more: one NCCL rank a card")
    chip_smoke.dp_train_net_path(tag, world=cards, devices=None)
