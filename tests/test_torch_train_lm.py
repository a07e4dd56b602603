"""The port's end-to-end training run (``repro_torch.train_lm``, the
counterpart of ``examples/train_lm.py``) on the CPU, at a reduced width:
data pipeline -> trainer -> checkpoints, a crash restored mid-run, and the
mean loss of the last tenth of the steps below that of the first."""

import pytest

from repro_torch import train_lm
from repro_torch.configs.base import ModelConfig


def test_train_lm_recovers_from_its_crash_and_the_loss_falls(monkeypatch, capsys):
    monkeypatch.setattr(train_lm, "model_10m", lambda: ModelConfig(
        name="lm-tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        attn_q_chunk=128, loss_seq_chunk=128))
    out = train_lm.main(["--device", "cpu", "--steps", "30"])
    assert out["final_step"] == 30 and out["restarts"] == 1
    assert out["last"] < out["first"]
    assert "ce_loss: first-3 avg" in capsys.readouterr().out


def test_train_lm_runs_on_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_lm.main(["--steps", "1"])
