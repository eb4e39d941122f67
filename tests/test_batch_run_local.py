"""batch_run local mode: one card per concurrent worker."""

import sys

import pytest

from aaltoasr_tpu.cli import batch_run


def _cmd(tmp_path):
    return [sys.executable, "-c",
            "import os, sys; open(sys.argv[1], 'w').write("
            "os.environ.get('CUDA_VISIBLE_DEVICES', '-'))",
            str(tmp_path / "card_{I}")]


def test_each_worker_gets_its_own_card(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(batch_run, "visible_cards", lambda: ["0", "1"])
    rc = batch_run.main(["-B", "4", "-j", "2", "--failed-list",
                         str(tmp_path / "failed"), "--"] + _cmd(tmp_path))
    assert rc == 0
    cards = [(tmp_path / f"card_{i}").read_text() for i in range(1, 5)]
    assert set(cards) <= {"0", "1"}
    assert cards[0] != cards[1]          # the first two run at once


def test_more_workers_than_cards_refused(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(batch_run, "visible_cards", lambda: ["0", "1"])
    with pytest.raises(SystemExit):
        batch_run.main(["-B", "4", "-j", "3", "--"] + _cmd(tmp_path))


def test_cpu_workers_keep_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(batch_run, "visible_cards", lambda: ["0"])
    rc = batch_run.main(["-B", "2", "-j", "2", "--failed-list",
                         str(tmp_path / "failed"), "--"] + _cmd(tmp_path))
    assert rc == 0
    assert (tmp_path / "card_1").read_text() == "-"


def test_visible_cards_from_environment(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 5")
    assert batch_run.visible_cards() == ["2", "5"]
