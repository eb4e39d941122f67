"""chip_smoke.py on the CPU: task generation, device refusal, and every
phase at a tiny size (the card runs them at full width)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read().replace(str(d).encode(), b"<dir>")
    return out


def test_task_is_deterministic_from_seed(tmp_path):
    a = cs.write_task(str(tmp_path / "a"), 3, cs.TINY)
    b = cs.write_task(str(tmp_path / "b"), 3, cs.TINY)
    c = cs.write_task(str(tmp_path / "c"), 4, cs.TINY)
    fa, fb, fc = _files(a["dir"]), _files(b["dir"]), _files(c["dir"])
    assert fa == fb
    assert fa["am.gk"] != fc["am.gk"]
    assert a["model"].num_gaussians == cs.TINY["num_gaussians"]
    assert all(len(ix) == cs.TINY["mixture"] for ix, _ in a["model"].mixtures)


def test_refuses_the_cpu():
    from aaltoasr_tpu.utils.device import require_gpu
    with pytest.raises(SystemExit) as e:
        require_gpu("chip_smoke")
    assert e.value.code == 2


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_card(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:           # the script in a directory of its own
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lna_and_hypothesis_comparisons(tmp_path):
    from aaltoasr_tpu.formats.lna import write_lna
    rng = np.random.default_rng(0)
    lp = -rng.uniform(0, 30, (50, 7)).astype(np.float32)
    write_lna(str(tmp_path / "a.lna"), lp, 2)
    lp2 = lp.copy()
    lp2[3, 4] -= 1.0 / 1820
    write_lna(str(tmp_path / "b.lna"), lp2, 2)
    c = cs.compare_lna(str(tmp_path / "a.lna"), str(tmp_path / "b.lna"))
    assert c["max_code_delta"] == 1
    assert c["identical_share"] == pytest.approx(1 - 1 / 350)
    hyps = cs.parse_hyps("w1 w2 (u00.lna)\nnoise\n (u01.lna)\n")
    assert hyps == {"u00.lna": ["w1", "w2"], "u01.lna": []}
    assert cs.compare_words(hyps, {"u00.lna": ["w1"], "u01.lna": []},
                            ["u00.lna", "u01.lna"]) == ["u00.lna"]


def test_one_card_phases_tiny(tmp_path):
    res = cs.run_all(cs.TINY, 0, str(tmp_path), run_gpu_tests=False)
    assert set(res["times"]) == {"task", "recognize_dense",
                                 "recognize_exact", "planted", "train",
                                 "cpu_parity"}
    assert max(res["train"]["rel"]) <= 1e-4
    assert not any(res["word_diffs"].values())
    for c in res["lna"].values():
        assert c["max_code_delta"] <= 1
    json.dumps(res)


def test_four_card_phase_tiny():
    res = cs.four_cards(0, n_devices=4, B=8, T=64, G=256,
                        planted_batch=8, planted_frames=100, num_words=30)
    assert res["decode_word_diffs"] == []
    assert res["em_4x1"]["ll_rel"] <= 1e-6
    assert res["em_2x2"]["means_rel"] <= 1e-5
