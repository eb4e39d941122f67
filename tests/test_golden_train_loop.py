"""Mini train.pl trajectory golden: the composed EM recipe vs the same
iteration schedule driven through the reference binaries.

Schedule (the train.pl shape at miniature scale, hmmnet mode — the
reference default `train.pl:42 USE_HMMNETS=1`): 3 EM iterations over
utterance hmmnets (stats -H / estimate --ml), one Gaussian split at
iteration 2 (`--split --minocc 1 --maxmixgauss 4`), and a gamma duration
model at the end (align + dur_est, `train.pl:159-166,614-627`).

Asserted:
* the per-iteration likelihood trajectory tracks between the two
  implementations (rel 1e-4 after independent float drift),
* the split happens identically (same Gaussian counts),
* final models close (means/covars/weights/transitions),
* the duration stage: reference align + dur_est on OUR final model
  reproduces our train.py --durations output exactly for non-silence
  states (silence states are zeroed per train.pl REMOVE_DUR_MODELS;
  their final alignment segment legitimately differs by the documented
  one-frame align/eof convention, test_golden_stats.py docstring).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from aaltoasr_tpu.formats import model_io

sys.path.insert(0, os.path.dirname(__file__))

from test_golden_hmmnet_stats import TRANSCRIPTS, make_hmmnet_corpus  # noqa: E402
from test_golden_stats import aku_bins  # noqa: E402,F401
from test_golden_estimate import assert_models_close, read_lls  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")


def run_ref_iteration(aku_bins, cwd, model_base, it, split):
    env = dict(os.environ)
    st = f"refst{it}"
    subprocess.run(
        [os.path.join(aku_bins, "stats"), "-b", model_base,
         "-c", "feats.cfg", "-r", "recipe", "-H", "--ml", "-t",
         "-M", "bw", "-F", "10000", "-W", "10000", "-o", st],
        cwd=cwd, check=True, capture_output=True, timeout=600, env=env)
    (cwd / f"{st}.lst").write_text(st + "\n")
    cmd = [os.path.join(aku_bins, "estimate"), "-b", model_base,
           "-L", f"{st}.lst", "-o", f"refm{it}", "--ml", "-t",
           "--minvar", "0.1"]
    if split:
        cmd += ["--split", "--minocc", "1.0", "--maxmixgauss", "4"]
    subprocess.run(cmd, cwd=cwd, check=True, capture_output=True,
                   timeout=600, env=env)
    ll = read_lls(cwd / f"{st}.lls")["Numerator loglikelihood"]
    return f"refm{it}", ll


class TestGoldenTrainLoop:
    def test_three_iteration_trajectory(self, aku_bins, tmp_path):
        make_hmmnet_corpus(tmp_path)
        # train.py needs transcript= for the final duration alignment
        lines = []
        for u, words in enumerate(TRANSCRIPTS):
            phn = tmp_path / f"u{u}.words.phn"
            phn.write_text("".join(w + "\n" for w in words))
            lines.append(f"audio={tmp_path}/u{u}.wav "
                         f"hmmnet={tmp_path}/u{u}.fst "
                         f"transcript={phn} "
                         f"alignment={tmp_path}/u{u}.ali.phn")
        (tmp_path / "recipe").write_text("\n".join(lines) + "\n")

        # ---- reference loop: 3x (stats -H -> estimate), split at 2
        base = "am"
        ref_lls = []
        for it in (1, 2, 3):
            base, ll = run_ref_iteration(aku_bins, tmp_path, base,
                                         it, split=(it == 2))
            ref_lls.append(ll)

        # ---- our loop: cli/train.py, same schedule ----------------
        from aaltoasr_tpu.cli.train import main as train_main
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            assert train_main(
                ["-b", "am", "-c", "feats.cfg", "-r", "recipe",
                 "-w", "work", "--id", "m", "--num-iters", "3",
                 "--split-frequency", "2", "--split-stop-iter", "2",
                 "--split-minocc", "1.0", "--split-maxmixgauss", "4",
                 "--split-alpha", "1.0", "--minvar", "0.1",
                 "--mllt-start-iter", "0", "-H", "-M", "bw",
                 "--durations", "--dur-mincount", "2"]) == 0
        finally:
            os.chdir(cwd)

        our_lls = []
        for line in open(tmp_path / "work" / "m.summary"):
            m = re.match(r"iter (\d+) loglikelihood (\S+)", line)
            if m:
                our_lls.append(float(m.group(2)))
        assert len(our_lls) == 3

        # likelihood trajectory tracks and EM improves
        for r, o in zip(ref_lls, our_lls):
            assert o == pytest.approx(r, rel=1e-4), (ref_lls, our_lls)
        assert ref_lls[2] > ref_lls[0]

        ref = model_io.read_model(str(tmp_path / "refm3"))
        ours = model_io.read_model(str(tmp_path / "work" / "m_3"))
        assert ref.num_gaussians == ours.num_gaussians  # same splits
        assert_models_close(ref, ours, rtol=2e-3)

        # ---- duration stage: reference align + dur_est on OUR final
        # model must reproduce train.py's .dur for non-silence states
        env = dict(os.environ)
        subprocess.run(
            [os.path.join(aku_bins, "align"), "-b", "work/m_3",
             "-c", "feats.cfg", "-r", "recipe"],
            cwd=tmp_path, check=True, capture_output=True,
            timeout=600, env=env)
        subprocess.run(
            [os.path.join(aku_bins, "dur_est"), "-p", "work/m_3.ph",
             "-r", "recipe", "-O", "--gamma", "ref.dur",
             "--mincount", "2"],
            cwd=tmp_path, check=True, capture_output=True,
            timeout=600, env=env)

        def read_dur(path):
            rows = [l.split() for l in open(path)][2:]
            return np.asarray(rows, dtype=np.float64)[:, 1:]

        ref_dur = read_dur(tmp_path / "ref.dur")
        our_dur = read_dur(tmp_path / "work" / "m_3.dur")
        sil = set()
        for ph in ours.phones:
            if "_" in ph.label:
                sil.update(ph.states)
        for s in range(ref_dur.shape[0]):
            if s in sil:
                assert np.all(our_dur[s] == 0.0), s  # REMOVE_DUR_MODELS
            else:
                np.testing.assert_allclose(our_dur[s], ref_dur[s],
                                           rtol=0, atol=1e-4,
                                           err_msg=str(s))
