"""Training-side golden parity vs the reference aku binaries, built
offline against the stub libsndfile + mini-lapackpp in tools/aku_stub
(tools/build_aku.sh; the reference's own CMake needs network access).

Pipeline under test:
  reference `align` (Viterbi.cc forced alignment) -> state-segmented
  phns -> reference `stats --ml -t -O` dumps vs our
  `aalto-stats -O` (`train/driver.py run_recipe_aligned`) on the SAME
  alignments: .gks/.mcs buffers within float-noise tolerances,
  .phs transition counts and feacounts EXACTLY equal, .lls close.
Plus align-vs-align: identical interior boundaries (the final segment
end may differ by one frame: the reference aligner emits one more
frame than its own feature generator later yields, and its stats
truncates at eof — `stats.cc:112` `if (fea_gen.eof()) break`).
"""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from aaltoasr_tpu.formats import model_io

sys.path.insert(0, os.path.dirname(__file__))

from test_train import three_state_model  # noqa: E402
from test_train_cli import CFG  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
BUILD = os.path.join(REPO, "build", "aku")


@pytest.fixture(scope="session")
def aku_bins():
    need = ["align", "stats"]
    if all(os.path.exists(os.path.join(BUILD, t)) for t in need):
        return BUILD
    if not os.path.isdir("/root/reference/aku"):
        pytest.skip("reference aku tree unavailable")
    try:
        subprocess.run([os.path.join(REPO, "tools", "build_aku.sh")],
                       check=True, capture_output=True, timeout=600)
    except (subprocess.CalledProcessError,
            subprocess.TimeoutExpired) as e:
        pytest.skip(f"aku offline build failed: {e}")
    return BUILD


def make_corpus(tmp_path, n_utts=3, model_seed=5):
    rng = np.random.default_rng(7)
    model = three_state_model(seed=model_seed, D=4)
    model_io.write_model(str(tmp_path / "am"), model)
    (tmp_path / "feats.cfg").write_text(CFG)
    ref_lines, our_lines = [], []
    for u in range(n_utts):
        n = 4000 + 200 * u
        sig = (2000 * np.sin(2 * np.pi * (300 + 120 * u)
                             * np.arange(n) / 16000)
               + 200 * rng.standard_normal(n)).astype("<i2")
        wav = tmp_path / f"u{u}.wav"
        with wave.open(str(wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(sig.tobytes())
        phn = tmp_path / f"u{u}.phn"
        phn.write_text("_\na\n_\n")
        base = f"audio={wav} transcript={phn}"
        ref_lines.append(base + f" alignment={tmp_path}/u{u}.ref.phn")
        our_lines.append(base + f" alignment={tmp_path}/u{u}.our.phn")
    (tmp_path / "recipe.ref").write_text("\n".join(ref_lines) + "\n")
    (tmp_path / "recipe.our").write_text("\n".join(our_lines) + "\n")
    return model


class TestGoldenTraining:
    def test_align_and_stats_parity(self, aku_bins, tmp_path):
        model = make_corpus(tmp_path)
        env = dict(os.environ)
        subprocess.run(
            [os.path.join(aku_bins, "align"), "-b", "am",
             "-c", "feats.cfg", "-r", "recipe.ref"],
            cwd=tmp_path, check=True, capture_output=True,
            timeout=300, env=env)

        from aaltoasr_tpu.cli.align import main as align_main
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            align_main(["-b", "am", "-c", "feats.cfg",
                        "-r", "recipe.our"])
        finally:
            os.chdir(cwd)

        # align parity: identical interior boundaries
        for u in range(3):
            ref = [l.split() for l in
                   open(tmp_path / f"u{u}.ref.phn") if l.strip()]
            ours = [l.split() for l in
                    open(tmp_path / f"u{u}.our.phn") if l.strip()]
            assert len(ref) == len(ours)
            for i, (r, o) in enumerate(zip(ref, ours)):
                assert r[2] == o[2], (u, i)           # label.state
                assert r[0] == o[0], (u, i)           # start
                if i < len(ref) - 1:
                    assert r[1] == o[1], (u, i)       # interior end
                else:                                  # eof convention
                    assert abs(int(r[1]) - int(o[1])) <= 128

        # stats parity on the REFERENCE alignments (same input path)
        subprocess.run(
            [os.path.join(aku_bins, "stats"), "-b", "am",
             "-c", "feats.cfg", "-r", "recipe.ref", "--ml", "-t",
             "-O", "-o", "refstats"],
            cwd=tmp_path, check=True, capture_output=True,
            timeout=300, env=env)
        from aaltoasr_tpu.cli.stats import main as stats_main
        os.chdir(tmp_path)
        try:
            stats_main(["-b", "am", "-c", "feats.cfg",
                        "-r", "recipe.ref", "--ml", "-t", "-O",
                        "-o", "ourstats"])
        finally:
            os.chdir(cwd)

        from aaltoasr_tpu.models.hmm import TransitionTable
        from aaltoasr_tpu.train.accumulators import HmmStats, ML_BUF
        table = TransitionTable.from_model(model)
        ref = HmmStats.zeros(model, table)
        ref.load(str(tmp_path / "refstats"), table)
        ours = HmmStats.zeros(model, table)
        ours.load(str(tmp_path / "ourstats"), table)
        rb, ob = ref.buffers[ML_BUF], ours.buffers[ML_BUF]
        # float-noise tolerances: the rebuilt reference's features
        # differ from ours at ~2e-4 absolute (compiler-era float
        # ordering); the accumulated statistics track to ~1e-6 rel
        for name, rtol in [("gamma", 1e-6), ("mean_acc", 1e-4),
                           ("sec_acc", 1e-4), ("aux_gamma", 1e-6),
                           ("mix_gamma", 1e-6), ("mix_ll", 1e-5)]:
            a, b = getattr(rb, name), getattr(ob, name)
            scale = max(float(np.max(np.abs(a))), 1e-9)
            assert float(np.max(np.abs(a - b))) <= rtol * scale, name
        assert np.array_equal(rb.feacount, ob.feacount)
        assert np.array_equal(ref.trans_acc, ours.trans_acc)
        assert ref.num_ll == pytest.approx(ours.num_ll, rel=1e-5)
        assert ref.num_frames == ours.num_frames
